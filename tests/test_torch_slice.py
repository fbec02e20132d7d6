"""The port's calling path end to end on the CPU: ``grom_tpu_torch``'s
driver with ``engine="torch", device="cpu"`` (the plain versions of every
kernel) must write VCF and ``.ctx.vcf`` files byte-identical to grom_tpu's
host engine, and rows equal to the committed reference-binary oracles.

Chunk edges are forced (GROM_TPU_CHUNK_BASES=60000,
GROM_TPU_DETECT_BASES=30000) so the streamed path crosses many ingest and
detect boundaries. Also here: the CLI, the engine seam, and that no run
imports jax or grom_tpu. The whole-batch path and ``-c`` are in
test_torch_whole_batch.py, ``-P`` in test_torch_parallel.py."""

import os
import subprocess
import sys

import pytest
import torch

from grom_tpu.config import GromConfig as HostConfig
from grom_tpu_torch.config import GromConfig
from test_full_parity import _rows, _rows_equal

DATA = os.path.join(os.path.dirname(__file__), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATE = "2026725"

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core would oversubscribe the host
torch.set_num_threads(1)


def _cfg(fixture, out, cls=GromConfig, **kw):
    """The port's config of a fixture run (``cls=HostConfig``: grom_tpu's,
    for a run of grom_tpu)."""
    d = os.path.join(DATA, fixture)
    return cls(bam=os.path.join(d, "ds.bam"),
               ref_fasta=os.path.join(d, "ds.fa"), out_vcf=out, **kw)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def grom_tpu_native(timeout: float = 300.0):
    """grom_tpu's native library, loaded in this process; raises if it
    does not load.

    Without it grom_tpu decodes reads without their name ids, and its
    device engines then refuse the data. ``grom_tpu.native`` builds the
    library with an in-place ``make`` that several test processes may run
    at once, and a process whose first load failed remembers the failure.
    So: build under a lock file in ``build/`` (grom_tpu's own tests in
    other processes take no lock, so keep trying to load for a while),
    and forget a failure cached earlier in this process."""
    import fcntl
    import time

    from grom_tpu import native
    if os.environ.get("GROM_TPU_NO_NATIVE") == "1":
        raise RuntimeError("GROM_TPU_NO_NATIVE=1: grom_tpu's native library "
                           "is switched off")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "grom_tpu_native.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        deadline = time.monotonic() + timeout
        while True:
            if native._lib is None and native._tried:
                native._tried = False
            native._build()
            lib = native.get_lib()
            if lib is not None:
                return lib
            if time.monotonic() > deadline:
                raise RuntimeError("grom_tpu's native library (native/, "
                                   "make) did not load in %.0f s" % timeout)
            time.sleep(0.5)


@pytest.fixture
def chunked(monkeypatch):
    monkeypatch.setenv("GROM_TPU_CHUNK_BASES", "60000")
    monkeypatch.setenv("GROM_TPU_DETECT_BASES", "30000")


@pytest.mark.parametrize("fixture,kw", [
    ("ds200k", {}),
    ("cnvrich", {"rd_pval_threshold": 1e-4}),
])
def test_torch_engine_matches_host(tmp_path, chunked, fixture, kw):
    from grom_tpu.driver import run as run_host
    from grom_tpu_torch.driver import run
    host = str(tmp_path / "host.vcf")
    port = str(tmp_path / "torch.vcf")
    run_host(_cfg(fixture, host, HostConfig, **kw), file_date=DATE,
             engine="host")
    res = run(_cfg(fixture, port, **kw), file_date=DATE, engine="torch",
              device="cpu")
    assert res.ctx_path == str(tmp_path / "torch.ctx.vcf")
    assert _read(port) == _read(host)
    assert _read(res.ctx_path) == _read(str(tmp_path / "host.ctx.vcf"))
    got = _rows(port)
    want = _rows(os.path.join(DATA, fixture, "oracle.vcf"))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert _rows_equal(a, b), (a, b)
    n_snv = sum(1 for r in got if r.split("\t")[4] in "ACGT")
    assert n_snv > 0
    if fixture == "cnvrich":
        assert sum(1 for r in got if "<DEL>" in r or "<DUP>" in r) >= 5


@pytest.mark.parametrize("kw,extra", [
    ({"vcf_output": False}, None),                        # -f tabular
    ({"gen1000_window": 1000}, "oracle.1000gen.chrsim"),   # -N track
])
def test_torch_engine_output_modes(tmp_path, kw, extra):
    """-f and -N on the torch engine: the same files as the host engine,
    and the -N track equal to the reference binary's."""
    from grom_tpu.driver import run as run_host
    from grom_tpu_torch.driver import run
    host = str(tmp_path / "host.out")
    port = str(tmp_path / "torch.out")
    run_host(_cfg("ds200k", host, HostConfig, **kw), file_date=DATE,
             engine="host")
    run(_cfg("ds200k", port, **kw), file_date=DATE, engine="torch",
        device="cpu")
    names = sorted(os.listdir(tmp_path))
    assert len(names) >= 4
    for name in names:
        if name.startswith("torch."):
            assert _read(str(tmp_path / name)) == _read(
                str(tmp_path / name.replace("torch.", "host.", 1))), name
    if extra:
        assert _read(port + ".1000gen.chrsim") == _read(
            os.path.join(DATA, "ds200k", extra))


@pytest.mark.parametrize("engine", ["torch", "mesh"])
def test_torch_engine_on_cuda_without_gpu_raises(tmp_path, monkeypatch,
                                                 engine):
    from grom_tpu_torch.driver import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run(_cfg("ds200k", str(tmp_path / "o.vcf")), engine=engine,
            device="cuda")
    assert not os.path.exists(tmp_path / "o.vcf")


def test_mesh_accumulator_without_gpu_raises(monkeypatch):
    """The mesh engine's own grid over the visible CUDA devices: none
    visible raises (no CPU fallback)."""
    from grom_tpu_torch.parallel.pipeline import MeshAccumulator
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshAccumulator()


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No nvcc on PATH or under $CUDA_HOME: building a kernel raises (no
    fallback to the plain versions)."""
    from grom_tpu_torch import _build
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    for name in _build.LIBRARIES:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build(name)


def test_resolve_engine(monkeypatch, capsys):
    from grom_tpu_torch.driver import resolve_engine
    monkeypatch.setenv("GROM_TPU_TORCH_ENGINE", "host")
    assert resolve_engine() == "host"
    monkeypatch.setenv("GROM_TPU_TORCH_ENGINE", "torch")
    assert resolve_engine() == "torch"
    monkeypatch.setenv("GROM_TPU_TORCH_ENGINE", "mesh")
    assert resolve_engine() == "mesh"
    monkeypatch.setenv("GROM_TPU_TORCH_ENGINE", "tpu")
    with pytest.raises(ValueError):
        resolve_engine()
    monkeypatch.setenv("GROM_TPU_TORCH_ENGINE", "auto")
    # auto: mesh with more than one card, torch with one (none: see
    # test_torch_standalone.py)
    for count, want in ((1, "torch"), (2, "mesh"), (8, "mesh")):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        assert resolve_engine() == want
        assert "engine auto -> %s" % want in capsys.readouterr().err


def _cli(args, env_extra, timeout=600):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    env["OMP_NUM_THREADS"] = "1"
    env.update(env_extra)
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def _foreign(mods):
    """The modules of jax and of grom_tpu among ``mods``."""
    return [m for m in mods if m.split(".")[0] in ("jax", "grom_tpu")]


def test_cli_never_imports_jax(tmp_path):
    """``python -m grom_tpu_torch`` on ds200k on the host engine matches
    the oracle, and the import log shows no module of jax or grom_tpu,
    nor torch: the host engine puts no stage on a device."""
    d = os.path.join(DATA, "ds200k")
    out = str(tmp_path / "o.vcf")
    r = _cli(["-X", "importtime", "-m", "grom_tpu_torch",
              "-i", os.path.join(d, "ds.bam"), "-r", os.path.join(d, "ds.fa"),
              "-o", out], {"GROM_TPU_TORCH_ENGINE": "host"})
    assert r.returncode == 0, r.stderr[-3000:]
    mods = [ln.rsplit("|", 1)[-1].strip() for ln in r.stderr.splitlines()
            if ln.startswith("import time:")]
    assert "grom_tpu_torch.driver" in mods and "torch" not in mods
    assert "grom_tpu_torch.native" in mods
    assert not _foreign(mods)
    assert _rows(out) == _rows(os.path.join(d, "oracle.vcf"))


@pytest.mark.parametrize("engine", ["torch", "mesh"])
def test_torch_engine_never_imports_jax(tmp_path, engine):
    """A full in-process run of a device engine (plain kernels, the SV
    scorer on) leaves every module of jax and of grom_tpu out of
    sys.modules."""
    d = os.path.join(DATA, "ds200k")
    out = str(tmp_path / "o.vcf")
    code = (
        "import sys\n"
        "from grom_tpu_torch.config import GromConfig\n"
        "from grom_tpu_torch.driver import run\n"
        "from grom_tpu_torch.ops import sv_device\n"
        "run(GromConfig(bam=%r, ref_fasta=%r, out_vcf=%r), engine=%r,"
        " device='cpu')\n"
        "assert sv_device._CACHE, 'the SV scorer was not used'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'grom_tpu')]\n"
        "assert not bad, bad\n"
        % (os.path.join(d, "ds.bam"), os.path.join(d, "ds.fa"), out, engine))
    r = _cli(["-c", code], {"GROM_TPU_DEVICE_SV": ""})
    assert r.returncode == 0, r.stderr[-3000:]
    assert _rows(out) == _rows(os.path.join(d, "oracle.vcf"))
