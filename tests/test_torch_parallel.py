"""``-P`` on the port: grom_tpu_torch's chromosome workers against the
port's serial run and grom_tpu's ``-P``.

Every comparison is of rows or bytes, the ``##fileDate`` and
``##reference`` lines excepted (the run date; the FASTA path). On this CPU
host the workers run the host engine, or, in process, the torch and mesh
engines on ``devices=["cpu"]`` (the plain versions of the kernels). The
``cuda`` tests run the workers on the card and skip without one.

The sub-region jobs (``-R 1``) run on a generated 2.6 Mb chromosome at 10x
with ``-X 500``: outside its region a job's depth is zero, every such
position seeds a CNV window, and the CNV scan then steps each one up to
the longest window (``-X``, default 10,000). With the default a job took
40-95 s on the host engine here, grom_tpu's and the port's alike; with
500, a few seconds.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from test_torch_slice import DATA, REPO, _cli, _foreign, grom_tpu_native

torch.set_num_threads(1)

SPLIT = dict(length=2_600_000, coverage=10.0, seed=11)
SPLIT_FLAGS = ["-R", "1", "-X", "500"]


def _fixture_args(fx):
    d = os.path.join(DATA, fx)
    return ["-i", os.path.join(d, "ds.bam"), "-r", os.path.join(d, "ds.fa")]


def _body(path):
    """A file's bytes without its ``##fileDate`` and ``##reference``
    lines."""
    with open(path, "rb") as f:
        return b"".join(ln for ln in f
                        if not ln.startswith((b"##fileDate", b"##reference")))


def _outputs(d, stem):
    """name (with ``stem`` cut off) -> body, of every file a run wrote
    into ``d`` under ``stem``."""
    return {n[len(stem):]: _body(os.path.join(d, n))
            for n in sorted(os.listdir(d)) if n.startswith(stem)}


def _port(args, out, engine="host", extra_env=None):
    """``python -m grom_tpu_torch`` with ``args`` on ``engine``."""
    env = {"GROM_TPU_TORCH_ENGINE": engine}
    env.update(extra_env or {})
    r = _cli(["-m", "grom_tpu_torch", *args, "-o", out], env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r


def _grom_tpu(args, out):
    """``python -m grom_tpu`` with ``args`` on its host engine."""
    grom_tpu_native()
    r = _cli(["-m", "grom_tpu", *args, "-o", out],
             {"GROM_TPU_ENGINE": "host"})
    assert r.returncode == 0, r.stderr[-3000:]


def _in_process(args, out, engine, devices, monkeypatch):
    """``run_parallel`` in this process, on ``engine`` over ``devices``;
    returns the jobs' reports."""
    from grom_tpu_torch.cli import parse_args, run_parallel
    monkeypatch.setenv("OMP_NUM_THREADS", "1")     # for the spawned workers
    cfg = parse_args(list(args) + ["-o", out])
    return run_parallel(cfg, engine=engine, devices=devices)


# --------------------------------------------------------------------------
# (a) split_regions, (g) dealing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mb", [0, 1, 2, 5])
@pytest.mark.parametrize("length", [1, 999_999, 1_000_000, 1_250_000,
                                    1_250_001, 2_600_000, 3_600_000,
                                    24_000_000])
def test_split_regions_matches_grom_tpu(length, mb):
    from grom_tpu.cli import split_regions as ref_split
    from grom_tpu.config import GromConfig as HostConfig
    from grom_tpu_torch.cli import split_regions
    from grom_tpu_torch.config import GromConfig
    cfg = GromConfig(bam="x", ref_fasta="x", out_vcf="x", sub_region_mb=mb)
    ref = HostConfig(bam="x", ref_fasta="x", out_vcf="x", sub_region_mb=mb)
    got = split_regions(length, cfg)
    assert got == ref_split(length, ref)
    assert got[0][1] == 0 and got[-1][2] == length


@pytest.mark.parametrize("n_cards", [1, 2, 3, 4])
@pytest.mark.parametrize("n_workers", range(1, 9))
def test_deal_over_cards(n_workers, n_cards):
    from grom_tpu_torch.cli import CONTEXT_SHARE, deal
    cards = ["cuda:%d" % i for i in range(n_cards)]
    dealt = deal(n_workers, cards)
    assert [d for d, _ in dealt] == [cards[k % n_cards]
                                     for k in range(n_workers)]
    count = {c: sum(d == c for d, _ in dealt) for c in cards}
    used = [c for c in cards if count[c]]
    assert used == cards[:min(n_workers, n_cards)]
    assert max(count.values()) - min(count[c] for c in used) <= 1
    for c in used:
        shares = [s for d, s in dealt if d == c]
        assert all(0 < s for s in shares)
        assert sum(shares) <= 1 - count[c] * CONTEXT_SHARE + 1e-12
        assert sum(shares) < 1


def test_deal_on_the_cpu():
    from grom_tpu_torch.cli import deal
    assert deal(3, ["cpu"]) == [("cpu", None)] * 3


# --------------------------------------------------------------------------
# (b), (c) the CLI on the host engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fx,flags", [
    ("dup60k", ["-M"]),
    ("ctx2x60k", ["-f"]),                  # tabular, two contigs
    ("ds200k", ["-N", "1000"]),            # the 1000 Genomes track
])
def test_cli_parallel_matches_serial_and_grom_tpu(tmp_path, fx, flags):
    """``-P 2`` on the host engine writes the same files as the port's
    serial run and ``python -m grom_tpu -P 2``."""
    args = _fixture_args(fx) + flags
    runs = {}
    for name in ("par", "serial", "ref"):
        d = tmp_path / name
        d.mkdir()
        out = str(d / "o.vcf")
        if name == "ref":
            _grom_tpu(args + ["-P", "2"], out)
        else:
            _port(args + (["-P", "2"] if name == "par" else []), out)
        runs[name] = _outputs(str(d), "o.")
    assert len(runs["par"]) >= 2
    assert runs["par"] == runs["serial"] == runs["ref"]
    assert not [n for n in runs["par"] if ".part." in n]
    if fx == "dup60k":
        from test_full_parity import _rows
        assert _rows(str(tmp_path / "par" / "o.vcf")) == _rows(
            os.path.join(DATA, fx, "oracle.vcf"))


@pytest.fixture(scope="module")
def ctx2_host(tmp_path_factory):
    """``-P 2`` on ctx2x60k (two contigs: two jobs, a ctx merge across the
    workers) on the port's host engine: the output's path. With
    GROM_TPU_EARLY=1, which every worker inherits with the parent's argv
    (as in grom_tpu): each process may inflate the BAM early, and the
    output must not change."""
    out = str(tmp_path_factory.mktemp("ctx2_host") / "o.vcf")
    _port(_fixture_args("ctx2x60k") + ["-P", "2"], out,
          extra_env={"GROM_TPU_EARLY": "1"})
    return out


def test_cli_parallel_ctx_merge(ctx2_host, tmp_path):
    from test_full_parity import _rows
    ref = str(tmp_path / "ref.vcf")
    _grom_tpu(_fixture_args("ctx2x60k") + ["-P", "2"], ref)
    ctx = ctx2_host[:-4] + ".ctx.vcf"
    rows = _rows(ctx)
    assert len(rows) >= 2
    assert rows == _rows(os.path.join(DATA, "ctx2x60k", "oracle.ctx.vcf"))
    assert _body(ctx) == _body(ref[:-4] + ".ctx.vcf")
    assert _body(ctx2_host) == _body(ref)


# --------------------------------------------------------------------------
# (d) the device engines' workers on the CPU
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["torch", "mesh"])
def test_run_parallel_device_engine_on_cpu(ctx2_host, tmp_path, monkeypatch,
                                           engine):
    """In-process ``run_parallel`` on ``devices=["cpu"]``: the spawned
    workers run the engine's plain kernels, report device ``cpu``, and
    their launch counts (none: only CUDA launches count) add into the
    parent's; the files equal the host engine's."""
    from grom_tpu_torch import _build
    _build.reset_launches()
    before = dict(_build.LAUNCHES)
    out = str(tmp_path / "o.vcf")
    reps = _in_process(_fixture_args("ctx2x60k") + ["-P", "2"], out, engine,
                       ["cpu"], monkeypatch)
    assert len(reps) == 2
    for rep in reps:
        assert rep["engine"] == engine and rep["device"] == "cpu"
        assert rep["max_memory_allocated"] is None
        assert rep["pid"] != os.getpid() and rep["max_rss_kib"] > 0
    assert _build.LAUNCHES == {
        k: before[k] + sum(r["launches"][k] for r in reps)
        for k in _build.KERNELS}
    for suffix in (".vcf", ".ctx.vcf"):
        assert _body(out[:-4] + suffix) == _body(ctx2_host[:-4] + suffix)
    assert sorted(os.listdir(tmp_path)) == ["o.ctx.vcf", "o.vcf"]


# --------------------------------------------------------------------------
# (e) sub-region jobs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def split_run(tmp_path_factory):
    """A generated 2.6 Mb chromosome at 10x, and ``-P 2 -R 1`` on it on the
    port's host engine: (argv without -o, the output's path)."""
    from grom_tpu_torch.testing.bulk_sim import bulk_dataset
    d = tmp_path_factory.mktemp("split")
    fa, bam = bulk_dataset(str(d / "c"), **SPLIT)
    args = ["-i", bam, "-r", fa] + SPLIT_FLAGS + ["-P", "2"]
    out = str(d / "host.vcf")
    _port(args, out)
    return args, out


@pytest.mark.parametrize("other", ["grom_tpu", "torch"])
def test_subregion_jobs(split_run, tmp_path, monkeypatch, other):
    """``-P 2 -R 1``: three region jobs on the whole-batch path. The port's
    host engine equals grom_tpu's ``-P 2 -R 1``, and the port's torch
    engine on the CPU equals the port's host engine."""
    from test_full_parity import _rows
    args, host = split_run
    out = str(tmp_path / "o.vcf")
    if other == "grom_tpu":
        _grom_tpu(args, out)
    else:
        reps = _in_process(args, out, "torch", ["cpu"], monkeypatch)
        assert len(reps) == 3
        assert {r["engine"] for r in reps} == {"torch"}
    assert len(_rows(host)) > 1000
    for suffix in (".vcf", ".ctx.vcf"):
        assert _body(out[:-4] + suffix) == _body(host[:-4] + suffix)


# --------------------------------------------------------------------------
# (f) no card, (h) no jax
# --------------------------------------------------------------------------

def test_cli_parallel_without_card(tmp_path):
    """``-P 2`` on the default engine (auto) with no card exits non-zero,
    names the host engine, and writes nothing."""
    env = {k: v for k, v in os.environ.items()
           if k != "GROM_TPU_TORCH_ENGINE"}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "grom_tpu_torch",
                        *_fixture_args("ctx2x60k"), "-o",
                        str(tmp_path / "o.vcf"), "-P", "2"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "CUDA device" in r.stderr
    assert "GROM_TPU_TORCH_ENGINE=host" in r.stderr
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("engine", ["auto", "torch", "mesh"])
def test_parallel_without_card_spawns_nothing(tmp_path, monkeypatch, engine):
    """Without a card, ``auto`` and the device engines raise in the parent
    before a pool exists or a file is written."""
    from grom_tpu_torch import cli
    pools = []
    monkeypatch.setattr(cli, "ProcessPoolExecutor",
                        lambda *a, **k: pools.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setenv("GROM_TPU_TORCH_ENGINE", engine)
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(_fixture_args("ctx2x60k")
                 + ["-o", str(tmp_path / "o.vcf"), "-P", "2"])
    assert not pools
    assert not os.listdir(tmp_path)


def test_worker_failure_fails_the_run(tmp_path, monkeypatch):
    """A job that raises in its worker (here: the torch engine refuses
    reads decoded without read-name ids, GROM_TPU_NO_NATIVE=1 in the
    workers) fails the run in the parent: no fallback, no hang, no
    output."""
    monkeypatch.setenv("GROM_TPU_NO_NATIVE", "1")
    out = str(tmp_path / "o.vcf")
    with pytest.raises(ValueError, match="read-name ids"):
        _in_process(_fixture_args("ctx2x60k") + ["-P", "2"], out, "torch",
                    ["cpu"], monkeypatch)
    assert not os.path.exists(out)


def test_cli_parallel_never_imports_jax(tmp_path):
    """``-P 2`` under ``python -X importtime`` (which spawn passes on to
    the workers): the parent and both workers import the port's CLI, and
    no process loads a module of jax or grom_tpu, nor torch (the host
    engine)."""
    out = str(tmp_path / "o.vcf")
    r = _cli(["-X", "importtime", "-m", "grom_tpu_torch",
              *_fixture_args("ctx2x60k"), "-o", out, "-P", "2"],
             {"GROM_TPU_TORCH_ENGINE": "host"})
    assert r.returncode == 0, r.stderr[-3000:]
    mods = [ln.rsplit("|", 1)[-1].strip() for ln in r.stderr.splitlines()
            if ln.startswith("import time:")]
    assert mods.count("grom_tpu_torch.cli") == 3
    assert "grom_tpu_torch.driver" in mods and "torch" not in mods
    assert not _foreign(mods)
    from test_full_parity import _rows
    assert _rows(out[:-4] + ".ctx.vcf") == _rows(
        os.path.join(DATA, "ctx2x60k", "oracle.ctx.vcf"))


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

TORCH_PATH = ("tile_accumulate", "zscores", "seed_eval", "null_model",
              "sv_score")


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["torch", "mesh"])
@pytest.mark.parametrize("fx", ["ds200k", "ctx2x60k"])
def test_parallel_on_card_matches_host(tmp_path, monkeypatch, fx, engine):
    """``-P 2`` with the workers on the card equals the host engine's
    ``-P 2``; every kernel of the engine's path was launched from the
    workers, on cards, and the parent's counts hold their sum."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grom_tpu_torch import _build
    args = _fixture_args(fx) + ["-P", "2"]
    host = str(tmp_path / "host.vcf")
    _in_process(args, host, "host", None, monkeypatch)
    _build.reset_launches()
    out = str(tmp_path / "card.vcf")
    reps = _in_process(args, out, engine, None, monkeypatch)
    for suffix in (".vcf", ".ctx.vcf"):
        assert _body(out[:-4] + suffix) == _body(host[:-4] + suffix)
    for rep in reps:
        assert rep["device"].startswith("cuda:") and rep["engine"] == engine
        assert rep["max_memory_allocated"] > 0
    want = TORCH_PATH + (("rd_scatter", "rd_scan") if engine == "mesh"
                         else ())
    for k in want:
        assert _build.LAUNCHES[k] > 0, (k, json.dumps(reps))
        assert _build.LAUNCHES[k] == sum(r["launches"][k] for r in reps)


@pytest.mark.cuda
def test_parallel_deals_over_cards(tmp_path, monkeypatch):
    """``-P 4`` on two contigs over two or more cards: the two workers that
    take the jobs are workers 0 and 1, on cuda:0 and cuda:1."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    out = str(tmp_path / "o.vcf")
    reps = _in_process(_fixture_args("ctx2x60k") + ["-P", "4"], out, "torch",
                       None, monkeypatch)
    by_pid = {}
    for rep in reps:
        by_pid.setdefault(rep["pid"], set()).add(rep["device"])
    assert all(len(d) == 1 for d in by_pid.values())
    devices = [d.pop() for d in by_pid.values()]
    assert len(set(devices)) == len(devices)
    assert set(devices) <= {"cuda:0", "cuda:1"}
    assert len(devices) == 2, by_pid


@pytest.mark.cuda
def test_parallel_parent_creates_no_cuda_context(tmp_path):
    """A ``-P 2`` CLI run on the torch engine leaves the parent without a
    CUDA context: the workers hold the cards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = str(tmp_path / "o.vcf")
    code = ("import sys, torch\n"
            "from grom_tpu_torch.cli import main\n"
            "if __name__ == '__main__':\n"
            "    rc = main(sys.argv[1:])\n"
            "    print('context', torch.cuda.is_initialized())\n"
            "    sys.exit(rc)\n")
    script = tmp_path / "run.py"
    script.write_text(code)
    r = _cli([str(script), *_fixture_args("ctx2x60k"), "-o", out, "-P", "2"],
             {"GROM_TPU_TORCH_ENGINE": "torch"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "context False" in r.stdout
