"""grom_tpu's per-stage device policy on the port, on every engine,
serially and under ``-P``:

* GROM_TPU_DEVICE_CNV=1 puts the CNV stage (the ``zscores``,
  ``null_model`` and ``seed_eval`` kernels) on the run's device on any
  engine, the host engine included; =0 keeps it on the native C / numpy
  stage on any engine, the device engines included;
* GROM_TPU_DEVICE_SV=1 puts the SV scorer (``sv_score``) on the run's
  device on any engine; =0 keeps it on the host screen;
* any other value, empty included, keeps the default: both stages on the
  device engines' device, on the host for the host engine.

Each run is held byte for byte against the host engine's files (or, for
the CNV stage alone, against grom_tpu's runs of the same inputs). On the
CPU the kernel wrappers run their plain versions; the ``cuda`` cases run
the kernels on the card and skip without one. A knob that puts a stage on
``cuda`` without a card raises; nothing falls back to the CPU or to the
host stage."""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

from test_torch_parallel import _body, _fixture_args, _in_process
from test_torch_slice import DATA

torch.set_num_threads(1)

DATE = "2026725"
CNV_KERNELS = ("zscores", "seed_eval", "null_model")
KNOBS = ("GROM_TPU_DEVICE_CNV", "GROM_TPU_DEVICE_SV")
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _need(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _knobs(mp, **values):
    """Set the two knobs (unset where not given) on the MonkeyPatch
    ``mp``."""
    for k in KNOBS:
        mp.delenv(k, raising=False)
    for k, v in values.items():
        mp.setenv(k, v)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(fasta, bam) of cnvrich and of cnvmany (generated)."""
    from grom_tpu_torch.testing import cnvmany
    d = os.path.join(DATA, "cnvrich")
    many = cnvmany.build(str(tmp_path_factory.mktemp("cnvmany") / "ds"))
    return {"cnvrich": (os.path.join(d, "ds.fa"), os.path.join(d, "ds.bam")),
            "cnvmany": many}


def _run(fixture, datasets, out, engine, device):
    """The port's driver on a CNV fixture (-V 0.0001, as the fixtures'
    oracles), under the knobs as they stand."""
    from grom_tpu_torch.config import GromConfig
    from grom_tpu_torch.driver import run
    fa, bam = datasets[fixture]
    run(GromConfig(bam=bam, ref_fasta=fa, out_vcf=out,
                   rd_pval_threshold=1e-4),
        file_date=DATE, engine=engine, device=device)


@pytest.fixture(scope="module")
def host_files(datasets, tmp_path_factory):
    """The host engine's VCF of each CNV fixture, with neither knob set."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _knobs(mp)
        for fx in datasets:
            out[fx] = str(tmp_path_factory.mktemp("host") / "host.vcf")
            _run(fx, datasets, out[fx], "host", "cpu")
    return out


@pytest.fixture
def calls(monkeypatch):
    """Calls of the CNV kernel wrappers in this process, by kernel, on any
    device (the launch counts see only the card)."""
    from grom_tpu_torch.ops import cnv_device
    n = dict.fromkeys(CNV_KERNELS, 0)
    for k in CNV_KERNELS:
        def spy(*a, _f=getattr(cnv_device, k), _k=k, **kw):
            n[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(cnv_device, k, spy)
    return n


def _same_files(out, ref):
    for suffix in (".vcf", ".ctx.vcf"):
        assert _read(out[:-4] + suffix) == _read(ref[:-4] + suffix), suffix


def _records(path):
    """A VCF's lines without its ``##`` header lines."""
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"##"))


def _n_cnv(vcf):
    with open(vcf) as f:
        return sum(1 for ln in f if "\tSD:Z:CN:CS\t" in ln)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("engine", ["torch", "mesh"])
@pytest.mark.parametrize("fixture", ["cnvrich", "cnvmany"])
def test_device_engine_with_host_cnv_stage(datasets, host_files, calls,
                                           tmp_path, monkeypatch, fixture,
                                           engine, device):
    """GROM_TPU_DEVICE_CNV=0 on a device engine: the native C stage on the
    depth lists the engine built (which it releases before the stage
    reads them), no CNV kernel called; the files equal the host
    engine's."""
    _need(device)
    from grom_tpu_torch import _build
    _knobs(monkeypatch, GROM_TPU_DEVICE_CNV="0")
    _build.reset_launches()
    out = str(tmp_path / "o.vcf")
    _run(fixture, datasets, out, engine, device)
    assert calls == dict.fromkeys(CNV_KERNELS, 0)
    assert all(_build.LAUNCHES[k] == 0 for k in CNV_KERNELS)
    if device == "cuda":
        assert _build.LAUNCHES["tile_accumulate"] > 0
        assert _build.LAUNCHES["sv_score"] > 0
    _same_files(out, host_files[fixture])
    assert _n_cnv(out) >= 5


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("fixture", ["cnvrich", "cnvmany"])
def test_host_engine_with_device_cnv_stage(datasets, host_files, calls,
                                           tmp_path, monkeypatch, fixture,
                                           device):
    """GROM_TPU_DEVICE_CNV=1 on the host engine: the three CNV kernels on
    ``device``, the scan and the SV screen on the host; the files equal
    the host engine's without the knob."""
    _need(device)
    from grom_tpu_torch import _build
    _knobs(monkeypatch, GROM_TPU_DEVICE_CNV="1")
    _build.reset_launches()
    out = str(tmp_path / "o.vcf")
    _run(fixture, datasets, out, "host", device)
    assert all(calls[k] > 0 for k in CNV_KERNELS), calls
    if device == "cuda":
        assert all(_build.LAUNCHES[k] > 0 for k in CNV_KERNELS)
    for k in ("tile_accumulate", "rd_scatter", "rd_scan", "sv_score"):
        assert _build.LAUNCHES[k] == 0, k
    _same_files(out, host_files[fixture])


@pytest.mark.parametrize("device", DEVICES)
def test_detect_del_dup_device_cnv_matches_grom_tpu(monkeypatch, device):
    """The counterpart of grom_tpu's tests/test_cnv_device.py
    ``test_device_cnv_env_flag``: ``detect_del_dup`` with
    GROM_TPU_DEVICE_CNV=1 on the host engine, on ds200k, against grom_tpu's
    own run with the knob under jax x64 (equal boundaries and copy
    numbers; SD within grom_tpu's 1e-9 relative, the drift of its null
    model's XLA prefix sums) and against grom_tpu's host stage (every
    field bitwise: the port's null model holds the host's bits). The card
    host has no jax: there the port is held to grom_tpu's host stage."""
    _need(device)
    from grom_tpu_torch.call import cnv as tcnv
    from test_native_cnv import _calls as ref_calls
    from test_native_cnv import _cnv_inputs as ref_inputs
    from test_torch_cnv_kernels import _cnv_inputs, _x64

    chrom, arr, cfg, drv = ref_inputs("ds200k")
    _knobs(monkeypatch)
    want = ref_calls(chrom, arr, cfg, drv, native=False)
    monkeypatch.setenv("GROM_TPU_DEVICE_CNV", "1")
    ref_dev = want
    if device == "cpu":
        with _x64():
            ref_dev = ref_calls(chrom, arr, cfg, drv, native=True)

    chrom, arr, cfg, drv = _cnv_inputs("ds200k")
    feats = tcnv.preprocess_reference(chrom, drv.insert_mean, cfg.min_repeat)
    prep = tcnv.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo, arr.rd_mq, cfg,
                         drv)
    got = tcnv.detect_del_dup(chrom, feats, prep, arr.rd_hi, arr.rd_lo, cfg,
                              drv, cfg.ploidy, engine="host", device=device)
    assert sum(len(x) for x in got) >= 1
    bits = lambda c: tuple(np.float64(v).tobytes() if isinstance(v, float)
                           else v for v in dataclasses.astuple(c))
    for g, w, d in zip(got, want, ref_dev):
        assert [bits(c) for c in g] == [bits(c) for c in w]
        assert [(c.start, c.end, c.cn) for c in g] == \
            [(c.start, c.end, c.cn) for c in d]
        for c, e in zip(g, d):
            assert np.isclose(c.stdev, e.stdev, rtol=1e-9, atol=0), \
                (c.start, c.stdev, e.stdev)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("fixture,extra", [("ds200k", []),
                                           ("dup60k", ["-M"])])
def test_host_engine_device_sv_scorer_cli(tmp_path, monkeypatch, fixture,
                                          extra, device):
    """GROM_TPU_DEVICE_SV=1 on the host engine through the port's CLI
    (``cli.main``, on ``device``): the SV entries are scored by
    ``sv_score``, and the output equals the reference binary's oracle and
    the host engine's run without the knob, as grom_tpu's
    tests/test_sv_device.py holds grom_tpu's."""
    _need(device)
    from grom_tpu_torch import _build, cli, driver
    from grom_tpu_torch.ops import sv_device
    scored = []
    sv_score = sv_device.sv_score
    monkeypatch.setattr(sv_device, "sv_score",
                        lambda *a, **k: scored.append(1) or sv_score(*a, **k))
    monkeypatch.setattr(driver, "run", functools.partial(driver.run,
                                                         device=device))
    monkeypatch.setenv("GROM_TPU_TORCH_ENGINE", "host")
    args = _fixture_args(fixture) + extra
    host, out = str(tmp_path / "host.vcf"), str(tmp_path / "sv.vcf")
    _knobs(monkeypatch)
    assert cli.main(args + ["-o", host]) == 0
    assert not scored
    _knobs(monkeypatch, GROM_TPU_DEVICE_SV="1")
    _build.reset_launches()
    assert cli.main(args + ["-o", out]) == 0
    assert scored
    if device == "cuda":
        assert _build.LAUNCHES["sv_score"] == len(scored)
    oracle = os.path.join(DATA, fixture, "oracle.vcf")
    assert _records(out) == _records(oracle)
    for suffix in (".vcf", ".ctx.vcf"):
        assert _body(out[:-4] + suffix) == _body(host[:-4] + suffix)


@pytest.fixture(scope="module")
def cnv_stage():
    """detect_del_dup's inputs on cnvrich (the port's host engine)."""
    from grom_tpu_torch.call import cnv as tcnv
    from test_torch_cnv_kernels import _cnv_inputs
    chrom, arr, cfg, drv = _cnv_inputs("cnvrich")
    feats = tcnv.preprocess_reference(chrom, drv.insert_mean, cfg.min_repeat)
    depth = np.add(arr.rd_hi, arr.rd_lo, dtype=np.int32)
    prep = tcnv.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo, arr.rd_mq, cfg,
                         drv, depth=depth)
    return chrom, feats, prep, depth, cfg, drv


class _Branch(Exception):
    pass


def _cnv_branch(cnv_stage, engine, monkeypatch):
    """Which CNV stage ``detect_del_dup`` takes on ``engine``: "device"
    (the kernels' inputs are built) or "host" (the native stage is
    asked for), stopped there."""
    from grom_tpu_torch.call import cnv as tcnv
    from grom_tpu_torch.ops import state

    def stop(where):
        def f(*a, **k):
            raise _Branch(where)
        return f
    monkeypatch.setattr(state, "cnv_tables", stop("device"))
    monkeypatch.setattr(tcnv, "_native_cnv_ctx", stop("host"))
    chrom, feats, prep, depth, cfg, drv = cnv_stage
    with pytest.raises(_Branch) as hit:
        tcnv.detect_del_dup(chrom, feats, prep, None, None, cfg, drv,
                            cfg.ploidy, depth=depth, engine=engine,
                            device="cpu")
    return str(hit.value)


@pytest.mark.parametrize("value", ["", "2", "0", "1"])
@pytest.mark.parametrize("engine", ["host", "torch", "mesh"])
def test_knob_values_on_each_engine(cnv_stage, monkeypatch, engine, value):
    """grom_tpu's rules, value by value: "1" puts the stage on the device
    and "0" on the host on every engine; empty and unknown values keep the
    default, the device on the device engines and the host on the host
    engine. ``device_stages`` says whether the run needs its device."""
    from grom_tpu_torch.driver import device_stages
    from grom_tpu_torch.ops import sv_device
    from test_torch_sv_scorer import _cfg_drv, _tables
    _knobs(monkeypatch, GROM_TPU_DEVICE_CNV=value, GROM_TPU_DEVICE_SV=value)
    default = engine != "host"
    on = {"1": True, "0": False}.get(value, default)
    assert _cnv_branch(cnv_stage, engine, monkeypatch) == (
        "device" if on else "host")
    cfg, drv = _cfg_drv()
    mq, hez = _tables(cfg.max_trials, 1)
    sc = sv_device.maybe_scorer(engine, mq, hez, cfg, drv, "cpu")
    assert (sc is not None) == on
    if sc is not None:
        assert sc.device == torch.device("cpu")
    assert device_stages(engine) == (default or value == "1")
    for knob in KNOBS:
        # one knob on the device is enough for the host engine
        _knobs(monkeypatch, **{knob: "1"})
        assert device_stages(engine)


@pytest.mark.parametrize("mode", [[], ["-P", "2"]])
@pytest.mark.parametrize("knob", KNOBS)
def test_host_engine_knob_without_card_raises(tmp_path, monkeypatch, knob,
                                              mode):
    """The host engine with a knob at "1" on ``cuda`` (the CLI's device)
    and no card raises before anything is written, serially and under
    ``-P 2``, where no pool is made; without a knob it needs no card."""
    from grom_tpu_torch import cli
    from grom_tpu_torch.driver import check_device
    pools = []
    monkeypatch.setattr(cli, "ProcessPoolExecutor",
                        lambda *a, **k: pools.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setenv("GROM_TPU_TORCH_ENGINE", "host")
    _knobs(monkeypatch)
    check_device("host", "cuda")
    _knobs(monkeypatch, **{knob: "1"})
    with pytest.raises(RuntimeError, match="CUDA device"):
        cli.main(_fixture_args("ctx2x60k") + ["-o", str(tmp_path / "o.vcf")]
                 + mode)
    assert not pools
    assert not os.listdir(tmp_path)


class _Spawned(Exception):
    pass


@pytest.mark.parametrize("knob", [None, *KNOBS])
def test_parallel_host_engine_devices(tmp_path, monkeypatch, knob):
    """``run_parallel`` on the host engine: with a knob at "1" its workers
    are dealt over every visible card and the parent builds the kernels
    first; with neither knob they run on the CPU and nothing is built.
    (Two cards are faked; the pool is stopped as it is made.)"""
    from grom_tpu_torch import _build, cli
    from grom_tpu_torch.cli import parse_args, run_parallel
    seen = {}

    def pool(n, mp_context, initializer, initargs):
        seen["devices"] = initargs[2]
        raise _Spawned
    monkeypatch.setattr(cli, "ProcessPoolExecutor", pool)
    monkeypatch.setattr(_build, "build_all",
                        lambda: seen.setdefault("built", True))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    _knobs(monkeypatch, **({knob: "1"} if knob else {}))
    cfg = parse_args(_fixture_args("ctx2x60k")
                     + ["-o", str(tmp_path / "o.vcf"), "-P", "2"])
    with pytest.raises(_Spawned):
        run_parallel(cfg, engine="host")
    if knob:
        assert seen == {"devices": ["cuda:0", "cuda:1"], "built": True}
    else:
        assert seen == {"devices": ["cpu"]}


@pytest.mark.parametrize("device", DEVICES)
def test_parallel_host_engine_device_cnv(tmp_path, monkeypatch, device):
    """``-P 2`` on the host engine with GROM_TPU_DEVICE_CNV=1: each worker
    runs the CNV stage's kernels on its device (``devices=["cpu"]``: the
    plain versions; on the card: dealt over the cards), and the files
    equal the serial run's."""
    _need(device)
    from grom_tpu_torch import _build
    from grom_tpu_torch.config import GromConfig
    from grom_tpu_torch.driver import run
    d = os.path.join(DATA, "ctx2x60k")
    _knobs(monkeypatch, GROM_TPU_DEVICE_CNV="1")
    serial = str(tmp_path / "serial.vcf")
    run(GromConfig(bam=os.path.join(d, "ds.bam"),
                   ref_fasta=os.path.join(d, "ds.fa"), out_vcf=serial),
        engine="host", device=device)
    monkeypatch.setenv("GROM_TPU_TIMING", "1")    # the workers' phases
    _build.reset_launches()
    out = str(tmp_path / "o.vcf")
    reps = _in_process(_fixture_args("ctx2x60k") + ["-P", "2"], out, "host",
                       None if device == "cuda" else ["cpu"], monkeypatch)
    assert len(reps) == 2
    for rep in reps:
        assert rep["engine"] == "host"
        assert rep["device"].startswith(device)
        assert "cnv.zscores_dev" in rep["phases"], rep["phases"]
        assert "cnv.zscores" not in rep["phases"]
        if device == "cuda":
            assert rep["max_memory_allocated"] > 0
            assert rep["memory_share"] is not None
    if device == "cuda":
        assert all(_build.LAUNCHES[k] > 0 for k in CNV_KERNELS)
        assert _build.LAUNCHES["tile_accumulate"] == 0
    for suffix in (".vcf", ".ctx.vcf"):
        assert _body(out[:-4] + suffix) == _body(serial[:-4] + suffix)
