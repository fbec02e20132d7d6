"""The port's SV entry scorer (grom_tpu_torch/ops/sv_device.py) against
grom_tpu's: numpy's ``score_sv_entries`` and ``DeviceSvScorer`` under jax
x64 on the CPU, on the same seeded entries. Tolerance: every output exactly
equal, in value and dtype, f64 bit for bit.

On the CPU the port's wrapper runs ``score_sv_entries_plain``; the CUDA
kernel is held to the same plain version on the card (chip_smoke.py and
the ``cuda``-marked test below). Also here: the engine policy
(``maybe_scorer``) and that a failed kernel build raises."""

import numpy as np
import pytest
import torch

from grom_tpu.call.sv_screen import score_sv_entries
from grom_tpu_torch.config import DerivedConfig, GromConfig
from grom_tpu_torch.ops import sv_device
from grom_tpu_torch.ops.state import sv_entries, sv_tables

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core would oversubscribe the host
torch.set_num_threads(1)

KW = dict(md=2, thr1=0.5, mean=300, lseq=100)


def _tables(mt, seed):
    rng = np.random.default_rng(seed)
    mq = np.sort(rng.random((mt + 1, mt + 1)))[:, ::-1].copy()
    hez = np.sort(rng.random((mt + 1, mt + 1)))[:, ::-1].copy()
    return mq, hez


def _entries(n, mt, af, seed):
    """tests/test_sv_device.py's generator: rd up to 3 mt (the scaled-trials
    branch), counts from 0 (zero-strong entries: 0/0 and x/0 in the ratio
    gate)."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(1000, 50000, n)).astype(np.int64)
    etype = rng.integers(1, 11, n).astype(np.int32)
    count = rng.integers(0, af * 2 * mt, n).astype(np.int64)
    rs = pos - rng.integers(0, 400, n)
    re = pos - rng.integers(-100, 300, n)
    rd = rng.integers(0, 3 * mt, n).astype(np.int64)
    wf = rng.integers(0, af * mt, n).astype(np.int64)
    wr = rng.integers(0, af * mt, n).astype(np.int64)
    cfh = rng.integers(0, af * mt, n).astype(np.int64)
    # zero-strong entries with and without weak evidence, and ctx_r with
    # a zero ctx_f count
    count[::7] = 0
    wf[::14] = 0
    wr[::14] = 0
    cfh[::5] = 0
    return (pos, etype, count, rs, re, rd, wf, wr, cfh)


def _same(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        if w.dtype.kind == "f":
            assert np.array_equal(g.view(np.uint64), w.view(np.uint64))
        else:
            assert np.array_equal(g, w)


def _plain(args, mq, hez, af, mt):
    p = sv_device.SvParams(af=af, mt=mt, **KW)
    out = sv_device.sv_score(sv_entries(args, "cpu"),
                             sv_tables(mq, hez, "cpu"), p)
    return [o.numpy() for o in sv_device.unpack_scores(out, len(args[0]))]


@pytest.mark.parametrize("n,mt,af,seed", [(777, 50, 10, 3), (1, 50, 10, 4),
                                          (5000, 1000, 6, 5)])
def test_plain_scorer_matches_numpy(n, mt, af, seed):
    mq, hez = _tables(mt, seed)
    args = _entries(n, mt, af, seed)
    want = score_sv_entries(np, *args, mq, hez, af=af, mt=mt, **KW)
    got = _plain(args, mq, hez, af, mt)
    _same(got, want)
    if n > 1:
        _, acc, _, h = got
        assert acc.any() and not acc.all()
        assert (h == 2.0).any() and (h != 2.0).any()   # both gate outcomes


def test_plain_scorer_matches_jax_x64():
    """grom_tpu's DeviceSvScorer under jax x64 on the CPU (its pad-bucket
    path: n = 777 is not a power of two)."""
    import jax
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        from grom_tpu.ops.sv_device import DeviceSvScorer
        mt, af = 50, 10
        mq, hez = _tables(mt, 3)
        args = _entries(777, mt, af, 3)
        with jax.default_device(jax.devices("cpu")[0]):
            want = DeviceSvScorer(mq, hez, af, mt, KW["md"], KW["thr1"],
                                  KW["mean"], KW["lseq"])(*args)
        _same(_plain(args, mq, hez, af, mt), want)
    finally:
        jax.config.update("jax_enable_x64", prev)


def test_scorer_callable_real_tables():
    """SvScorer (the ``scorer=`` seam, numpy in and out) with the real
    binomial tables, and an empty window."""
    from grom_tpu.stats import binom
    mt, af = 1000, 6
    mq = binom.build_mq_table(20, mt)
    hez = binom.build_hez_table(mt)
    sc = sv_device.SvScorer(mq, hez, af, mt, 3, 1e-4, 400, 101, "cpu")
    args = _entries(3000, mt, af, 11)
    want = score_sv_entries(np, *args, mq, hez, af=af, mt=mt, md=3,
                            thr1=1e-4, mean=400, lseq=101)
    _same(sc(*args), want)
    empty = sc(*(a[:0] for a in args))
    _same(empty, score_sv_entries(np, *(a[:0] for a in args), mq, hez,
                                  af=af, mt=mt, md=3, thr1=1e-4, mean=400,
                                  lseq=101))


def _cfg_drv():
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    drv = DerivedConfig.from_insert_stats(cfg, 400, 100, 700, 100, 10**6)
    return cfg, drv


def test_maybe_scorer_policy(monkeypatch):
    cfg, drv = _cfg_drv()
    mq, hez = _tables(cfg.max_trials, 1)
    monkeypatch.delenv("GROM_TPU_DEVICE_SV", raising=False)
    for engine in ("torch", "mesh"):
        sc = sv_device.maybe_scorer(engine, mq, hez, cfg, drv, "cpu")
        assert isinstance(sc, sv_device.SvScorer)
        assert sc.device == torch.device("cpu")
    # memoized: the tables are uploaded once per process
    assert sv_device.maybe_scorer("mesh", mq, hez, cfg, drv, "cpu") is sc
    assert sv_device.maybe_scorer("host", mq, hez, cfg, drv, "cpu") is None
    monkeypatch.setenv("GROM_TPU_DEVICE_SV", "0")
    assert sv_device.maybe_scorer("torch", mq, hez, cfg, drv, "cpu") is None


def test_scorer_build_failure_raises(monkeypatch, tmp_path):
    """No nvcc: asking for the scorer on a CUDA device raises instead of
    falling back to the host screen (grom_tpu's maybe_scorer warns and
    returns None)."""
    from grom_tpu_torch import _build
    cfg, drv = _cfg_drv()
    mq, hez = _tables(cfg.max_trials, 1)
    monkeypatch.delenv("GROM_TPU_DEVICE_SV", raising=False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    sv_device._lib.cache_clear()
    sv_device._CACHE.clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            sv_device.maybe_scorer("torch", mq, hez, cfg, drv, "cuda")
    finally:
        sv_device._lib.cache_clear()


def test_scorer_rejects_other_devices():
    mq, hez = _tables(50, 1)
    entries = sv_entries(_entries(8, 50, 10, 1), "meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        sv_device.sv_score(entries, sv_tables(mq, hez, "meta"),
                           sv_device.SvParams(af=10, mt=50, **KW))


def _adversarial(n, mt, af, seed):
    """Entries at the edges of the arithmetic: rd above max_trials (the
    scaled-trials branch), 0/0 and x/0 ratios, negative etypes (they wrap
    once), negative counts and depths, so negative numerators of every
    flooring division with af > 1 and negative table indices that wrap
    once, and ctx_r entries with a zero ctx_f count."""
    from grom_tpu_torch.call.deposits import E_CTX_R
    from grom_tpu_torch.call.sv_screen import _ETYPE_KIND
    rng = np.random.default_rng(seed)
    n_et = len(_ETYPE_KIND)
    pos = np.sort(rng.integers(1000, 90000, n)).astype(np.int64)
    etype = rng.integers(-n_et, n_et, n).astype(np.int32)
    etype[::9] = E_CTX_R
    rd = rng.integers(-mt, 3 * mt, n).astype(np.int64)
    # strong // af and (strong + weak) // af stay at or above -(mt + 1)
    count = rng.integers(-af * mt // 2, af * 2 * mt, n).astype(np.int64)
    wf = rng.integers(-af * mt // 2, af * mt, n).astype(np.int64)
    wr = rng.integers(-af * mt // 2, af * mt, n).astype(np.int64)
    cfh = rng.integers(0, af * mt, n).astype(np.int64)
    rs = pos - rng.integers(-200, 400, n)
    re = pos - rng.integers(-100, 300, n)
    count[::5] = 0                 # 0/0 where weak is 0 too, else x/0
    wf[::10] = 0
    wr[::10] = 0
    cfh[::4] = 0
    return (pos, etype, count, rs, re, rd, wf, wr, cfh)


@pytest.mark.parametrize("af,seed", [(6, 21), (3, 22), (1, 23)])
def test_scorer_adversarial_matches_numpy_and_jax(af, seed):
    """The edges of the arithmetic, against numpy's score_sv_entries and
    grom_tpu's DeviceSvScorer under jax x64."""
    import jax
    mt = 60
    mq, hez = _tables(mt, seed)
    args = _adversarial(3000, mt, af, seed)
    assert (args[5] > mt).any() and (args[5] < 0).any()
    assert (args[1] < 0).any() and (args[2] < 0).any()
    want = score_sv_entries(np, *args, mq, hez, af=af, mt=mt, **KW)
    got = _plain(args, mq, hez, af, mt)
    _same(got, want)
    sc = sv_device.SvScorer(mq, hez, af, mt, KW["md"], KW["thr1"],
                            KW["mean"], KW["lseq"], "cpu")
    _same(sc(*args), want)
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        from grom_tpu.ops.sv_device import DeviceSvScorer
        with jax.default_device(jax.devices("cpu")[0]):
            jx = DeviceSvScorer(mq, hez, af, mt, KW["md"], KW["thr1"],
                                KW["mean"], KW["lseq"])(*args)
    finally:
        jax.config.update("jax_enable_x64", prev)
    _same(got, jx)
    _, acc, _, h = got
    assert acc.any() and not acc.all()
    assert (h == 2.0).any() and (h != 2.0).any()


def test_packed_entries_and_scores_round_trip():
    """``sv_entries`` packs the nine columns into one int64 [9, n] tensor
    in ENTRY_KEYS order; ``pack_scores`` / ``unpack_scores`` give back
    every score column bit for bit, dtypes included, in 21 bytes an
    entry."""
    args = _entries(501, 50, 10, 7)
    ent = sv_entries(args, "cpu")
    assert ent.dtype == torch.int64 and ent.shape == (9, 501)
    assert ent.is_contiguous()
    for k, a in enumerate(args):
        assert np.array_equal(ent[k].numpy(), a)
    rng = np.random.default_rng(8)
    kind = torch.from_numpy(rng.integers(-5, 9, 501).astype(np.int32))
    accept = torch.from_numpy(rng.random(501) < 0.5)
    binom = torch.from_numpy(rng.normal(0, 1, 501))
    hez = torch.from_numpy(rng.normal(0, 1, 501))
    buf = sv_device.pack_scores(kind, accept, binom, hez)
    assert buf.dtype == torch.uint8
    assert buf.numel() == sv_device.score_bytes(501) == 21 * 501
    back = sv_device.unpack_scores(buf, 501)
    _same([x.numpy() for x in back],
          [x.numpy() for x in (kind, accept, binom, hez)])


@pytest.mark.cuda
@pytest.mark.parametrize("n,mt,af,seed", [(777, 50, 10, 3),
                                          (100_000, 1000, 6, 5)])
def test_sv_score_cuda_matches_plain(n, mt, af, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mq, hez = _tables(mt, seed)
    p = sv_device.SvParams(af=af, mt=mt, **KW)
    for args in (_entries(n, mt, af, seed), _adversarial(n, mt, af, seed)):
        got = sv_device.sv_score(sv_entries(args, "cuda"),
                                 sv_tables(mq, hez, "cuda"), p)
        torch.cuda.synchronize()
        _same([o.numpy() for o in sv_device.unpack_scores(got.cpu(), n)],
              _plain(args, mq, hez, af, mt))


@pytest.mark.cuda
def test_sv_scorer_cuda_one_sync_per_window():
    """On the card, with torch's sync debug mode warning: each window's
    call makes one host sync (the copy back of the packed scores), and
    its scores equal numpy's."""
    import warnings
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt, af = 1000, 6
    mq, hez = _tables(mt, 9)
    sc = sv_device.SvScorer(mq, hez, af, mt, KW["md"], KW["thr1"],
                            KW["mean"], KW["lseq"], "cuda")
    windows = [_entries(n, mt, af, 30 + n) for n in (59_152, 1, 4000)]
    sc(*windows[0])
    torch.cuda.synchronize()
    for args in windows:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = sc(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [w for w in seen if "called a synchronizing CUDA "
                 "operation" in str(w.message)]
        assert len(syncs) == 1
        _same(got, score_sv_entries(np, *args, mq, hez, af=af, mt=mt, **KW))
