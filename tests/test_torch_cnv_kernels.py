"""The port's CNV kernels (grom_tpu_torch/ops/cnv_device.py) against
grom_tpu on the same inputs, bitwise:

* ``zscores`` (ranks 1 and 0, the mapq weight computed inside) and
  ``seed_eval`` (both outer classes, the full window up to maxw) against
  grom_tpu's ``zscores_device`` and ``seed_eval_device`` under jax x64;
* the count-table semantics of ``zscores`` on seeded inputs built to break
  them (short, empty and capped rows, keys past a row's largest value,
  keys from the clamp, a desert of millions of bases with no class update,
  a first update far from position 0), against grom_tpu's
  ``zscores_device`` and a numpy reference;
* ``null_model`` against the host's ``call/cnv.py:_null_window_model``
  (and grom_tpu's ``null_model_device`` against the host within 1e-9
  relative, its known XLA-cumsum drift).

The inputs are the ones the port's CNV stage hands its kernels on the
cnvrich fixture (captured from a CPU run of its detect_del_dup), plus a
seeded normal z field for the null model. The stage itself, its z handed
to the null model as a tensor, is held to the host engine on cnvrich and
cnvmany. On the CPU the wrappers run the
plain versions; chip_smoke.py holds the CUDA kernels to them on the card."""

import contextlib
import os
import types

import numpy as np
import pytest
import torch

from grom_tpu_torch.ops import cnv_device
from grom_tpu_torch.testing import zcases

DATA = os.path.join(os.path.dirname(__file__), "data")

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core would oversubscribe the host
torch.set_num_threads(1)


@contextlib.contextmanager
def _x64():
    """jax x64 on the CPU for one comparison; the flag is process-global,
    so it is restored afterwards."""
    import jax
    prev = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        with jax.default_device(jax.devices("cpu")[0]):
            yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a, np.float64))
    return a.view(np.uint64)


def _unpacked(si):
    """grom_tpu's per-base seed inputs (numpy) from the port's packed
    ones: svals, lowa, sok0, sok1, gcls_idx, gcls_val, win_std."""
    fl = si.flags.numpy()
    bit = lambda f: (fl & f) != 0
    idx = np.arange(len(fl), dtype=np.int64)
    gcls_idx = np.maximum.accumulate(np.where(bit(cnv_device.F_GDEF), idx,
                                              -1))
    return (si.svals.numpy(), bit(cnv_device.F_LOWA),
            bit(cnv_device.F_SOK0), bit(cnv_device.F_SOK1), gcls_idx,
            bit(cnv_device.F_GCLS1).astype(np.int8), si.win_std.numpy())


def _seed_outcomes(out):
    return [x.numpy() for x in cnv_device.unpack_outcomes(out)]


def _same_outcomes(got, want):
    for k, (g, w) in enumerate(zip(got, want)):
        if g.dtype == np.float64:
            assert np.array_equal(_bits(g), _bits(w)), k
        else:
            assert np.array_equal(g, np.asarray(w)), k


def _cnv_inputs(fixture, fa=None, bam=None, **cfg_kw):
    """(chrom, host per-base arrays with the rd lists, cfg, drv) of a
    fixture's first contig (or of the dataset ``fa``/``bam``), from the
    port's host engine."""
    from grom_tpu_torch.call import scan as scan_mod
    from grom_tpu_torch.config import DerivedConfig, GromConfig
    from grom_tpu_torch.driver import _subset_reads
    from grom_tpu_torch.ingest import bam as bam_mod
    from grom_tpu_torch.ingest import fasta as fasta_mod
    from grom_tpu_torch.ingest.batches import build_batch
    from grom_tpu_torch.ingest.insert_size import load_or_estimate
    d = os.path.join(DATA, fixture or "")
    cfg = GromConfig(bam=bam or os.path.join(d, "ds.bam"),
                     ref_fasta=fa or os.path.join(d, "ds.fa"),
                     out_vcf="unused.vcf", **cfg_kw)
    info = fasta_mod.index_fasta(cfg.ref_fasta)
    _, reads = bam_mod.read_bam(cfg.bam)
    ins = load_or_estimate(cfg.bam, reads, cfg)
    drv = DerivedConfig.from_insert_stats(cfg, ins.insert_mean,
                                          ins.insert_min, ins.insert_max,
                                          ins.read_len, ins.mapped_read_bases)
    chrom = fasta_mod.load_chromosome(cfg.ref_fasta, info, info.names[0])
    sub = _subset_reads(reads, np.flatnonzero(reads.refid == 0))
    batch = build_batch(sub, 0, cfg.min_mapq, cfg.add_factor, cfg.rmdup)
    scan_start, _, _ = scan_mod.scan_bounds(cfg, drv, sub.pos, 0)
    arr = scan_mod.accumulate_chromosome(chrom, batch, cfg, drv, scan_start)
    return chrom, arr, cfg, drv


@pytest.fixture(scope="module")
def stage():
    """Kernel inputs of the port's CNV stage on cnvrich (CPU run), with
    the calls it emitted."""
    from grom_tpu_torch.call import cnv as tcnv
    from grom_tpu_torch.ops import state

    chrom, arr, cfg, drv = _cnv_inputs("cnvrich")
    rec = {"zscores": [], "null_model": [], "seed_eval": []}
    orig = {k: getattr(cnv_device, k) for k in rec}
    bin_rows = []
    cnv_tables = state.cnv_tables

    copies = {}

    def snapshot(x):
        # a CPU tensor may share memory with a numpy array that the stage
        # goes on to change (the z list is rescored in place); an input
        # passed to several calls keeps one copy
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            if id(x) not in copies:
                copies[id(x)] = (x, type(x)(*(snapshot(v) for v in x)))
            return copies[id(x)][1]
        return x

    def recorder(name):
        def f(*a, **k):
            # the call gets the stage's own arguments (zscores writes into
            # a view of the stage's z), the record copies taken before it
            kept = tuple(snapshot(x) for x in a)
            out = orig[name](*a, **k)
            rec[name].append((kept, k, out))
            return out
        return f

    def tables_recorder(arrs, *a, **k):
        bin_rows.append([np.array(r) for r in arrs])
        return cnv_tables(arrs, *a, **k)

    for k in rec:
        setattr(cnv_device, k, recorder(k))
    state.cnv_tables = tables_recorder
    try:
        feats = tcnv.preprocess_reference(chrom, drv.insert_mean,
                                          cfg.min_repeat)
        depth = np.add(arr.rd_hi, arr.rd_lo, dtype=np.int32)
        prep = tcnv.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo, arr.rd_mq,
                             cfg, drv, depth=depth)
        dels, dups = tcnv.detect_del_dup(chrom, feats, prep, None, None, cfg,
                                         drv, cfg.ploidy, depth=depth,
                                         engine="torch", device="cpu")
    finally:
        for k, v in orig.items():
            setattr(cnv_device, k, v)
        state.cnv_tables = cnv_tables
    return types.SimpleNamespace(rec=rec, cfg=cfg, prep=prep, dels=dels,
                                 dups=dups, L=len(chrom), bin_rows=bin_rows)


@pytest.mark.parametrize("ranks", [True, False])
def test_zscores_match_jax(stage, ranks):
    """On a 60 kb window of the stage's z block (JAX's kernel compares
    every base against a whole padded bin row, so the full block is slow
    on the CPU); both sides start the sticky class fresh at its edge. The
    port computes the mapq weight itself; grom_tpu's wrapper computes it
    in numpy."""
    from grom_tpu.ops.cnv_device import build_bin_matrix, zscores_device
    a, _, _ = stage.rec["zscores"][0]
    zin, tables, nb, min_mapq, mf, dup_f = a[:6]
    a = zin.depth.shape[0] // 3
    zin = cnv_device.ZInputs(*(x[a:a + 60_000].contiguous() for x in zin))
    n = zin.depth.shape[0]
    got = cnv_device.zscores(zin, tables, nb, min_mapq, mf, dup_f,
                             ranks).numpy()
    rows = stage.bin_rows[0]
    mat, lens = build_bin_matrix(rows[:nb], rows[nb:], nb)
    with _x64():
        want = zscores_device(
            zin.depth.numpy(), zin.mq.numpy(), zin.gc.numpy(),
            zin.low_acgt.numpy(), mat, lens, tables.ave.numpy(),
            tables.std.numpy(), tables.pv_p.numpy(), tables.pv_sd.numpy(),
            nb, 0, n, min_mapq, mf, dup_f, ranks)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.count_nonzero(got) > n // 2


def test_count_tables_hold_the_rows(stage):
    """The stage's count tables give back every bin row: cnt[v] - cnt[v-1]
    copies of v below the row's width, then its tail."""
    tables, nb = stage.rec["zscores"][0][0][1:3]
    rows = tables.rows.view(-1, 5).numpy()
    cnt, tail = tables.cnt.numpy(), tables.tail.numpy()
    assert len(rows) == 2 * nb == len(stage.bin_rows[0])
    for r, want in zip(rows, stage.bin_rows[0]):
        nk, width, c_off, t_off, t_len = (int(x) for x in r)
        c = np.concatenate([[0], cnt[c_off:c_off + width]])
        row = np.concatenate([np.repeat(np.arange(width), np.diff(c)),
                              tail[t_off:t_off + t_len]])
        assert nk == len(want) and np.array_equal(row, want)


def _zscores_numpy(depth, mq, gc, la, arrs, ave, std, pv_p, pv_sd, nb,
                   min_mapq, mf, dup_f, ranks):
    """The z stage as the host computes it (call/cnv.py): the sticky class
    by a running maximum of indices, midrank counts by searches in each
    sorted row, the mapq weight in numpy."""
    n = len(depth)
    d, m, g = (x.astype(np.int64) for x in (depth, mq, gc))
    lens = np.array([len(a) for a in arrs], np.int64)
    hi_mq = m >= min_mapq
    defz = np.where(hi_mq, 0, np.where(d > 0, 1, -1))
    eligible = (la == 0) & (lens[np.where(hi_mq, 0, nb) + g] > 1)
    fi = np.where(eligible & (defz >= 0), np.arange(n), -1)
    np.maximum.accumulate(fi, out=fi)
    cls = np.where(defz >= 0, defz,
                   np.where(fi >= 0, defz[np.maximum(fi, 0)], 0))
    k = cls * nb + g
    nk = lens[k]
    valid = eligible & (nk > 0)
    av = ave[k]
    dd = d.astype(np.float64)
    below = dd < av
    clamp = dup_f * av
    if ranks:
        key_l = np.where(dd > clamp, clamp.astype(np.int64), d)
        s_dr, s_dl, s_kl = (np.zeros(n, np.int64) for _ in range(3))
        for kk in np.unique(k[valid]):
            sel = np.flatnonzero(valid & (k == kk))
            row = np.asarray(arrs[kk], np.int64)
            s_dr[sel] = np.searchsorted(row, d[sel], side="right")
            s_dl[sel] = np.searchsorted(row, d[sel], side="left")
            s_kl[sel] = np.searchsorted(row, key_l[sel], side="left")
        fx = lambda c: np.where((nk == 2) & (c == 0), 1, c)
        bi = np.where(below, fx(s_dr), nk - fx(s_kl))
        bi2 = np.where(below, fx(s_dl), nk - fx(s_dr))
        with np.errstate(divide="ignore", invalid="ignore"):
            prob = (np.where(bi <= 0, 0.5, bi) + np.where(bi2 <= 0, 0.5, bi2)
                    ) / (2.0 * nk)
        pi = np.clip(np.searchsorted(pv_p, prob, side="right"), 0,
                     len(pv_p) - 1)
        base = np.where(below, pv_sd[pi], -pv_sd[pi])
    else:
        sb = std[k]
        with np.errstate(divide="ignore", invalid="ignore"):
            plain = np.where(sb != 0, (av - dd) / sb, 0.0)
            clamped = np.where(sb != 0, (dup_f - 1.0) * (-av) / sb, 0.0)
        base = np.where(below | ~(dd > clamp), plain, clamped)
    w = np.where(mq >= min_mapq, mf + (1.0 - mf) * (mq - min_mapq) / 40.0,
                 mf)
    return np.where(valid, w * base, 0.0)


@pytest.mark.parametrize("case", zcases.CASES)
@pytest.mark.parametrize("ranks", [True, False])
def test_zscores_count_tables(case, ranks):
    """The plain version's count-table semantics against a numpy
    reference of the host's z stage; the smaller cases also against
    grom_tpu's ``zscores_device`` under x64."""
    from grom_tpu.call.cnv import build_pval2sd
    from grom_tpu.ops.cnv_device import build_bin_matrix, zscores_device
    from grom_tpu_torch.ops import state
    depth, mq, gc, la, arrs, cap, nb = zcases.zscore_case(case)
    ave, std = zcases.bin_stats(arrs)
    pv_p, pv_sd = build_pval2sd()
    tables = state.cnv_tables(arrs, ave, std, pv_p, pv_sd, "cpu", cap=cap)
    zin = state.z_inputs(depth, mq, gc, la, 0, len(depth), "cpu")
    par = (zcases.MIN_MAPQ, zcases.MAPQ_FACTOR, zcases.DUP_THR_FACTOR)
    got = cnv_device.zscores(zin, tables, nb, *par, ranks).numpy()
    want = _zscores_numpy(depth, mq, gc, la, arrs, ave, std, pv_p, pv_sd,
                          nb, *par, ranks)
    assert np.array_equal(_bits(got), _bits(want))
    assert np.count_nonzero(got) > len(got) // 10
    if len(depth) <= 100_000:
        mat, lens = build_bin_matrix(arrs[:nb], arrs[nb:], nb)
        with _x64():
            jx = zscores_device(depth, mq, gc, la, mat, lens, ave, std,
                                pv_p, pv_sd, nb, 0, len(depth), *par, ranks)
        assert np.array_equal(_bits(got), _bits(jx))
    rows = tables.rows.view(-1, 5).numpy()
    if case == "wide rows":
        assert rows[0, 1] == cap and rows[0, 4] > 0    # a capped row
    if case == "short and empty rows":
        assert {0, 1, 2} <= set(rows[:, 0].tolist())


@pytest.mark.parametrize("side", [0, 1])
def test_seed_eval_matches_jax(stage, side):
    """Both outer classes over the full maxw window, on the del (0) and
    dup (1) scans: every seed the scan evaluated whose window outlived 512
    bases (up to 64) plus a seeded sample of the rest."""
    from grom_tpu.ops.cnv_device import seed_eval_device
    calls = stage.rec["seed_eval"]
    sis = []
    for a, _, _ in calls:
        if not any(a[0] is x for x in sis):
            sis.append(a[0])
    assert len(sis) == 2
    mine = [c for c in calls if c[0][0] is sis[side]]
    si, _, _, minw, maxw, max_low, be = mine[0][0]
    seeds = torch.cat([c[0][1] for c in mine])
    f1 = torch.cat([c[2][0] for c in mine]).numpy()   # row 0 of the packing
    rng = np.random.default_rng(3 + side)
    long_ = np.flatnonzero(f1 > 512)
    long_ = rng.choice(long_, size=min(64, len(long_)), replace=False)
    rest = rng.choice(len(seeds), size=min(300, len(seeds)), replace=False)
    pick = seeds[torch.from_numpy(np.union1d(long_, rest))]
    assert len(long_) > 0
    sd = torch.cat([pick, pick])
    cl = torch.cat([torch.zeros(len(pick), dtype=torch.int8),
                    torch.ones(len(pick), dtype=torch.int8)])
    got = _seed_outcomes(cnv_device.seed_eval(si, sd, cl, minw, maxw,
                                              max_low, be))
    with _x64():
        want = seed_eval_device(*_unpacked(si), sd.numpy(), cl.numpy(),
                                minw, maxw, max_low, be, width=maxw)
    _same_outcomes(got, want)
    assert got[1].any() and (got[0] == maxw).any()


def _synthetic_seed_inputs(seed, L=24_000, minw=100, maxw=2000):
    """Seeded window-scan state with every branch of the seed evaluation:
    deletion-like blocks (long windows, scores past 3), class switches,
    z runs that are exactly zero or negative, ungated stretches, zero
    window stdevs, and windows that run past the chromosome end."""
    rng = np.random.default_rng(seed)
    idx = np.arange(L)
    block = (idx // 700) % 5 == 2                 # deletion-like blocks
    lowa = rng.random(L) < np.where(block, 0.97, 0.85)
    lowa[(idx // 1900) % 7 == 3] = False          # ungated stretches
    defc = rng.choice(np.array([-1, 0, 1], np.int8), L, p=[0.1, 0.6, 0.3])
    defc[(idx // 300) % 4 == 1] = 1               # runs of the other class
    gcls_idx = np.where(lowa & (defc >= 0), idx, -1)
    np.maximum.accumulate(gcls_idx, out=gcls_idx)
    gcls_val = defc[np.maximum(gcls_idx, 0)]
    p_ok = np.where(block, 0.95, 0.35)
    sok0 = rng.random(L) < p_ok
    sok1 = rng.random(L) < np.where(block, 0.9, 0.5)
    svals = rng.normal(0.0, 1.0, L) + np.where(block, 2.5, 0.0)
    svals[(idx // 1100) % 6 == 4] = 0.0
    svals[(idx // 1300) % 9 == 5] *= -1.0
    win_std = np.zeros(maxw + 1)
    win_std[minw:] = 1.5 / np.sqrt(np.arange(minw, maxw + 1) / minw)
    win_std[rng.choice(np.arange(minw, maxw + 1), 40)] = 0.0
    be = L - 50
    cand = np.flatnonzero((sok0 | sok1)[:be])
    seeds = np.sort(rng.choice(cand, 2500, replace=False))
    seed_cls = rng.integers(0, 2, len(seeds)).astype(np.int8)
    si = cnv_device.SeedInputs(
        torch.from_numpy(svals),
        torch.from_numpy(cnv_device.pack_flags(lowa, sok0, sok1, gcls_idx,
                                               gcls_val)),
        torch.from_numpy(win_std))
    return (si, torch.from_numpy(seeds), torch.from_numpy(seed_cls), minw,
            maxw, 2.0, be)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seed_eval_synthetic_matches_jax(seed):
    from grom_tpu.ops.cnv_device import seed_eval_device
    si, seeds, cls, minw, maxw, max_low, be = _synthetic_seed_inputs(seed)
    got = _seed_outcomes(cnv_device.seed_eval(si, seeds, cls, minw, maxw,
                                              max_low, be))
    with _x64():
        want = seed_eval_device(*_unpacked(si), seeds.numpy(), cls.numpy(),
                                minw, maxw, max_low, be, width=maxw)
    _same_outcomes(got, want)
    f1, begin, n = got[0], got[1], got[4]
    # the branches really ran: calls begun, windows that never failed,
    # seeds that failed inside the first window
    assert begin.sum() > 20 and (f1 == n).sum() > 20 and (f1 < minw).any()


def _tier_seed_inputs(maxw=10_000, minw=100):
    """Seed windows at the edges of the kernel's two tiers (tier 1 walks
    the first window, minw = 100 offsets rounded up to 128; tier 2 then 32
    offsets a step): a run of included bases followed by a run of excluded
    ones fails the +-1 walk at twice the run's length from the seed, so
    seeds 63-65 bases before the run's end fail at offsets 126-130 and
    seeds 257-261 before it at 508-516; seeds deep in a 12 kb run walk all
    of maxw with a long grow phase (scores past 3 throughout); near the
    scan end ``be`` clips the windows to 127-129, 300 and 511-513 offsets,
    and the shortest windows reach past the chromosome end."""
    rng = np.random.default_rng(11)
    L = 40_000
    be = L - 50
    lowa = np.ones(L, bool)
    ok = np.zeros(L, bool)
    ok[2_000:3_000] = True                     # f1 = 2 x (3000 - seed)
    ok[5_000:17_000] = True                    # the long run
    ok[be - 700:] = True                       # clipped windows
    lowa[rng.choice(L, 300, replace=False)] = False
    defc = np.where(rng.random(L) < 0.8, 0, 1).astype(np.int8)
    defc[rng.choice(L, 200, replace=False)] = -1
    idx = np.arange(L)
    gcls_idx = np.maximum.accumulate(np.where(lowa & (defc >= 0), idx, -1))
    gcls_val = defc[np.maximum(gcls_idx, 0)]
    svals = np.where(ok, rng.normal(3.0, 1.0, L), rng.normal(0.0, 1.0, L))
    win_std = np.zeros(maxw + 1)
    win_std[minw:] = 1.5 / np.sqrt(np.arange(minw, maxw + 1) / minw)
    seeds = np.array([3_000 - k for k in (63, 64, 65, 150, 257, 258, 259,
                                          260, 261, 400)]
                     + [5_000, 5_001, 6_000, 6_017]
                     + [be - k for k in (513, 512, 511, 300, 129, 128, 127,
                                         60, 10)], np.int64)
    seeds = np.concatenate([seeds, seeds])
    cls = np.repeat(np.array([0, 1], np.int8), len(seeds) // 2)
    si = cnv_device.SeedInputs(
        torch.from_numpy(svals),
        torch.from_numpy(cnv_device.pack_flags(lowa, ok, ok, gcls_idx,
                                               gcls_val)),
        torch.from_numpy(win_std))
    return (si, torch.from_numpy(seeds), torch.from_numpy(cls), minw, maxw,
            0.05, be)


def test_seed_eval_tiers_match_jax():
    """The plain version against grom_tpu's seed_eval_device under x64 on
    windows at the edges of the two tiers."""
    from grom_tpu.ops.cnv_device import seed_eval_device
    si, seeds, cls, minw, maxw, max_low, be = _tier_seed_inputs()
    got = _seed_outcomes(cnv_device.seed_eval(si, seeds, cls, minw, maxw,
                                              max_low, be))
    with _x64():
        want = seed_eval_device(*_unpacked(si), seeds.numpy(), cls.numpy(),
                                minw, maxw, max_low, be, width=maxw)
    _same_outcomes(got, want)
    f1, begin, c_end, _, n = got
    # fails on both sides of the tier edge, the full window, the clips
    assert {126, 128, 130, 508, 510, 512, 514, 516} <= set(f1.tolist())
    full = (f1 == maxw) & (n == maxw)
    assert full.sum() >= 4 and begin[full].all()
    assert (c_end[full] - seeds.numpy()[full] > 9_000).all()
    assert {127, 128, 129, 300, 511, 512, 513} <= set(n[f1 == n].tolist())
    assert (seeds.numpy() + n > be + 40).any()


@pytest.mark.parametrize("field", ["cnvrich_z", "normal"])
def test_null_model_matches_host(stage, field):
    from grom_tpu.call.cnv import _null_window_model
    from grom_tpu.ops.cnv_device import null_model_device
    (z, gate, seg, minw, maxw), _, _ = stage.rec["null_model"][0]
    cfg = stage.cfg
    L = stage.L
    if field == "normal":
        z = torch.from_numpy(np.random.default_rng(0).normal(0, 1, L))
    got = cnv_device.null_model(z, gate, seg, minw, maxw)
    # the host derives the gate from (low_acgt, nwin, mq, gc): hand it one
    # that reproduces ``gate`` exactly
    g = gate.numpy()
    host = _null_window_model(
        types.SimpleNamespace(lowvar_blocks=stage.prep.lowvar_blocks), None,
        np.zeros(L, np.int16), np.zeros(L, np.int64),
        np.full((2, cfg.num_gc_bins), 2), (~g).astype(np.int8), z.numpy(),
        cfg, L)
    assert np.array_equal(_bits(got), _bits(host))
    assert np.count_nonzero(host) > (maxw - minw) // 2
    with _x64():
        jx = null_model_device(stage.prep.lowvar_blocks, z.numpy(), g, minw,
                               maxw, cfg.sampling_rate)
    assert np.allclose(jx, host, rtol=1e-9, atol=1e-12)


def _host_null_model(stage, z, gate, port=False):
    """grom_tpu's host ``_null_window_model`` (the port's copy with
    ``port``) on ``z`` with a gate that reproduces ``gate`` exactly (the
    host derives it from low_acgt, nwin, mq and gc)."""
    if port:
        from grom_tpu_torch.call.cnv import _null_window_model
    else:
        from grom_tpu.call.cnv import _null_window_model
    L = stage.L
    return _null_window_model(
        types.SimpleNamespace(lowvar_blocks=stage.prep.lowvar_blocks), None,
        np.zeros(L, np.int16), np.zeros(L, np.int64),
        np.full((2, stage.cfg.num_gc_bins), 2), (~gate.numpy()).astype(np.int8),
        z.numpy(), stage.cfg, L)


@pytest.mark.parametrize("batch", [1, 7])
def test_null_model_small_batches_match_host(stage, batch):
    """Batches far smaller than the segment count (the CUDA kernel's
    batches of NULL_BATCH, and its carry kept across them): the carries
    cross many batch edges and resets, and the result stays bitwise equal
    to the host's."""
    (z, gate, seg, minw, maxw), _, _ = stage.rec["null_model"][0]
    assert len(seg.s) > 10 * batch and seg.reset[1:].any()
    got = cnv_device.null_model(z, gate, seg, minw, maxw, batch=batch)
    assert np.array_equal(_bits(got), _bits(_host_null_model(stage, z,
                                                             gate)))


def test_null_carries_match_host_chain():
    """``_carries``, the chain the card's ``null_carry`` pass runs batch by
    batch from a running state, against the host loop's carry rule
    (call/cnv.py _null_window_model: tot0 = float(zc[-1]) carried across
    phases, zeroed where a window completes or a block starts), over
    batches of 1, 5 and all segments."""
    rng = np.random.default_rng(5)
    S = 400
    w = np.where(rng.random(S) < 0.3, 0, rng.integers(1, 50, S))
    w[0] = 0
    seg = cnv_device.NullSegments(np.zeros(S, np.int64), np.ones(S, np.int64),
                                  w.astype(np.int64), w == 0)
    seg_z = rng.normal(0.0, 3.0, S)
    seg_z[rng.random(S) < 0.05] = -0.0
    seg_c = rng.integers(0, 10_000, S)
    want_t, want_c = np.zeros(S), np.zeros(S, np.int64)
    tot0, cnt0 = 0.0, 0
    for i in range(S):
        if seg.reset[i]:
            tot0, cnt0 = 0.0, 0
        want_t[i], want_c[i] = tot0, cnt0
        tot0 = float(tot0 + seg_z[i])
        cnt0 = int(cnt0 + seg_c[i])
    for batch in (1, 5, S):
        run = [0.0, 0]
        parts = [cnv_device._carries(seg, b0, min(b0 + batch, S),
                                     seg_z[b0:b0 + batch],
                                     seg_c[b0:b0 + batch], run)
                 for b0 in range(0, S, batch)]
        got_t = np.concatenate([p[0] for p in parts])
        got_c = np.concatenate([p[1] for p in parts])
        assert np.array_equal(_bits(got_t), _bits(want_t))
        assert np.array_equal(got_c, want_c)


@pytest.mark.parametrize("kernel", ["zscores", "seed_eval", "null_model"])
def test_cnv_wrappers_reject_other_devices(stage, kernel):
    """A wrapper runs its kernel on CUDA tensors, its plain version on CPU
    tensors, and refuses any other device."""
    meta = lambda x: (x.to("meta") if isinstance(x, torch.Tensor) else
                      type(x)(*(meta(v) for v in x))
                      if isinstance(x, tuple) and hasattr(x, "_fields")
                      else x)
    args, _, _ = stage.rec[kernel][0]
    with pytest.raises(ValueError, match="cuda or cpu"):
        getattr(cnv_device, kernel)(*(meta(a) for a in args))


def test_null_segments_cover_blocks(stage):
    """Every lowvar block base is walked once per sampling phase, minus
    the phase offset."""
    (_, _, seg, _, maxw), _, _ = stage.rec["null_model"][0]
    rate = stage.cfg.sampling_rate
    want = sum(max(be - bs - ph * maxw // rate, 0)
               for bs, be in stage.prep.lowvar_blocks for ph in range(rate))
    assert int(seg.n.sum()) == want
    assert seg.reset[0] and (seg.n > 0).all()


def test_cnv_stage_emits_calls(stage):
    assert len(stage.dels) + len(stage.dups) >= 5


@pytest.fixture(scope="module")
def cnvmany_data(tmp_path_factory):
    from grom_tpu_torch.testing import cnvmany
    d = tmp_path_factory.mktemp("cnvmany")
    return cnvmany.build(str(d / "ds"))


@pytest.mark.parametrize("fixture", ["cnvrich", "cnvmany"])
def test_cnv_stage_z_tensor_to_null_model(fixture, request, monkeypatch):
    """The port's CNV stage on the torch engine (CPU tensors: the plain
    versions) hands its z to the null model as a tensor, never through the
    host: that z equals the host engine's pre-rescore z bitwise, the
    window stdevs equal the port's ``_null_window_model`` on the host z
    and the native host engine's, and the calls equal the host engine's
    (-V 0.0001, as the fixtures' oracles)."""
    from grom_tpu_torch.call import cnv as tcnv
    if fixture == "cnvmany":
        fa, bam = request.getfixturevalue("cnvmany_data")
        chrom, arr, cfg, drv = _cnv_inputs(None, fa, bam,
                                           rd_pval_threshold=1e-4)
    else:
        chrom, arr, cfg, drv = _cnv_inputs(fixture, rd_pval_threshold=1e-4)
    L = len(chrom)
    feats = tcnv.preprocess_reference(chrom, drv.insert_mean, cfg.min_repeat)
    depth = np.add(arr.rd_hi, arr.rd_lo, dtype=np.int32)
    prep = tcnv.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo, arr.rd_mq, cfg,
                         drv, depth=depth)
    seen = {}
    native_ctx = tcnv._native_cnv_ctx

    def host_ctx(*a, **k):
        nat = native_ctx(*a, **k)
        assert nat is not None

        class Spy:
            def __getattr__(self, name):
                return getattr(nat, name)

            def null_model(self, blocks, z):
                seen["host_z"] = z.copy()
                seen["host_std"] = nat.null_model(blocks, z)
                return seen["host_std"]
        return Spy()

    def detect(engine):
        return tcnv.detect_del_dup(chrom, feats, prep, None, None, cfg, drv,
                                   cfg.ploidy, depth=depth, engine=engine,
                                   device="cpu")

    monkeypatch.setattr(tcnv, "_native_cnv_ctx", host_ctx)
    host_calls = detect("host")
    null_model = cnv_device.null_model

    def device_null_model(z, gate, *a, **k):
        assert isinstance(z, torch.Tensor) and z.shape == (L,)
        seen["z"], seen["gate"] = z.numpy().copy(), gate.clone()
        seen["std"] = null_model(z, gate, *a, **k)
        return seen["std"]

    monkeypatch.setattr(cnv_device, "null_model", device_null_model)
    calls = detect("torch")
    assert np.array_equal(_bits(seen["z"]), _bits(seen["host_z"]))
    host = _host_null_model(types.SimpleNamespace(
        L=L, cfg=cfg, prep=prep), torch.from_numpy(seen["host_z"]),
        seen["gate"], port=True)
    assert np.array_equal(_bits(seen["std"]), _bits(host))
    assert np.array_equal(_bits(seen["std"]), _bits(seen["host_std"]))
    assert calls == host_calls
    assert len(calls[0]) + len(calls[1]) >= 5


@pytest.mark.cuda
def test_null_model_cuda_no_round_trip_between_batches(stage):
    """On the card, with torch's sync debug mode warning: the null model
    makes as many host syncs in batches of 7 segments (dozens of
    batches) as in one batch: two, the segments' upload and the one copy
    back. (torch's one-time notice that the debug mode is a prototype is
    not a sync.)"""
    import warnings
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    (z, gate, seg, minw, maxw), _, want = stage.rec["null_model"][0]
    z, gate = z.cuda(), gate.cuda()
    syncs = []
    for batch in (7, len(seg.s)):
        cnv_device.null_model(z, gate, seg, minw, maxw, batch=batch)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = cnv_device.null_model(z, gate, seg, minw, maxw,
                                            batch=batch)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        assert np.array_equal(_bits(got), _bits(want))
        syncs.append(len([w for w in seen if "called a synchronizing CUDA "
                          "operation" in str(w.message)]))
    assert syncs == [2, 2]
    assert len(seg.s) > 20 * 7


@pytest.mark.cuda
@pytest.mark.parametrize("case", zcases.CASES)
def test_zscores_cuda_count_tables(case):
    """On the card: the z kernel on each seeded count-table case, ranks on
    and off, equals the plain version's CPU output bitwise, z written into
    a view of a larger tensor (the stage's [L] z) left untouched around
    it."""
    from grom_tpu_torch.call.cnv import build_pval2sd
    from grom_tpu_torch.ops import state
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    depth, mq, gc, la, arrs, cap, nb = zcases.zscore_case(case)
    ave, std = zcases.bin_stats(arrs)
    pv_p, pv_sd = build_pval2sd()
    par = (zcases.MIN_MAPQ, zcases.MAPQ_FACTOR, zcases.DUP_THR_FACTOR)
    n = len(depth)
    for ranks in (True, False):
        want = cnv_device.zscores(
            state.z_inputs(depth, mq, gc, la, 0, n, "cpu"),
            state.cnv_tables(arrs, ave, std, pv_p, pv_sd, "cpu", cap=cap),
            nb, *par, ranks)
        z = torch.zeros(n + 3, dtype=torch.float64, device="cuda")
        cnv_device.zscores(
            state.z_inputs(depth, mq, gc, la, 0, n, "cuda"),
            state.cnv_tables(arrs, ave, std, pv_p, pv_sd, "cuda", cap=cap),
            nb, *par, ranks, z[1:n + 1])
        z = z.cpu()
        assert np.array_equal(_bits(z[1:n + 1]), _bits(want))
        assert z[0] == 0 and (z[n + 1:] == 0).all()


@pytest.mark.cuda
def test_cnv_kernels_cuda_match_plain(stage):
    """On the card: each CUDA kernel, fed the stage's recorded inputs,
    equals the plain version's CPU output bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cu = lambda x: (x.cuda() if isinstance(x, torch.Tensor) else
                    type(x)(*(cu(v) for v in x)) if isinstance(x, tuple)
                    and hasattr(x, "_fields") else x)
    a, _, want = stage.rec["zscores"][0]
    got = cnv_device.zscores(*(cu(x) for x in a))
    assert np.array_equal(_bits(got.cpu()), _bits(want))
    a, _, want = stage.rec["null_model"][0]
    for batch in (cnv_device.NULL_BATCH, 7):
        got = cnv_device.null_model(*(cu(x) for x in a), batch=batch)
        assert np.array_equal(_bits(got), _bits(want))
    calls = stage.rec["seed_eval"]
    longest = max(calls, key=lambda c: int(c[2][0].sum()))
    tiers = (_tier_seed_inputs(), None,
             cnv_device.seed_eval(*_tier_seed_inputs()))
    for a, _, want in calls[:4] + [longest, tiers]:
        got = cnv_device.seed_eval(*(cu(x) for x in a))
        assert torch.equal(got.cpu(), want)
