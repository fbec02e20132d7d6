"""The device CNV stage's outer window walk (``ops/cnv_device.py
window_scan``: compiled host C, ``csrc/cnv_walk.c``, over ``seed_eval``'s
outcomes) against the host stage's walk (``call/cnv.py _window_scan``),
on the CPU with the plain ``seed_eval``:

* its calls equal the host walk's field for field, ``stdev`` by its bits,
  on both sides, over seeded cases: ``_walk_inputs`` of
  test_torch_wgs_scale.py; planted events with a batch of three seeds, so
  both classes' batches roll over mid-walk; a candidate at the block's
  last position; a block with no candidate beside one with calls; a
  deletion longer than the longest window, whose call runs the slide
  phase;
* the ``cnv.winscan_dev`` span of ``detect_del_dup`` carries the walk's
  counts: ``resumes`` = ``batches`` + ``calls`` + blocks walked,
  ``batches`` the ``seed_eval`` launches, ``calls`` the calls returned;
* without a C compiler the walk's library raises, naming its source.
"""

import dataclasses

import numpy as np
import pytest
import torch

from grom_tpu_torch.call import cnv as cnv_mod
from grom_tpu_torch.config import GromConfig
from grom_tpu_torch.ops import cnv_device
from test_torch_wgs_scale import _walk_inputs

torch.set_num_threads(1)

CFG = GromConfig(bam="", ref_fasta="", out_vcf="")
MINW, MAXW = CFG.min_rd_window_len, CFG.max_rd_window_len
AVE = 30
GC_BOTH = 100    # a GC bin whose thresholds every depth passes, both sides
GC_CLS = 99      # a GC bin where a base without reads passes in one class


def _planted(L, seed, events):
    """Seeded per-base inputs of the walk at 30x with planted events
    ``(start, length, side)``: side +1 a deletion (depth a tenth, z +5),
    -1 a duplication (depth tripled, z -5)."""
    rng = np.random.default_rng(seed)
    depth = rng.poisson(AVE, L).astype(np.int32)
    sd = rng.normal(0.0, 2.0, L)
    for a, n, side in events:
        if side > 0:
            depth[a:a + n] //= 10
        else:
            depth[a:a + n] *= 3
        sd[a:a + n] += 5.0 * side
    mq = rng.uniform(10, 60, L).astype(np.int16)
    mq[depth == 0] = 0
    gc = rng.integers(0, GC_CLS, L)
    low_acgt = (rng.random(L) < 0.08).astype(np.int8)
    return depth, mq, gc, low_acgt, sd


def _case(name):
    """(blocks, depth, mq, gc, nwin, low_acgt, stdev, thr by side, win_std,
    L) of the named case."""
    rng = np.random.default_rng(5)
    nwin = rng.integers(0, 300, (2, 101))
    win_std = np.zeros(MAXW + 1)
    win_std[MINW:] = rng.uniform(0.8, 1.6)
    thr = {1: np.stack([np.full(101, 0.7 * AVE), np.full(101, 0.55 * AVE)]),
           -1: np.stack([np.full(101, 1.3 * AVE), np.full(101, 1.6 * AVE)])}
    if name == "walk_inputs":
        L = 30_000
        depth, mq, gc, low_acgt, sd, t = _walk_inputs(L)
        thr = {1: t, -1: t}
        return ([(50, L - 250)], depth, mq, gc, nwin, low_acgt, sd, thr,
                win_std, L)
    L = 40_000
    if name == "slide":
        events = [(6_000, 12_500, 1), (25_000, 11_000, -1)]
    else:
        events = [(3_000, 900, 1), (9_000, 400, -1), (15_000, 2_500, 1),
                  (24_000, 1_200, -1), (31_000, 300, 1)]
    depth, mq, gc, low_acgt, sd = _planted(L, 7, events)
    blocks = [(50, L - 250)]
    if name == "candidate_at_end":
        be = L - 250 - MINW
        gc[be - 1] = GC_BOTH
        thr[1][:, GC_BOTH] = 10 * AVE
        thr[-1][:, GC_BOTH] = 0
    if name == "classes":
        # a base without reads (no class of its own) opens each event; it
        # passes DEL's threshold in class 0 only and DUP's in class 1 only.
        # The walk's last candidate before it, 30 bases back, is of the
        # other class, the base just before it of the passing one: only a
        # walk that takes the class from every base it passes over starts
        # the call at the event's first base
        thr[1][1, GC_CLS], thr[-1][1, GC_CLS] = -1, 0
        for a, side, cls in ((15_000, 1, 0), (24_000, -1, 1)):
            depth[a - 30:a] = AVE
            mq[a - 30:a] = CFG.min_mapq + 10 if cls else 5
            depth[a - 30] = 5 if side > 0 else 2 * AVE
            mq[a - 1] = 5 if cls else CFG.min_mapq + 10
            depth[a], mq[a], gc[a], low_acgt[a] = 0, 0, GC_CLS, 0
    if name == "no_candidate":
        depth[:5_100] = AVE
        blocks = [(50, 5_000 + MINW), (5_200, L - 250)]
    return blocks, depth, mq, gc, nwin, low_acgt, sd, thr, win_std, L


def _bits(calls):
    return [tuple(np.float64(v).tobytes() if isinstance(v, float) else v
                  for v in dataclasses.astuple(c)) for c in calls]


CASES = ["walk_inputs", "small_batches", "candidate_at_end", "no_candidate",
         "slide", "classes"]


@pytest.mark.parametrize("case", CASES)
def test_walk_matches_host_window_scan(case, monkeypatch):
    blocks, depth, mq, gc, nwin, low_acgt, sd, thr, win_std, L = _case(case)
    launched = []
    seed_eval = cnv_device.seed_eval

    def counted(si, seeds, cls, *a):
        launched.append(int(cls[0]))
        return seed_eval(si, seeds, cls, *a)
    monkeypatch.setattr(cnv_device, "seed_eval", counted)
    slides = []
    slide = cnv_mod._slide_phase
    monkeypatch.setattr(cnv_mod, "_slide_phase",
                        lambda *a: slides.append(a[0]) or slide(*a))
    if case == "small_batches":
        monkeypatch.setitem(cnv_device.SEED_BATCH, "cpu", 3)
    found = 0
    for side in (1, -1):
        before = len(slides)
        want = cnv_mod._window_scan(blocks, depth, mq, gc, nwin, low_acgt,
                                    sd, thr[side], win_std, CFG, L, side)
        host_slides = len(slides) - before
        flags, _ = cnv_device.seed_inputs(depth, mq, gc, low_acgt,
                                          thr[side], CFG, L, side)
        cands = [cnv_device.walk_candidates(flags, bs, be - MINW)
                 for bs, be in blocks]
        del launched[:]
        got = cnv_device.window_scan(blocks, depth, mq, gc, nwin, low_acgt,
                                     sd, thr[side], win_std, CFG, L, side,
                                     "cpu")
        assert _bits(got) == _bits(want), side
        found += len(got)
        if case == "small_batches":
            # both classes' batches rolled over mid-walk
            assert launched.count(0) > 1 and launched.count(1) > 1
        if case == "candidate_at_end":
            assert cands[0][-1] == blocks[0][1] - MINW - 1
        if case == "no_candidate":
            assert len(cands[0]) == 0 and len(cands[1]) > 0
        if case == "classes":
            assert (15_000 if side > 0 else 24_000) in \
                [c.start for c in got]
        if case == "slide":
            # the walk ran the slide phase wherever the host walk did
            assert len(slides) - before == 2 * host_slides > 0
    assert found > 0 or case == "walk_inputs"


def test_walk_counts_on_span(monkeypatch):
    """The ``cnv.winscan_dev`` span of a traced ``detect_del_dup`` (the
    device stage on the CPU, on ds200k) carries the walk's counts."""
    from grom_tpu_torch.utils import timing
    from test_torch_cnv_kernels import _cnv_inputs

    chrom, arr, cfg, drv = _cnv_inputs("ds200k")
    launches = []
    seed_eval = cnv_device.seed_eval
    monkeypatch.setattr(cnv_device, "seed_eval",
                        lambda *a: launches.append(1) or seed_eval(*a))
    monkeypatch.setenv("GROM_TPU_DEVICE_CNV", "1")
    monkeypatch.setattr(timing, "_enabled", True)
    timing.reset()
    try:
        feats = cnv_mod.preprocess_reference(chrom, drv.insert_mean,
                                             cfg.min_repeat)
        prep = cnv_mod.prep_cnv(chrom, feats, arr.rd_hi, arr.rd_lo,
                                arr.rd_mq, cfg, drv)
        dels, dups = cnv_mod.detect_del_dup(
            chrom, feats, prep, arr.rd_hi, arr.rd_lo, cfg, drv, cfg.ploidy,
            engine="host", device="cpu")
        (span,) = [e for e in timing.events()
                   if e["label"] == "cnv.winscan_dev"]
    finally:
        timing.reset()
    a = span["attrs"]
    assert set(cnv_device.WALK_COUNTS) <= set(a)
    assert a["calls"] == len(dels) + len(dups) > 0
    assert a["batches"] == len(launches) > 0
    # one block a side, each walked to its end
    assert a["resumes"] == a["batches"] + a["calls"] + 2
    assert 0 < 1000 * a["resumes"] < a["bases"] < 2 * len(chrom)


def test_walk_library_without_cc_raises(monkeypatch, tmp_path):
    """No ``cc`` on PATH: building the walk's library raises, naming its
    source (no fallback to another walk)."""
    from grom_tpu_torch import _build
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="csrc/cnv_walk.c"):
        _build.build("cnv_walk")
