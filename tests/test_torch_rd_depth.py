"""The caf_rd_* depth kernels of the port (grom_tpu_torch/ops/rd_depth.py:
K5 ``rd_scatter`` from the run's spans and K6 ``rd_scan``) against
grom_tpu's ``MeshAccumulator`` under CPU jax, on the same inputs, against
the host engine's ``_accumulate_rd_lists`` and ``np.bincount``, and K5's
rows, totals and chunk sums against the host endpoint deltas
(``endpoint_deltas`` sorted, cut per cell by ``cell_deltas``) scattered
with numpy. Tolerance: every output exactly equal (all int32).

On the CPU the wrappers run ``rd_scatter_plain`` and ``rd_scan_plain``; the
CUDA kernels are held to the same plain versions on the card (chip_smoke.py
and the ``cuda``-marked test below)."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from grom_tpu.call import scan as scan_mod
from grom_tpu_torch.config import GromConfig
from grom_tpu_torch.ops import rd_depth
from grom_tpu_torch.ops.rd_depth import CHUNK, n_chunks
from grom_tpu_torch.ops.state import cell_deltas, span_inputs
from grom_tpu_torch.parallel.pipeline import endpoint_deltas
from grom_tpu_torch.testing.spans import (EDGE_RANGE, edge_batch,
                                          random_spans)

DATA = os.path.join(os.path.dirname(__file__), "data")

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core would oversubscribe the host
torch.set_num_threads(1)


def _k5_reference(batch, eligible, min_mapq, L, lo, hi, seg_l, slot_of, g0,
                  ng):
    """K5's outputs of launches [g0, g0 + ng) from the host reference: the
    sorted endpoint deltas, each owned cell's slice, added with numpy."""
    n_launch = len(slot_of)
    n_dev = int((np.asarray(slot_of) >= 0).sum())
    deltas = endpoint_deltas(batch, eligible, min_mapq, L, lo, hi)
    rows = np.zeros((ng * n_dev, 3, seg_l), np.int64)
    for r in range(g0, g0 + ng):
        for j, s in enumerate(slot_of):
            t0 = lo + (r * n_launch + j) * seg_l
            if s < 0 or t0 >= hi:
                continue
            cell = cell_deltas(*deltas, t0, min(t0 + seg_l, hi), "cpu")
            pos = cell[0].numpy()
            for ch, w in enumerate(cell[1:]):
                np.add.at(rows[(r - g0) * n_dev + s, ch], pos,
                          w.numpy().astype(np.int64))
    pad = np.zeros(rows.shape[:2] + (n_chunks(seg_l) * CHUNK,), np.int64)
    pad[..., :seg_l] = rows
    csum = pad.reshape(rows.shape[:2] + (n_chunks(seg_l), CHUNK)).sum(-1)
    return (rows.astype(np.int32), rows.sum(-1).astype(np.int32),
            csum.astype(np.int32))


def _scatter(spans, slot_of, lo, hi, L, min_mapq, seg_l, g0, ng):
    n_dev = int((slot_of >= 0).sum())
    return rd_depth.rd_scatter(
        spans, slot_of, lo, hi, L, min_mapq, seg_l, g0, ng,
        *rd_depth.scatter_outputs(ng * n_dev, seg_l, spans.ref.device))


def _depth(batch, eligible, min_mapq, L, seg_l, lo=0, hi=0, n_launch=1,
           per_group=None):
    """The depth lists [3, L] and histogram through K5 (once per group of
    ``per_group`` launches, each held to ``_k5_reference``) and K6 once per
    cell, with ``n_launch`` cells a launch, all of them on this device."""
    hi = hi or L
    n_cells = -(-(hi - lo) // seg_l)
    n_launches = -(-n_cells // n_launch)
    per_group = per_group or n_launches
    spans = span_inputs(batch, eligible, "cpu")
    slot_of = torch.arange(n_launch, dtype=torch.int32)
    i32 = torch.int32
    rd = np.zeros((3, L), np.int32)
    hist = torch.zeros(rd_depth.HIST_BINS, dtype=i32)
    carry = torch.zeros((n_launches + 1, 3), dtype=i32)
    out = torch.empty((3, seg_l), dtype=i32)
    for g0 in range(0, n_launches, per_group):
        ng = min(per_group, n_launches - g0)
        rows, tot, csum = _scatter(spans, slot_of, lo, hi, L, min_mapq,
                                   seg_l, g0, ng)
        want = _k5_reference(batch, eligible, min_mapq, L, lo, hi, seg_l,
                             slot_of.numpy(), g0, ng)
        for g, w in zip((rows, tot, csum), want):
            assert g.dtype == i32 and np.array_equal(g.numpy(), w)
        for r in range(g0, g0 + ng):
            tot_all = tot[(r - g0) * n_launch:(r - g0 + 1) * n_launch]
            for j in range(n_launch):
                t0 = lo + (r * n_launch + j) * seg_l
                if t0 >= hi:
                    break
                t1 = min(t0 + seg_l, hi)
                slot = (r - g0) * n_launch + j
                last = j == n_launch - 1 or t1 == hi
                res = rd_depth.rd_scan(rows[slot], csum[slot], tot_all, j,
                                       carry[r], t1 - t0, out, hist,
                                       carry[r + 1] if last else None)
                assert res[0] is out and res[1] is hist
                rd[:, t0:t1] = out[:, :t1 - t0].numpy()
    return rd, hist.numpy().astype(np.int64)


def _host_lists(batch, eligible, cfg, L, lo=0, hi=0):
    arr = SimpleNamespace(rd_mq=np.zeros(L, np.int32),
                          rd_hi=np.zeros(L, np.int32),
                          rd_lo=np.zeros(L, np.int32), chr_len=L)
    scan_mod._accumulate_rd_lists(arr, batch, eligible, cfg, lo, hi)
    return np.stack([arr.rd_mq, arr.rd_hi, arr.rd_lo])


def _jax_mesh(chrom, batch, eligible, cfg, gate, shape, seg_l, lo=0, hi=0):
    import jax

    from grom_tpu.parallel.mesh import make_mesh
    from grom_tpu.parallel.pipeline import MeshAccumulator
    acc = MeshAccumulator(mesh=make_mesh(*shape, devices=jax.devices("cpu")),
                          seg_l=seg_l)
    if not hi:
        res = acc.run(chrom, batch, eligible, cfg, gate)
    else:
        L = len(chrom)
        res = acc.run(chrom, batch, eligible, cfg, gate[lo:hi], lo=lo, hi=hi,
                      base_tot_out=np.zeros(hi - lo, np.int64),
                      rd_out=tuple(np.zeros(L, np.int32) for _ in range(3)),
                      gate_base=lo, base_tot_base=lo)
    assert res is not None
    return res


def _check(chrom, batch, eligible, cfg, gate, seg_l, lo=0, hi=0,
           shape=(2, 2), per_group=None):
    L = len(chrom)
    got_rd, got_hist = _depth(batch, eligible, cfg.min_mapq, L, seg_l, lo,
                              hi, shape[0] * shape[1], per_group)
    _, _, want_rd, want_hist = _jax_mesh(chrom, batch, eligible, cfg, gate,
                                         shape, seg_l, lo, hi)
    assert np.array_equal(got_rd, np.stack(want_rd))
    assert np.array_equal(got_hist, want_hist)
    host = _host_lists(batch, eligible, cfg, L, lo, hi)
    assert np.array_equal(got_rd, host)
    assert np.array_equal(got_hist, np.bincount(
        np.clip(host[1, lo:hi or L], 0, rd_depth.HIST_BINS - 1),
        minlength=rd_depth.HIST_BINS))
    return got_rd


@pytest.fixture(scope="module")
def ds200k():
    from grom_tpu_torch.testing.fixtures import chrom_inputs
    return chrom_inputs(os.path.join(DATA, "ds200k"))


def test_rd_kernels_match_jax_mesh_ds200k(ds200k):
    """ds200k in 2^14-base cells on a 2x2 mesh: 13 cells, so four launches
    and a short last one, in one K5 group."""
    ci = ds200k
    rd = _check(ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate, 1 << 14)
    assert rd[1].max() > 10 and rd[2].max() > 0


@pytest.mark.parametrize("per_group", [1, 3])
def test_rd_kernels_groups_match_jax_mesh(ds200k, per_group):
    """The same run in K5 groups of one and of three launches (the last
    group shorter), so the carry crosses group edges."""
    ci = ds200k
    _check(ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate, 1 << 14,
           per_group=per_group)


def test_rd_kernels_chunked_match_jax_mesh(ds200k):
    """A chunk [lo, hi) with lo > 0, as the streamed path calls the mesh:
    spans clipped at both ends, the ends at hi dropped."""
    ci = ds200k
    rd = _check(ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate, 1 << 14,
                lo=61_000, hi=133_000, per_group=2)
    assert not rd[:, :61_000].any() and not rd[:, 133_000:].any()


def test_rd_kernels_cell_with_deltas_but_no_spans():
    chrom, batch, eligible, gate = edge_batch()
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    rd = _check(chrom, batch, eligible, gate=gate, cfg=cfg, seg_l=1024)
    # the depth falls to 0 at the cell edge where the first spans end
    assert rd[0, 1023] == 65 and rd[0, 1024] == 0
    assert rd[1, 4095] == 1 and rd[1, 4096] == 0 and not rd[:, 4990:].any()


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_rd_kernels_edge_batch_chunked(shape):
    """The edge batch over [1000, 4096): a span that ends at hi, spans
    clipped at lo, cells of 1024 bases, K5 groups of one launch."""
    chrom, batch, eligible, gate = edge_batch()
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    lo, hi = EDGE_RANGE
    rd = _check(chrom, batch, eligible, cfg, gate, 1024, lo, hi, shape,
                per_group=1)
    assert rd[1, hi - 1] == 1 and not rd[:, hi:].any()


@pytest.mark.parametrize("slot_of,g0,ng", [
    ([0, -1, 1, -1], 0, 3),      # every other cell on another device
    ([-1, -1, 0, -1], 1, 2),     # one cell a launch, a later group
    ([-1, -1], 0, 1),            # no cell on this device
])
def test_rd_scatter_skips_cells_of_other_devices(slot_of, g0, ng):
    """K5 on spans in no order (some fail the whole-span rule at either
    end, some reads ineligible) adds only into the cells this device owns,
    exactly as the host deltas of those cells."""
    L, lo, hi, seg_l = 30_000, 700, 29_000, 2048
    batch, eligible = random_spans(20_000, 3_000, L, seed=len(slot_of) + g0)
    spans = span_inputs(batch, eligible, "cpu")
    got = _scatter(spans, torch.tensor(slot_of, dtype=torch.int32), lo, hi,
                   L, 20, seg_l, g0, ng)
    want = _k5_reference(batch, eligible, 20, L, lo, hi, seg_l, slot_of, g0,
                         ng)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    if max(slot_of) >= 0:
        assert got[1].abs().sum() > 0


@pytest.mark.parametrize("n,npos,j", [(5003, 4100, 2), (3072, 1000, 0),
                                      (1 << 14, 9_000, 3)])
def test_rd_scan_ragged_width(n, npos, j):
    """K6 alone on a width that is not a multiple of 1024 (nor of 4), with
    npos < n, against numpy: rd = carry + earlier totals + inclusive prefix,
    the histogram of clip(rd_hi[:npos]) added to the given one, and the
    next carry."""
    rng = np.random.default_rng(n + j)
    rows = rng.integers(-3, 4, (3, n)).astype(np.int32)
    tot_all = rng.integers(-50, 50, (4, 3)).astype(np.int32)
    tot_all[j] = rows.sum(1)
    carry_in = np.array([900, 30, 4], np.int32)
    pad = np.zeros((3, n_chunks(n) * CHUNK), np.int32)
    pad[:, :n] = rows
    csum = pad.reshape(3, -1, CHUNK).sum(-1).astype(np.int32)
    hist0 = rng.integers(0, 5, rd_depth.HIST_BINS).astype(np.int32)
    t = torch.from_numpy
    rd = torch.empty((3, n), dtype=torch.int32)
    hist = t(hist0.copy())
    carry_out = torch.zeros(3, dtype=torch.int32)
    got = rd_depth.rd_scan(t(rows), t(csum), t(tot_all), j, t(carry_in),
                           npos, rd, hist, carry_out)
    assert got[0] is rd and got[1] is hist and got[2] is carry_out
    want = carry_in[:, None] + tot_all[:j].sum(0)[:, None] + np.cumsum(
        rows, 1)
    assert np.array_equal(rd.numpy(), want)
    assert np.array_equal(hist.numpy(), hist0 + np.bincount(
        np.clip(want[1, :npos], 0, 255), minlength=rd_depth.HIST_BINS))
    assert np.array_equal(carry_out.numpy(), carry_in + tot_all.sum(0))


def test_rd_kernels_reject_other_devices():
    x = torch.zeros(1, dtype=torch.int32, device="meta")
    spans = rd_depth.Spans(x, x, x, x.to(torch.uint8), x.to(torch.uint8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        rd_depth.rd_scatter(spans, x, 0, 4, 4, 20, 4, 0, 1,
                            *rd_depth.scatter_outputs(1, 4, "meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        rd_depth.rd_scan(x, x, x, 0, x, 1, x, x)


def _cuda_case(n, npos, S):
    """K5 inputs of ``S`` random spans over 4 launches of 2 cells of ``n``
    positions (hi = lo + 7 * n + npos: the last cell ``npos`` wide), this
    device holding cells 0 and 1 of each launch as slots 1 and 0."""
    lo = 300
    hi = lo + 7 * n + npos
    L = hi + 5
    batch, eligible = random_spans(S, max(S // 2, 1), L, seed=n + S)
    slot_of = torch.tensor([1, 0], dtype=torch.int32)
    return batch, eligible, slot_of, (lo, hi, L, 20, n, 0, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,npos,D", [(1 << 18, 1 << 18, 600_000),
                                      (1 << 14, 9_000, 5_000), (5, 3, 0)])
def test_rd_kernels_cuda_match_plain(n, npos, D):
    """On the card: K5 over random spans (``D`` of them) and K6 over every
    cell it filled, each equal to the plain version on CPU copies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    batch, eligible, slot_of, params = _cuda_case(n, npos, D)
    outs = {}
    for dev in ("cpu", "cuda"):
        spans = span_inputs(batch, eligible, dev)
        k5 = _scatter(spans, slot_of.to(dev), *params)
        rows, tot, csum = k5
        i32 = torch.int32
        carry = torch.zeros((5, 3), dtype=i32, device=dev)
        hist = torch.zeros(rd_depth.HIST_BINS, dtype=i32, device=dev)
        rd = torch.zeros((8, 3, n), dtype=i32, device=dev)
        for r in range(4):
            tot_all = torch.stack([tot[2 * r + 1], tot[2 * r]])
            for j in range(2):
                width = npos if (r, j) == (3, 1) else n
                rd_depth.rd_scan(rows[2 * r + 1 - j], csum[2 * r + 1 - j],
                                 tot_all, j, carry[r], width, rd[2 * r + j],
                                 hist, carry[r + 1] if j else None)
        torch.cuda.synchronize()
        outs[dev] = [x.cpu() for x in (rows, tot, csum, rd, hist, carry)]
    for g, w in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(g, w)
    if D:
        assert outs["cpu"][1].abs().sum() > 0
