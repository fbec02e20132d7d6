"""The caf_rd_* depth kernels of the port (grom_tpu_torch/ops/rd_depth.py:
K5 ``rd_scatter`` and K6 ``rd_scan``) against grom_tpu's ``MeshAccumulator``
under CPU jax, on the same inputs, and against the host engine's
``_accumulate_rd_lists`` and ``np.bincount``. Tolerance: rd_mq, rd_hi,
rd_lo and the histogram exactly equal (all int32).

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
from grom_tpu_torch.ops.state import cell_deltas
from grom_tpu_torch.parallel.pipeline import endpoint_deltas

DATA = os.path.join(os.path.dirname(__file__), "data")

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core would oversubscribe the host
torch.set_num_threads(1)


def _depth_by_cells(batch, eligible, min_mapq, L, seg_l):
    """The depth lists and histogram through K5 and K6, cell by cell, with
    the carry as the exclusive prefix of the cell totals."""
    deltas = endpoint_deltas(batch, eligible, min_mapq, L, 0, L)
    rd = np.zeros((3, L), np.int32)
    hist = np.zeros(rd_depth.HIST_BINS, np.int64)
    base = torch.zeros(3, dtype=torch.int32)
    for t0 in range(0, L, seg_l):
        t1 = min(t0 + seg_l, L)
        delta, tot = rd_depth.rd_scatter(*cell_deltas(*deltas, t0, t1, "cpu"),
                                         seg_l)
        assert delta.dtype == tot.dtype == torch.int32
        assert torch.equal(tot, delta.sum(1, dtype=torch.int32))
        r, h = rd_depth.rd_scan(delta, base, t1 - t0)
        assert r.shape == (3, seg_l) and h.dtype == torch.int32
        rd[:, t0:t1] = r[:, :t1 - t0].numpy()
        hist += h.numpy()
        base = base + tot
    return rd, hist


def _host_lists(batch, eligible, cfg, L):
    arr = SimpleNamespace(rd_mq=np.zeros(L, np.int32),
                          rd_hi=np.zeros(L, np.int32),
                          rd_lo=np.zeros(L, np.int32), chr_len=L)
    scan_mod._accumulate_rd_lists(arr, batch, eligible, cfg)
    return np.stack([arr.rd_mq, arr.rd_hi, arr.rd_lo])


def _jax_mesh(chrom, batch, eligible, cfg, gate, shape, seg_l):
    import jax

    from grom_tpu.parallel.mesh import make_mesh
    from grom_tpu.parallel.pipeline import MeshAccumulator
    acc = MeshAccumulator(mesh=make_mesh(*shape, devices=jax.devices("cpu")),
                          seg_l=seg_l)
    res = acc.run(chrom, batch, eligible, cfg, gate)
    assert res is not None
    return res


def _check(chrom, batch, eligible, cfg, gate, seg_l):
    L = len(chrom)
    got_rd, got_hist = _depth_by_cells(batch, eligible, cfg.min_mapq, L,
                                       seg_l)
    _, _, want_rd, want_hist = _jax_mesh(chrom, batch, eligible, cfg, gate,
                                         (2, 2), seg_l)
    assert np.array_equal(got_rd, np.stack(want_rd))
    assert np.array_equal(got_hist, want_hist)
    host = _host_lists(batch, eligible, cfg, L)
    assert np.array_equal(got_rd, host)
    assert np.array_equal(got_hist, np.bincount(
        np.clip(host[1], 0, rd_depth.HIST_BINS - 1),
        minlength=rd_depth.HIST_BINS))
    return got_rd


def test_rd_kernels_match_jax_mesh_ds200k():
    """ds200k in 2^14-base cells on a 2x2 mesh: 13 cells, so four launches
    and a short last one."""
    from grom_tpu_torch.testing.fixtures import chrom_inputs
    ci = chrom_inputs(os.path.join(DATA, "ds200k"))
    rd = _check(ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate, 1 << 14)
    assert rd[1].max() > 10 and rd[2].max() > 0


def synthetic_batch(seed=0):
    """Five reads on a 5000-base chromosome, one M-span each, cut so that
    with 1024-base cells the cells [1024, 2048) and [4096, 5000) hold end
    deltas of spans that end exactly at their first position, and the
    first of them holds no span at all. The last read fails the whole-span
    rule (ref + len == L) and adds no depth."""
    rng = np.random.default_rng(seed)
    L = 5000
    #           ref   len  mapq
    spans = [(100, 924, 60), (900, 124, 5), (2500, 100, 60),
             (3000, 1096, 30), (4990, 10, 60)]
    R = len(spans)
    lens = np.array([s[1] for s in spans], np.int32)
    seq_off = np.zeros(R + 1, np.int64)
    np.cumsum(lens, out=seq_off[1:])
    Q = int(seq_off[-1])
    reads = SimpleNamespace(
        mapq=np.array([s[2] for s in spans], np.uint8),
        flag=np.array([0, 16, 0, 16, 0], np.int32),
        lseq=lens.copy(), seq_off=seq_off,
        seq=np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, Q)].copy(),
        qual=np.full(Q, 30, np.uint8),
        name_id=np.arange(R, dtype=np.int32),
        name_len=np.full(R, 12, np.uint8))
    batch = SimpleNamespace(
        reads=reads, mapq=reads.mapq,
        span_read=np.arange(R, dtype=np.int32),
        span_ref=np.array([s[0] for s in spans], np.int32),
        span_len=lens.copy(), span_readoff=np.zeros(R, np.int32))
    chrom = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, L)].copy()
    eligible = np.ones(R, bool)
    gate = np.ones(L, np.int64)
    return chrom, batch, eligible, gate


def test_rd_kernels_cell_with_deltas_but_no_spans():
    chrom, batch, eligible, gate = synthetic_batch()
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    rd = _check(chrom, batch, eligible, cfg, gate, 1024)
    # the depth falls to 0 at the cell edge where the first spans end
    assert rd[0, 1023] == 65 and rd[0, 1024] == 0
    assert rd[1, 4095] == 1 and rd[1, 4096] == 0 and not rd[:, 4990:].any()


def test_rd_kernels_reject_other_devices():
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        rd_depth.rd_scatter(pos, pos, pos.to(torch.int8),
                            pos.to(torch.int8), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n,npos,D", [(1 << 18, 1 << 18, 600_000),
                                      (1 << 14, 9_000, 5_000), (5, 3, 0)])
def test_rd_kernels_cuda_match_plain(n, npos, D):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(n + D)
    pos = np.sort(rng.integers(0, npos, D)).astype(np.int32)
    mq = rng.integers(-60, 61, D).astype(np.int32)
    hi = rng.integers(-1, 2, D).astype(np.int8)
    lo = rng.integers(-1, 2, D).astype(np.int8)
    base = torch.tensor([500, 40, 3], dtype=torch.int32)
    ins = [torch.from_numpy(a) for a in (pos, mq, hi, lo)]
    want_d, want_t = rd_depth.rd_scatter(*ins, n)
    want_rd, want_h = rd_depth.rd_scan(want_d, base, npos)
    got_d, got_t = rd_depth.rd_scatter(*(x.cuda() for x in ins), n)
    got_rd, got_h = rd_depth.rd_scan(got_d, base.cuda(), npos)
    torch.cuda.synchronize()
    for g, w in ((got_d, want_d), (got_t, want_t), (got_rd, want_rd),
                 (got_h, want_h)):
        assert torch.equal(g.cpu(), w)
