"""Seeded span batches for the depth-list kernels (ops/rd_depth.py K5
``rd_scatter`` and K6 ``rd_scan``): ``tests/test_torch_rd_depth.py`` and
``tests/test_torch_mesh.py`` hold the port to grom_tpu and the host engine
on them, and ``chip_smoke.py`` holds the CUDA kernels to their plain
versions on them."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

EDGE_L = 5000
# (lo, hi) of a chunked run of the edge batch: the span [3000, 4096) ends
# at hi, and the spans before 1000 are clipped at lo
EDGE_RANGE = (1000, 4096)


def edge_batch(seed: int = 0):
    """Five reads on a 5000-base chromosome, one M-span each, cut so that
    with 1024-base cells the cells [1024, 2048) and [4096, 5000) hold end
    deltas of spans that end exactly at their first position, and the
    first of them holds no span at all. The last read fails the whole-span
    rule (ref + len == L) and adds no depth. Returns (chrom, batch,
    eligible, gate)."""
    rng = np.random.default_rng(seed)
    L = EDGE_L
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


def random_spans(S: int, R: int, L: int, seed: int = 0):
    """(batch, eligible) of ``S`` spans of ``R`` reads on an ``L``-base
    chromosome, in no order: starts from -200 to L + 50 (so some fail the
    whole-span rule at either end), lengths 0-300, mapq 0-60, about one
    read in ten ineligible. ``batch`` has the span and mapq fields K5
    reads."""
    rng = np.random.default_rng(seed)
    batch = SimpleNamespace(
        span_ref=rng.integers(-200, L + 50, S).astype(np.int64),
        span_len=rng.integers(0, 301, S).astype(np.int64),
        span_read=rng.integers(0, max(R, 1), S).astype(np.int32),
        mapq=rng.integers(0, 61, R).astype(np.int32))
    return batch, rng.random(R) > 0.1
