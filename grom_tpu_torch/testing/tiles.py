"""Seeded tiles that stress the tile kernel's read-name dedup and its
window edges, as ``TileInputs`` arrays (numpy, runtime sizes, spans in
``SpanIndex`` order): ``tests/test_torch_tile_kernel.py`` feeds them to
grom_tpu's ``tile_kernel_core`` and to the port's plain version, and
``chip_smoke.py`` holds the CUDA kernel to the plain version on them."""

from __future__ import annotations

import numpy as np

READ_LEN = 100
# kernel parameters of these tiles (f32 screen ratio 0.2)
PARAMS = dict(min_ratio=0.2, min_mapq=20, min_bq=20, min_snv=3,
              name_len_cap=50)


def spike_tile(seed: int = 0, mismatches: bool = True):
    """A 3,000-base tile: a coverage spike of about 3,000 reads over three
    positions at the end of the kernel's first 512-base window (so that
    window's high-quality mismatches overflow its on-chip list), smaller
    piles over the window edges at 1,023-1,024 and at 1,800, background
    reads, 40 read names (four of them long) shared by many reads, reads
    with two spans, IUPAC and N reference bytes, low-quality and
    ineligible reads, both strands, gate zeros. ``mismatches=False``: every
    read base equals the uppercased reference, so no event is a mismatch.
    Returns (arrays, n_mismatch_positions) where ``arrays`` maps the
    ``TileInputs`` field names to numpy arrays."""
    rng = np.random.default_rng(seed)
    L = 3000
    acgt = np.frombuffer(b"ACGT", np.uint8)
    ref = rng.choice(acgt, L)
    ref[40:44] = np.frombuffer(b"RYNn", np.uint8)
    ref[2200:2210] = ord("N")
    soft = rng.choice(L, 300, replace=False)
    soft = soft[ref[soft] < 97]
    ref[soft] += 32                                      # soft-masked
    up = np.where(ref >= 97, ref - 32, ref).astype(np.uint8)
    piles = [((509, 510, 511), 3000), ((1023, 1024), 300), ((1800,), 150)]
    starts, hots = [], []
    for pos, n in piles:
        lo, hi = min(pos) - READ_LEN + 1, max(pos)
        starts.append(rng.integers(lo, hi + 1, n))
        hots.extend(pos)
    starts.append(rng.integers(-50, L - 20, 400))       # background
    starts = np.clip(np.concatenate(starts), 0, L - 20)
    R = len(starts)
    names = rng.integers(0, 40, R).astype(np.int32)
    name_len = np.where(names >= 36, 60, 20).astype(np.uint8)
    lseq = np.full(R, READ_LEN, np.int32)
    seq_off = (np.arange(R, dtype=np.int64) * READ_LEN)
    seq = np.empty(R * READ_LEN, np.uint8)
    qual = rng.integers(5, 41, R * READ_LEN).astype(np.uint8)
    spans = []
    for r in range(R):
        s0 = int(starts[r])
        n = min(READ_LEN, L - s0)
        if r % 9 == 4 and n == READ_LEN:
            # a 5-base deletion: two spans of one read
            spans.append((r, s0, 0, 40))
            spans.append((r, s0 + 45, 40, n - 45))
            cover = np.concatenate([np.arange(s0, s0 + 40),
                                    np.arange(s0 + 45, s0 + n)])
        else:
            spans.append((r, s0, 0, n))
            cover = np.arange(s0, s0 + n)
        read = np.full(READ_LEN, ord("A"), np.uint8)
        read[:len(cover)] = up[cover]
        if mismatches:
            err = rng.random(len(cover)) < 0.01
            read[:len(cover)][err] = rng.choice(acgt, int(err.sum()))
            read[:len(cover)][rng.random(len(cover)) < 0.003] = ord("N")
            for h in hots:
                j = np.flatnonzero(cover == h)
                if len(j) and rng.random() < 0.8:
                    alt = ord("T") if up[h] != ord("T") else ord("G")
                    read[j[0]] = alt + 32 * (rng.random() < 0.2)
        seq[r * READ_LEN:(r + 1) * READ_LEN] = read
    sp = np.array(spans, np.int64)
    sp = sp[np.argsort(sp[:, 1], kind="stable")]
    cum = np.zeros(len(sp) + 1, np.int64)
    np.cumsum(sp[:, 3], out=cum[1:])
    gate = (rng.random(L) < 0.9).astype(np.uint8)
    gate[np.asarray(hots)] = 1
    arrays = dict(
        span_read=sp[:, 0], span_ref=sp[:, 1], span_off=sp[:, 2], cum=cum,
        elig=(rng.random(R) < 0.95).astype(np.uint8),
        mapq=rng.choice(np.array([0, 10, 30, 60], np.uint8), R),
        flag=np.where(rng.random(R) < 0.5, 16, 0).astype(np.int32),
        lseq=lseq, seq_off=seq_off, name_id=names, name_len=name_len,
        seq=seq, qual=qual, chrom_up=up, is_n=up == ord("N"), gate=gate)
    return arrays, len(hots)
