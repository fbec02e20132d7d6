"""RawReads → dense per-read/per-base numpy arrays for the scan engine.

This is the host-side "tensorization" stage: everything branchy about a BAM
record (CIGAR walking, flag logic, duplicate keys, split-read tags) is
resolved here into flat arrays; the device kernels downstream only see dense
scatter/segment operations.

Mirrors the per-read preprocessing of the reference scan loop:
  * clip/indel adjustments  (src/GROM.c:7067-7105)
  * orientation-based svtype classes (src/GROM.c:6435-6542)
  * inline duplicate filtering for -M (src/GROM.c:6546-6586)
  * aligned M-span extraction for depth lists (src/GROM.c:6605-6664) and the
    SNV tally (src/GROM.c:6757-6984)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from grom_tpu_torch.ingest.bam import (CDEL, CDIFF, CEQUAL, CHARD_CLIP, CINS, CMATCH,
                                 CREF_SKIP, CSOFT_CLIP, FDUP, FMREVERSE,
                                 FMUNMAP, FPAIRED, FREVERSE, FUNMAP, RawReads)

# svtype classes (orientation-only; reference defines at src/GROM.c:641-656)
SV_NONE = -1
SV_DEL, SV_DUP, SV_INS, SV_INV = 0, 1, 2, 3
SV_INDEL_INS, SV_INDEL_DEL, SV_CTX_F, SV_CTX_R, SV_INV_F, SV_INV_R, SV_SNV = 4, 5, 6, 7, 8, 9, 10
SV_CTX_FF, SV_CTX_FR, SV_CTX_RF, SV_CTX_RR = 11, 12, 13, 14

_BASE_CODE = np.full(256, -1, dtype=np.int8)
for i, ch in enumerate(b"ACGT"):
    _BASE_CODE[ch] = i
    _BASE_CODE[ch | 0x20] = i


@dataclass
class ReadBatch:
    """Per-read derived fields (all numpy, length R)."""

    pos: np.ndarray
    mapq: np.ndarray
    flag: np.ndarray
    mchr: np.ndarray
    mpos: np.ndarray
    tlen: np.ndarray
    lseq: np.ndarray
    start_adj: np.ndarray       # leading S/H clip length
    end_adj: np.ndarray         # trailing S/H clip length
    end_adj_indel: np.ndarray   # sum(I) - sum(D) over the cigar
    svtype: np.ndarray          # orientation class (rmdup key)
    keep: np.ndarray            # bool: not FUNMAP/FDUP (+ rmdup survivor)
    add: np.ndarray             # evidence weight: add_factor if mq>=min else 0
    # ragged M-span table (flat, with read ids)
    span_read: np.ndarray       # int32 read index per M span
    span_ref: np.ndarray        # int32 ref start of span
    span_readoff: np.ndarray    # int32 read-base offset (cdp_snv_base at span start)
    span_len: np.ndarray        # int32 span length
    reads: RawReads = None      # backing store (seq/qual/names access)
    has_ins: Optional[np.ndarray] = None  # uint8 [R]: any I op in the cigar


def classify_svtype(flag: np.ndarray, chr_eq_mchr: np.ndarray,
                    pos: np.ndarray, mpos: np.ndarray) -> np.ndarray:
    """Orientation/mate-based class (src/GROM.c:6435-6542). Only defined for
    paired reads with mapped mates; SV_NONE otherwise."""
    rev = (flag & FREVERSE) != 0
    mrev = (flag & FMREVERSE) != 0
    paired = (flag & FPAIRED) != 0
    munmap = (flag & FMUNMAP) != 0
    considered = paired & ~munmap
    out = np.full(len(flag), SV_NONE, dtype=np.int8)

    same = considered & chr_eq_mchr
    after = mpos > pos
    # mate after: F/R→DEL, F/F→INV_F, R/R→INV_R, R/F→DUP
    out[same & after & ~rev & mrev] = SV_DEL
    out[same & after & ~rev & ~mrev] = SV_INV_F
    out[same & after & rev & mrev] = SV_INV_R
    out[same & after & rev & ~mrev] = SV_DUP
    # mate before (or equal): R/F→DEL, F/F→INV_F, F/R→DUP, R/R→INV_R
    out[same & ~after & rev & ~mrev] = SV_DEL
    out[same & ~after & ~rev & ~mrev] = SV_INV_F
    out[same & ~after & ~rev & mrev] = SV_DUP
    out[same & ~after & rev & mrev] = SV_INV_R
    # different chromosome
    diff = considered & ~chr_eq_mchr
    out[diff & ~rev & ~mrev] = SV_CTX_FF
    out[diff & ~rev & mrev] = SV_CTX_FR
    out[diff & rev & ~mrev] = SV_CTX_RF
    out[diff & rev & mrev] = SV_CTX_RR
    return out


def rmdup_mask(pos, mpos, mchr, lseq, tlen, mapq, svtype, min_mapq: int,
               list_len: int = 10000) -> np.ndarray:
    """Inline duplicate filter (-M), exact reference semantics
    (src/GROM.c:6546-6586): among svtype-classified reads at the same pos
    (consecutive in coordinate order), a read is dropped iff a previously kept
    read at this pos has identical (mpos, mchr, lseq, tlen, svtype) AND the
    current read has mapq >= min_mapq. Returns True = keep."""
    R = len(pos)
    keep = np.ones(R, dtype=bool)
    seen: List[Tuple] = []
    cur_pos = None
    for i in range(R):
        if svtype[i] < 0:
            continue
        if pos[i] != cur_pos:
            seen = []
            cur_pos = pos[i]
        key = (mpos[i], mchr[i], lseq[i], tlen[i], svtype[i])
        if mapq[i] >= min_mapq and key in seen:
            keep[i] = False
            continue
        if len(seen) < list_len:
            seen.append(key)
    return keep


def _build_batch_native(reads: RawReads, keep: np.ndarray):
    """One-pass C cigar walk (native/grom_native.c gn_batch_build): fills
    the clip/indel adjustments and the exact-size M-span table without the
    numpy path's ~10 per-op temporaries. Returns None without the lib."""
    from grom_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "gn_batch_build"):
        return None
    import ctypes
    v = ctypes.c_void_p
    R = len(reads)
    cig = np.ascontiguousarray(reads.cigar, np.uint32)
    coff = np.ascontiguousarray(reads.cigar_off, np.int64)
    pos32 = np.ascontiguousarray(reads.pos, np.int32)
    keep8 = np.ascontiguousarray(keep, np.uint8)
    ns = int(lib.gn_batch_count_spans(cig.ctypes.data_as(v),
                                      coff.ctypes.data_as(v),
                                      keep8.ctypes.data_as(v),
                                      ctypes.c_long(R)))
    start_adj = np.empty(R, np.int64)
    end_adj = np.empty(R, np.int64)
    end_adj_indel = np.empty(R, np.int64)
    span_read = np.empty(ns, np.int32)
    span_ref = np.empty(ns, np.int64)
    span_readoff = np.empty(ns, np.int64)
    span_len = np.empty(ns, np.int64)
    has_ins = np.empty(R, np.uint8)
    got = int(lib.gn_batch_build(
        cig.ctypes.data_as(v), coff.ctypes.data_as(v),
        pos32.ctypes.data_as(v), keep8.ctypes.data_as(v), ctypes.c_long(R),
        start_adj.ctypes.data_as(v), end_adj.ctypes.data_as(v),
        end_adj_indel.ctypes.data_as(v), span_read.ctypes.data_as(v),
        span_ref.ctypes.data_as(v), span_readoff.ctypes.data_as(v),
        span_len.ctypes.data_as(v), has_ins.ctypes.data_as(v)))
    if got != ns:
        return None
    return start_adj, end_adj, end_adj_indel, (span_read, span_ref,
                                               span_readoff, span_len), \
        has_ins


def build_batch(reads: RawReads, refid: int, min_mapq: int = 20,
                add_factor: int = 6, rmdup: bool = False) -> ReadBatch:
    R = len(reads)
    flag = reads.flag.astype(np.int32)
    pos = reads.pos.astype(np.int64)

    chr_eq = reads.mrefid == refid
    svtype = classify_svtype(flag, chr_eq, reads.pos, reads.mpos)
    keep = ((flag & FUNMAP) == 0) & ((flag & FDUP) == 0)
    if rmdup:
        keep &= rmdup_mask(reads.pos, reads.mpos, reads.mrefid, reads.lseq,
                           reads.tlen, reads.mapq, svtype, min_mapq)
    add = np.where(reads.mapq >= min_mapq, add_factor, 0).astype(np.int32)

    native = _build_batch_native(reads, keep)
    if native is not None:
        start_adj, end_adj, end_adj_indel, spans, has_ins = native
        span_read, span_ref, span_readoff, span_len = spans
        return ReadBatch(
            pos=pos, mapq=reads.mapq.astype(np.int32), flag=flag,
            mchr=reads.mrefid.astype(np.int32),
            mpos=reads.mpos.astype(np.int64),
            tlen=reads.tlen.astype(np.int64), lseq=reads.lseq.astype(np.int64),
            start_adj=start_adj, end_adj=end_adj,
            end_adj_indel=end_adj_indel, svtype=svtype, keep=keep, add=add,
            span_read=span_read, span_ref=span_ref,
            span_readoff=span_readoff, span_len=span_len, reads=reads,
            has_ins=has_ins,
        )

    # vectorized cigar walk: per-op advances
    cig = reads.cigar
    ops = (cig & 0xF).astype(np.int8)
    lens = (cig >> 4).astype(np.int64)
    n_ops = np.diff(reads.cigar_off)
    op_read = np.repeat(np.arange(R), n_ops)

    is_m = (ops == CMATCH) | (ops == CEQUAL) | (ops == CDIFF)
    is_ins = ops == CINS
    is_del = ops == CDEL
    is_skip = ops == CREF_SKIP
    is_soft = ops == CSOFT_CLIP
    is_hard = ops == CHARD_CLIP

    # ref advance: M/D/N; read advance (cdp_snv_base): M/I/S
    ref_adv = np.where(is_m | is_del | is_skip, lens, 0)
    read_adv = np.where(is_m | is_ins | is_soft, lens, 0)

    # segmented exclusive cumsums per read
    def seg_excl_cumsum(vals):
        c = np.cumsum(vals)
        starts = reads.cigar_off[:-1]
        base = np.zeros(len(vals), dtype=np.int64)
        # value at op j = total before j within its read
        excl = np.concatenate([[0], c[:-1]])
        per_read_base = np.where(starts > 0, c[starts - 1], 0)
        return excl - np.repeat(per_read_base, n_ops)

    ref_off = seg_excl_cumsum(ref_adv)
    read_off = seg_excl_cumsum(read_adv)

    # clip adjustments
    start_adj = np.zeros(R, dtype=np.int64)
    end_adj = np.zeros(R, dtype=np.int64)
    first_op_idx = reads.cigar_off[:-1]
    last_op_idx = reads.cigar_off[1:] - 1
    has_cigar = n_ops > 0
    hc = np.flatnonzero(has_cigar)
    f_idx = first_op_idx[hc]
    l_idx = last_op_idx[hc]
    fmask = is_soft[f_idx] | is_hard[f_idx]
    lmask = is_soft[l_idx] | is_hard[l_idx]
    start_adj[hc[fmask]] = lens[f_idx[fmask]]
    end_adj[hc[lmask]] = lens[l_idx[lmask]]
    end_adj_indel = np.zeros(R, dtype=np.int64)
    np.add.at(end_adj_indel, op_read[is_ins], lens[is_ins])
    np.subtract.at(end_adj_indel, op_read[is_del], lens[is_del])

    # M spans of kept reads
    m_idx = np.flatnonzero(is_m & keep[op_read])
    span_read = op_read[m_idx].astype(np.int32)
    span_ref = (pos[span_read] + ref_off[m_idx]).astype(np.int64)
    span_readoff = read_off[m_idx].astype(np.int64)
    span_len = lens[m_idx].astype(np.int64)

    return ReadBatch(
        pos=pos, mapq=reads.mapq.astype(np.int32), flag=flag,
        mchr=reads.mrefid.astype(np.int32), mpos=reads.mpos.astype(np.int64),
        tlen=reads.tlen.astype(np.int64), lseq=reads.lseq.astype(np.int64),
        start_adj=start_adj, end_adj=end_adj, end_adj_indel=end_adj_indel,
        svtype=svtype, keep=keep, add=add,
        span_read=span_read, span_ref=span_ref, span_readoff=span_readoff,
        span_len=span_len, reads=reads,
    )


def expand_spans(batch: ReadBatch) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Expand M spans into per-base (read_idx, ref_pos, read_base_idx) arrays
    (all int32, one entry per aligned base, in record/cigar order).

    Uses segment-id cumsum + sequential gathers instead of np.repeat — the
    repeat path pays per-segment overhead on millions of short spans."""
    return expand_span_range(batch, 0, len(batch.span_len))


def expand_span_range(batch: ReadBatch, lo: int, hi: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """expand_spans restricted to spans [lo, hi) — the chunked form used to
    bound event-array memory on long chromosomes."""
    lens = batch.span_len[lo:hi].astype(np.int64)
    total = int(lens.sum())
    nspan = len(lens)
    if total == 0 or nspan == 0:
        z = np.empty(0, np.int32)
        return z, z.copy(), z.copy()
    starts = np.zeros(nspan, np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    segd = np.zeros(total, np.int32)
    segd[starts[1:]] = 1
    seg = np.cumsum(segd, dtype=np.int32)          # span id per base
    rid = batch.span_read[lo:hi].astype(np.int32)[seg]
    within = np.arange(total, dtype=np.int32) - starts.astype(np.int32)[seg]
    refpos = batch.span_ref[lo:hi].astype(np.int32)[seg] + within
    readidx = batch.span_readoff[lo:hi].astype(np.int32)[seg] + within
    return rid, refpos, readidx
