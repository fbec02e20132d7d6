"""Whole-chromosome evidence accumulation (the dense half of the reference's
streaming scan engine, src/GROM.c:5740-11085, re-expressed as vectorized
array ops over the full chromosome).

The reference slides a ~70-array window one base at a time; because every
deposit/detection is relative to absolute genome coordinates, accumulating
into whole-chromosome arrays is semantically identical (SURVEY §2.7-l2), with
two boundary rules reproduced exactly:

  * scan positions run from ``scan_start = L0/2 + 1`` (the window-index start,
    src/GROM.c:2918) to ``scan_end = max(scan_start, last_record_pos - IM)``
    inclusive (EOF drain, src/GROM.c:6411,14857);
  * reads with pos < scan_start are skipped entirely, but each skipped record
    still advances the window index (src/GROM.c:6406/14859-14861), which
    offsets the depth-filter boundary (see ``window_base_final``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from grom_tpu_torch.config import DerivedConfig, GromConfig
from grom_tpu_torch.ingest.batches import ReadBatch, build_batch, expand_spans
from grom_tpu_torch.ingest.bam import FREVERSE, RawReads

NT = 4
_CODE = np.full(256, -1, dtype=np.int8)
for i, ch in enumerate(b"ACGT"):
    _CODE[ch] = i
    _CODE[ch | 0x20] = i


def window_len_l0(cfg: GromConfig, drv: DerivedConfig) -> int:
    """L0 = overlap_mult*8*max(2*insert_mean-1, insert_max+1)
    (src/GROM.c:22282-22286). The allocated window is 2*L0; shift blocks are
    L0; the index starts at L0/2+1."""
    l0 = cfg.overlap_mult * 8 * (2 * drv.insert_mean - 1)
    alt = cfg.overlap_mult * 8 * (drv.insert_max + 1)
    return max(l0, alt)


def scan_bounds(cfg: GromConfig, drv: DerivedConfig, record_pos: np.ndarray,
                region_start: int = 0):
    """(scan_start, scan_end, n_skipped_records) for a whole-chromosome run.
    ``region_start`` > 0 raises the scan start to region_start - overlap for
    -c sub-region children (src/GROM.c:5730-5731)."""
    l0 = window_len_l0(cfg, drv)
    scan_start = (2 * l0) // 4 + 1
    if region_start > 0:
        scan_start = max(scan_start, region_start - cfg.sub_region_overlap)
    im = cfg.overlap_mult * drv.insert_max
    if len(record_pos):
        scan_end = max(scan_start, int(record_pos[-1]) - im)
        skipped = int(np.searchsorted(record_pos, scan_start, side="left"))
    else:
        scan_end = scan_start - 1  # nothing scanned
        skipped = 0
    return scan_start, scan_end, skipped


def window_base_final(scan_end: int, scan_start: int, l0: int, skipped: int) -> int:
    """The reference's final-flush depth boundary: the value of
    ``scan - one_base_index`` after the loop exits (src/GROM.c:15025).

    index(top of iteration t) = scan_start + t + 1 - shifts*L0, with a shift
    (index -= L0) whenever it reaches 1.5*L0; scan advances only on
    non-skipped iterations, so t = (scan - scan_start) + skipped. After the
    final detection the scan has been incremented once more, giving
    shifts*L0 - skipped.
    """
    t_f = (scan_end - scan_start) + skipped
    raw = scan_start + t_f + 1
    shifts = max(0, (raw - (3 * l0) // 2) // l0 + 1)
    return shifts * l0 - skipped


def window_base_at(scan: int, scan_start: int, l0: int, skipped: int) -> int:
    """Mid-scan depth boundary (value of scan - index during detection at
    ``scan``), used when the SNV candidate list flushes mid-run
    (src/GROM.c:11203)."""
    t = (scan - scan_start) + skipped
    raw = scan_start + t + 1
    shifts = max(0, (raw - (3 * l0) // 2) // l0 + 1)
    return shifts * l0 - skipped - 1


@dataclass
class ChromArrays:
    """Dense whole-chromosome accumulators (the reference's caf_* and the
    SNV-relevant cdp_one_base_* arrays)."""

    chr_len: int
    rd_mq: np.ndarray           # caf_rd_mq_list: Σ mapq per base (int32:
                                # depth*mapq < 2^31 at any plausible pileup)
    rd_hi: np.ndarray           # caf_rd_rd_list: depth of mq>=min reads
    rd_lo: np.ndarray           # caf_rd_low_mq_rd_list
    one_base_rd: np.ndarray     # physical rd over clipped aligned span
    indel_sc_rd: np.ndarray     # indel_sc_left_rd + indel_sc_right_rd
    sc_rd: np.ndarray           # sc_left_rd + sc_right_rd (one_base_sc_rd)
    snv: np.ndarray             # [4, L] high-quality per-nt counts
    snv_lowmq: np.ndarray       # [4, L]
    bq: np.ndarray              # Σ bq (high-quality bases)
    bq_all: np.ndarray
    mq: np.ndarray
    mq_all: np.ndarray
    bq_read_count: np.ndarray
    mq_read_count: np.ndarray
    read_count_all: np.ndarray
    pos_in_read: np.ndarray     # [4, L]
    fstrand: np.ndarray         # [4, L]
    base: int = 0               # absolute position of array index 0 (chunked
                                # streaming mode; whole-chromosome runs: 0)


def accumulate_chromosome(chrom: np.ndarray, batch: ReadBatch,
                          cfg: GromConfig, drv: DerivedConfig,
                          scan_start: int) -> ChromArrays:
    L = len(chrom)
    arr = ChromArrays(
        chr_len=L,
        rd_mq=np.zeros(L, np.int32), rd_hi=np.zeros(L, np.int32),
        rd_lo=np.zeros(L, np.int32), one_base_rd=np.zeros(L, np.int32),
        indel_sc_rd=np.zeros(L, np.int32), sc_rd=np.zeros(L, np.int32),
        snv=np.zeros((NT, L), np.int32), snv_lowmq=np.zeros((NT, L), np.int32),
        bq=np.zeros(L, np.int32), bq_all=np.zeros(L, np.int32),
        mq=np.zeros(L, np.int32), mq_all=np.zeros(L, np.int32),
        bq_read_count=np.zeros(L, np.int32), mq_read_count=np.zeros(L, np.int32),
        read_count_all=np.zeros(L, np.int32),
        pos_in_read=np.zeros((NT, L), np.int32), fstrand=np.zeros((NT, L), np.int32),
    )
    # eligible reads: kept AND pos >= scan_start (reads before the window
    # start are consumed without deposits, src/GROM.c:6406)
    eligible = batch.keep & (batch.pos >= scan_start)

    if _accumulate_native(arr, chrom, batch, eligible, cfg):
        return arr
    _accumulate_rd_lists(arr, batch, eligible, cfg)
    _accumulate_snv(arr, chrom, batch, eligible, cfg)
    # one_base_rd / indel_sc_rd / sc_rd come from the full deposit engine
    # (call/deposits.py) — the driver wires them in.
    return arr


def _accumulate_native(arr: ChromArrays, chrom, batch, eligible, cfg,
                       lo: int = 0, hi: int = 0,
                       finalize: bool = True,
                       span_mask: Optional[np.ndarray] = None) -> bool:
    """Native single-pass tally (native/grom_scan.c). True on success.
    Bit-identical to the Python path by tests/test_native_scan.py.
    ``lo``/``hi`` gate deposits to a position range and ``finalize`` defers
    the rd-list prefix sums — the streaming-session form (chunked feeds of
    overlapping reads into shared arrays). ``arr``'s SNV-family arrays may
    be chunk-local (arr.base > 0; rd_* stay whole-chromosome); ``span_mask``
    pre-subsets the M-span table to the spans intersecting [lo, hi) so
    repeated chunk calls don't re-walk the whole batch."""
    import ctypes

    from grom_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "gn_snv_accumulate"):
        return False
    reads = batch.reads
    R = len(batch.pos)
    if reads.name_id is not None and reads.name_len is not None \
            and len(reads.name_id) == R:
        name_id = reads.name_id
        name_len = reads.name_len
    else:
        names = reads.names
        if not names or len(names) != R:
            return False
        narr = np.asarray(list(names))
        _, name_id = np.unique(narr, return_inverse=True)
        name_id = name_id.astype(np.int32)
        name_len = np.char.str_len(narr).clip(0, 255).astype(np.uint8)

    L = arr.chr_len

    holds = []

    def p(a, dt):
        a = np.ascontiguousarray(a, dt)
        holds.append(a)
        return a.ctypes.data_as(ctypes.c_void_p)

    expect = {"snv": np.int32, "snv_lowmq": np.int32, "bq": np.int32,
              "bq_all": np.int32, "mq": np.int32, "mq_all": np.int32,
              "bq_read_count": np.int32, "mq_read_count": np.int32,
              "read_count_all": np.int32, "pos_in_read": np.int32,
              "fstrand": np.int32, "rd_mq": np.int32, "rd_hi": np.int32,
              "rd_lo": np.int32}
    for f, dt in expect.items():
        if getattr(arr, f).dtype != dt:
            return False    # caller-built arrays with foreign dtypes

    def outp(a):
        return a.ctypes.data_as(ctypes.c_void_p)

    if span_mask is not None:
        span_read = np.ascontiguousarray(batch.span_read[span_mask], np.int32)
        span_ref = np.ascontiguousarray(batch.span_ref[span_mask], np.int64)
        span_roff = np.ascontiguousarray(batch.span_readoff[span_mask],
                                         np.int64)
        span_len = np.ascontiguousarray(batch.span_len[span_mask], np.int64)
    else:
        span_read = np.ascontiguousarray(batch.span_read, np.int32)
        span_ref = np.ascontiguousarray(batch.span_ref, np.int64)
        span_roff = np.ascontiguousarray(batch.span_readoff, np.int64)
        span_len = np.ascontiguousarray(batch.span_len, np.int64)
    common = [
        p(eligible, np.uint8),
        p(batch.mapq, np.int32), p(batch.flag, np.int32),
        p(batch.lseq, np.int64),
        p(reads.seq_off, np.int64), p(reads.seq, np.uint8),
        p(reads.qual, np.uint8),
        p(name_id, np.int32), p(name_len, np.uint8),
        p(chrom, np.uint8),
    ]
    outs = [
        outp(arr.snv), outp(arr.snv_lowmq),
        outp(arr.bq), outp(arr.bq_all), outp(arr.mq), outp(arr.mq_all),
        outp(arr.bq_read_count), outp(arr.mq_read_count),
        outp(arr.read_count_all),
        outp(arr.pos_in_read), outp(arr.fstrand),
        outp(arr.rd_mq), outp(arr.rd_hi), outp(arr.rd_lo)]

    stride = arr.snv.shape[1]

    def call(sr, sf, so, sl, glo, ghi, parts, fin):
        prm = np.array([L, cfg.min_mapq, cfg.min_base_qual, cfg.min_snv, 50,
                        glo, ghi, 1 if fin else 0, parts,
                        arr.base, stride], np.int64)
        return lib.gn_snv_accumulate(
            ctypes.c_long(len(sl)),
            sr.ctypes.data_as(ctypes.c_void_p),
            sf.ctypes.data_as(ctypes.c_void_p),
            so.ctypes.data_as(ctypes.c_void_p),
            sl.ctypes.data_as(ctypes.c_void_p),
            *common, prm.ctypes.data_as(ctypes.c_void_p), *outs)

    n_span = len(span_len)
    glo, ghi = lo, (hi if hi > 0 else L)
    # opt-in: on 2-vCPU (HT-sibling) hosts the scatter loops are shared-
    # bandwidth-bound and the split costs more than it wins (measured
    # 3.2s vs 1.9s); useful on wider hosts
    if (n_span >= 200_000 and os.environ.get("GROM_TPU_SCAN_THREADS") == "1"
            and (os.cpu_count() or 1) >= 2):
        # two position-gated SNV-only workers over disjoint halves (the
        # ctypes call releases the GIL) + one serial rd-list pass (its span
        # diffs straddle the split point). Determinism: each position's
        # events stay in global span order within its owning worker.
        mid = (glo + ghi) // 2
        ma = span_ref < mid
        mb = span_ref + span_len > mid
        import threading
        rcs = [0, 0]

        def run(idx, mask, wlo, whi):
            rcs[idx] = call(span_read[mask], span_ref[mask],
                            span_roff[mask], span_len[mask],
                            wlo, whi, 1, False)

        t = threading.Thread(target=run, args=(1, mb, mid, ghi))
        t.start()
        run(0, ma, glo, mid)
        t.join()
        rc = rcs[0] or rcs[1] or call(span_read, span_ref, span_roff,
                                      span_len, glo, ghi, 2, finalize)
        return rc == 0

    rc = call(span_read, span_ref, span_roff, span_len, lo, hi, 3, finalize)
    return rc == 0


def _accumulate_rd_lists(arr, batch, eligible, cfg, lo: int = 0,
                         hi: int = 0):
    """caf_rd_* per-base lists from M spans (src/GROM.c:6605-6664). A span is
    deposited only when pos>=0 and pos+len < chr_len (strict; evaluated on
    the WHOLE span). ``lo``/``hi`` clip the added range for chunked feeds."""
    sel = eligible[batch.span_read]
    ref = batch.span_ref[sel]
    ln = batch.span_len[sel]
    rid = batch.span_read[sel]
    ok = (ref >= 0) & (ref + ln < arr.chr_len)
    ref, ln, rid = ref[ok], ln[ok], rid[ok]
    mapq = batch.mapq[rid]
    hi_m = mapq >= cfg.min_mapq
    hi_clip = hi if hi > 0 else arr.chr_len
    s_cl = np.maximum(ref, lo)
    e_cl = np.minimum(ref + ln, hi_clip)
    keep = e_cl > s_cl
    s_cl, e_cl, rid, mapq, hi_m = (s_cl[keep], e_cl[keep], rid[keep],
                                   mapq[keep], hi_m[keep])

    def span_add(dst, starts, ends, weights=None):
        d = np.zeros(arr.chr_len + 1, dtype=np.int64)
        if weights is None:
            np.add.at(d, starts, 1)
            np.subtract.at(d, ends, 1)
        else:
            np.add.at(d, starts, weights)
            np.subtract.at(d, ends, weights)
        dst += np.cumsum(d[:-1])

    mq_acc = np.zeros(arr.chr_len, np.int64)
    span_add(mq_acc, s_cl, e_cl, mapq.astype(np.int64))
    arr.rd_mq += mq_acc.astype(arr.rd_mq.dtype)
    hi_acc = np.zeros(arr.chr_len, np.int64)
    span_add(hi_acc, s_cl[hi_m], e_cl[hi_m])
    arr.rd_hi += hi_acc.astype(np.int32)
    lo_acc = np.zeros(arr.chr_len, np.int64)
    span_add(lo_acc, s_cl[~hi_m], e_cl[~hi_m])
    arr.rd_lo += lo_acc.astype(np.int32)




def _accumulate_snv(arr, chrom, batch, eligible, cfg,
                    max_chunk_bases: int = 1_000_000,
                    lo: int = 0, hi: int = 0):
    """Per-base SNV tally (src/GROM.c:6757-6984): quality-split counts with
    read-name dedup on high-quality mismatch bases.

    Processes the M-span stream in chunks of <= max_chunk_bases aligned
    bases so event-array memory stays bounded on long chromosomes (a 250Mb
    chromosome at 30x is ~7.5G events — far too large for one pass). The
    read-name dedup state carries across chunks in record order."""
    lens = batch.span_len.astype(np.int64)
    nspan = len(lens)
    if nspan == 0:
        return
    cum = np.cumsum(lens)
    slots: Dict[int, List[bytes]] = {}
    name_cache: Dict[int, bytes] = {}
    s_lo = 0
    while s_lo < nspan:
        base0 = int(cum[s_lo - 1]) if s_lo else 0
        s_hi = int(np.searchsorted(cum, base0 + max_chunk_bases,
                                   side="left")) + 1
        s_hi = min(max(s_hi, s_lo + 1), nspan)
        _accumulate_snv_chunk(arr, chrom, batch, eligible, cfg, s_lo, s_hi,
                              slots, name_cache, lo, hi)
        s_lo = s_hi


def _accumulate_snv_chunk(arr, chrom, batch, eligible, cfg, span_lo, span_hi,
                          slots, name_cache, p_lo: int = 0, p_hi: int = 0):
    """One span-chunk of the SNV tally. Everything is folded into a handful
    of composite-key bincounts over the chunk's event stream:
    class*band + (pos - band_lo), with a dump row for gated-out events.
    Gating (eligibility, bounds, dedup-skip) routes events to the dump row
    rather than copying the event arrays, and the position band (reads are
    coordinate-sorted, so a chunk covers a narrow slice of the chromosome)
    keeps the bincount output proportional to the chunk, not to L."""
    from grom_tpu_torch.ingest.batches import expand_span_range
    rid, refpos, readidx = expand_span_range(batch, span_lo, span_hi)
    L = arr.chr_len
    p_hi = p_hi if p_hi > 0 else L
    gate = eligible[rid] & (refpos >= p_lo) & (refpos < p_hi) & \
        (refpos >= 0) & (refpos < L)
    if not gate.any():
        return
    pmin = int(refpos[gate].min())
    pmax = int(refpos[gate].max())
    band = pmax - pmin + 1
    pos = np.where(gate, refpos, np.int32(pmin))

    reads = batch.reads
    flat = reads.seq_off.astype(np.int32)[rid] + readidx
    base = reads.seq[flat]
    qual = reads.qual[flat].astype(np.int32)
    code = _CODE[base]
    mapq = batch.mapq[rid]
    hi = (mapq >= cfg.min_mapq) & (qual >= cfg.min_base_qual)
    # mismatch per the reference: toupper(ref) != seq-byte (seq is upper ACGTN)
    refb = chrom[pos]
    ref_upper = np.where(refb >= 97, refb - 32, refb)
    mismatch = (ref_upper != base) & gate

    # --- read-name dedup on high-quality mismatch events (record order;
    # slots/name_cache persist across chunks) ---
    skip = np.zeros(len(rid), dtype=bool)
    mm_idx = np.flatnonzero(hi & mismatch)
    if len(mm_idx):
        names = reads.names
        max_slots = cfg.min_snv
        name_len_cap = 50  # g_read_name_len
        for i in mm_idx:
            p = int(refpos[i])
            r = int(rid[i])
            nm = name_cache.get(r)
            if nm is None:
                nm = names[r]
                name_cache[r] = nm
            sl = slots.get(p)
            if sl is None:
                sl = []
                slots[p] = sl
            found = False
            for s in sl:
                if s == nm:
                    found = True
                    break
            if found:
                skip[i] = True
            elif len(sl) < max_slots:
                if len(nm) < name_len_cap:
                    sl.append(nm)
    counted_hi = gate & hi & ~skip & (code >= 0)
    lo = gate & ~hi & (code >= 0)

    # --- composite count bincount: rows 0-3 hi by nt, 4-7 lowmq by nt, 8 dump
    sl = slice(pmin - arr.base, pmin - arr.base + band)
    code_c = np.maximum(code, np.int8(0))
    cls = np.where(counted_hi, code_c,
                   np.where(lo, code_c + np.int8(4), np.int8(8)))
    kdt = np.int32 if 9 * band < 2**31 else np.int64
    key = cls.astype(kdt)
    key *= kdt(band)
    key += pos
    key -= kdt(pmin)
    cnt = np.bincount(key, minlength=9 * band)[:8 * band].reshape(8, band)
    snv_hi = cnt[:NT]
    snv_lo = cnt[NT:]
    arr.snv[:, sl] += snv_hi.astype(arr.snv.dtype)
    arr.snv_lowmq[:, sl] += snv_lo.astype(arr.snv_lowmq.dtype)
    # per-pos read counts are the per-class sums (code>=0 always here)
    hi_cnt = snv_hi.sum(axis=0)
    lo_cnt = snv_lo.sum(axis=0)
    arr.bq_read_count[sl] += hi_cnt.astype(arr.bq_read_count.dtype)
    arr.mq_read_count[sl] += hi_cnt.astype(arr.mq_read_count.dtype)
    arr.read_count_all[sl] += (hi_cnt + lo_cnt).astype(arr.read_count_all.dtype)

    # --- fstrand: composite over counted_hi & forward-strand events; all
    # others collapse onto the single dump bin 4*band
    fwd = (batch.flag[rid] & FREVERSE) == 0
    key_f = np.where(counted_hi & fwd, key, kdt(4 * band))
    cnt_f = np.bincount(key_f, minlength=4 * band + 1)[:4 * band].reshape(4, band)
    arr.fstrand[:, sl] += cnt_f.astype(arr.fstrand.dtype)

    # --- qual/mapq sums, packed: one weighted bincount carries both, with
    # qual in the low 26 bits and mapq above (exact in f64 while per-key
    # qual sums stay < 2^26 — guaranteed by the count guard below)
    PACK = 67108864.0  # 2^26
    if int(cnt.max(initial=0)) < (1 << 24) // 256:
        wqm = mapq.astype(np.float64)
        wqm *= PACK
        wqm += qual
        s = np.bincount(key, weights=wqm,
                        minlength=9 * band)[:8 * band].reshape(8, band)
        m_sum = np.floor_divide(s, PACK)
        q_sum = s - m_sum * PACK
        bq_hi = q_sum[:NT].sum(axis=0)
        bq_lo = q_sum[NT:].sum(axis=0)
        mq_hi = m_sum[:NT].sum(axis=0)
        mq_lo = m_sum[NT:].sum(axis=0)
    else:  # pathological pileup: unpacked (exact) path
        posb = pos - np.int32(pmin)
        bq_hi = np.bincount(posb, weights=np.where(counted_hi, qual, 0),
                            minlength=band)[:band]
        bq_lo = np.bincount(posb, weights=np.where(lo, qual, 0),
                            minlength=band)[:band]
        mq_hi = np.bincount(posb, weights=np.where(counted_hi, mapq, 0),
                            minlength=band)[:band]
        mq_lo = np.bincount(posb, weights=np.where(lo, mapq, 0),
                            minlength=band)[:band]
    arr.bq[sl] += bq_hi.astype(arr.bq.dtype)
    arr.bq_all[sl] += (bq_hi + bq_lo).astype(arr.bq_all.dtype)
    arr.mq[sl] += mq_hi.astype(arr.mq.dtype)
    arr.mq_all[sl] += (mq_hi + mq_lo).astype(arr.mq_all.dtype)

    # --- pos-in-read: match bases use the strand-dependent index, mismatch
    # bases the raw read index for both strands (src/GROM.c:6846-6870 vs 6900)
    lseq = batch.lseq.astype(np.int32)[rid]
    pir = np.where(mismatch | fwd, readidx, lseq - readidx)
    # non-counted events carry cls>=4 and land in rows sliced away below
    pir_sum = np.bincount(key, weights=pir,
                          minlength=9 * band)[:NT * band].reshape(NT, band)
    arr.pos_in_read[:, sl] += pir_sum.astype(arr.pos_in_read.dtype)
