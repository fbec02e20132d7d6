"""SNV detection, batched depth filtering, genotyping and row formatting.

Vectorized re-expression of the reference's per-position SNV caller
(src/GROM.c:11126-11326 and the final flush :15025-15330): at every scanned
position, per-alt thresholds + binomial table lookups produce candidates; the
candidate list is flushed in batches of ``sv_list_len - 10`` with a running
cumulative mean read depth gating high-coverage sites.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from grom_tpu_torch.call.scan import (ChromArrays, window_base_at, window_base_final,
                                window_len_l0)
from grom_tpu_torch.config import DerivedConfig, GromConfig

_DNA = "ACGT"


def c_round(x: float) -> float:
    """C round(): half away from zero (Python's round is banker's)."""
    if math.isnan(x):
        return x
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


@dataclass
class SnvCandidates:
    pos: np.ndarray           # 0-based
    alt: np.ndarray           # nt code 0..3
    ratio: np.ndarray         # float (computed in float32 like the reference)
    binom_cdf: np.ndarray     # mq-table p (double)
    hez_cdf: np.ndarray       # hez-table p (double)
    counts: np.ndarray        # [4, K] high-quality counts snapshot
    lowmq: np.ndarray         # [4, K]
    bq_all: np.ndarray
    mq_all: np.ndarray
    bq: np.ndarray
    mq: np.ndarray
    bq_read_count: np.ndarray
    mq_read_count: np.ndarray
    read_count_all: np.ndarray
    pos_in_read: np.ndarray   # scalar per candidate: pir sum of the alt nt
    fstrand: np.ndarray       # scalar per candidate: fstrand of the alt nt

    def __len__(self):
        return len(self.pos)


def detect_snv_candidates(chrom: np.ndarray, arr: ChromArrays,
                          cfg: GromConfig, mq_table: np.ndarray,
                          hez_table: np.ndarray, scan_start: int,
                          scan_end: int, lo: Optional[int] = None,
                          hi: Optional[int] = None) -> SnvCandidates:
    """Candidate selection (src/GROM.c:11126-11199). Returns candidates in
    position order (one per position: the highest-ratio qualifying alt; ties
    keep the earlier nucleotide).

    ``lo``/``hi`` restrict the screen to an absolute position window (the
    streamed chunked mode); ``arr``'s arrays may then be chunk-local starting
    at ``arr.base``."""
    L = len(chrom)
    lo = max(scan_start, 0) if lo is None else max(lo, scan_start, 0)
    hi = min(scan_end + 1, L) if hi is None else min(hi, scan_end + 1, L)
    if hi <= lo:
        return _empty_candidates()
    base = arr.base
    sl = slice(lo - base, hi - base)
    ref = chrom[lo:hi]
    ref_upper = np.where(ref >= 97, ref - 32, ref)
    not_n = (ref_upper != ord("N"))
    gate = (arr.one_base_rd[sl] + arr.indel_sc_rd[sl]) > 0

    counts = arr.snv[:, sl]                      # [4, W]
    total = counts.sum(axis=0)
    rc_all = arr.read_count_all[sl]
    bq_all = arr.bq_all[sl]

    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = counts.astype(np.float32) / total.astype(np.float32)  # [4, W]
        ave_bq_ok = (bq_all.astype(np.float64) / rc_all.astype(np.float64)) >= cfg.min_ave_bq

    ref_code = np.full(hi - lo, -1, dtype=np.int8)
    for i, ch in enumerate(b"ACGT"):
        ref_code[ref_upper == ch] = i

    is_alt = np.arange(4)[:, None] != ref_code[None, :]
    qual = (is_alt & (ratio >= np.float32(cfg.min_snv_ratio))
            & (counts >= cfg.min_snv) & ave_bq_ok[None, :]
            & gate[None, :] & not_n[None, :])

    any_q = qual.any(axis=0)
    if not any_q.any():
        return _empty_candidates()
    w = np.flatnonzero(any_q)
    # best alt per position: max ratio, earliest nt on ties (strict > replaces)
    r_masked = np.where(qual[:, w], ratio[:, w], -1.0)
    best = np.argmax(r_masked, axis=0)  # argmax returns first max ✓

    k = len(w)
    gpos = w + lo
    n_arr = total[w]
    k_arr = counts[best, w]
    from grom_tpu_torch.stats.binom import lookup_cdf
    binom = lookup_cdf(mq_table, n_arr, k_arr, cfg.max_trials)
    hez = lookup_cdf(hez_table, n_arr, k_arr, cfg.max_trials)

    return SnvCandidates(
        pos=gpos.astype(np.int64), alt=best.astype(np.int8),
        ratio=r_masked[best, np.arange(k)].astype(np.float64),
        binom_cdf=binom, hez_cdf=hez,
        counts=counts[:, w].copy(), lowmq=arr.snv_lowmq[:, sl][:, w].copy(),
        bq_all=bq_all[w], mq_all=arr.mq_all[sl][w],
        bq=arr.bq[sl][w], mq=arr.mq[sl][w],
        bq_read_count=arr.bq_read_count[sl][w],
        mq_read_count=arr.mq_read_count[sl][w],
        read_count_all=rc_all[w],
        pos_in_read=arr.pos_in_read[:, sl][best, w],
        fstrand=arr.fstrand[:, sl][best, w],
    )


def candidates_from_device(dev: dict, chrom: np.ndarray, cfg: GromConfig,
                           mq_table: np.ndarray, hez_table: np.ndarray,
                           scan_start: int, scan_end: int,
                           lo: Optional[int] = None,
                           hi: Optional[int] = None) -> SnvCandidates:
    """Finish the device SNV screen (ops/accumulate.py): the device returns a
    SUPERSET of candidate positions with exact integer stats; re-derive the
    reference's float32 ratio / ave-bq / best-alt decisions here in numpy
    (bit-identical to detect_snv_candidates). ``lo``/``hi`` restrict to an
    absolute position window (chunked streaming)."""
    n = int(dev["n"])
    if n == 0:
        return _empty_candidates()
    L = len(chrom)
    lo = max(scan_start, 0) if lo is None else max(lo, scan_start, 0)
    hi = min(scan_end + 1, L) if hi is None else min(hi, scan_end + 1, L)
    pos = dev["pos"][:n].astype(np.int64)
    sel0 = np.flatnonzero((pos >= lo) & (pos < hi))
    if len(sel0) == 0:
        return _empty_candidates()
    pos = pos[sel0]
    counts = dev["counts"][:, :n][:, sel0].astype(np.int64)
    lowmq = dev["lowmq"][:, :n][:, sel0].astype(np.int64)
    bq = dev["bq"][:n][sel0].astype(np.int64)
    bq_all = dev["bq_all"][:n][sel0].astype(np.int64)
    mq_s = dev["mq"][:n][sel0].astype(np.int64)
    mq_all = dev["mq_all"][:n][sel0].astype(np.int64)
    bq_rc = dev["bq_read_count"][:n][sel0].astype(np.int64)
    mq_rc = dev["mq_read_count"][:n][sel0].astype(np.int64)
    rc_all = dev["read_count_all"][:n][sel0].astype(np.int64)
    pir4 = dev["pos_in_read"][:, :n][:, sel0].astype(np.int64)
    fs4 = dev["fstrand"][:, :n][:, sel0].astype(np.int64)

    ref = chrom[pos]
    ref_upper = np.where(ref >= 97, ref - 32, ref)
    not_n = ref_upper != ord("N")
    ref_code = np.full(len(pos), -1, dtype=np.int8)
    for i, ch in enumerate(b"ACGT"):
        ref_code[ref_upper == ch] = i

    total = counts.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = counts.astype(np.float32) / total.astype(np.float32)
        ave_bq_ok = (bq_all.astype(np.float64)
                     / rc_all.astype(np.float64)) >= cfg.min_ave_bq
    is_alt = np.arange(4)[:, None] != ref_code[None, :]
    qual = (is_alt & (ratio >= np.float32(cfg.min_snv_ratio))
            & (counts >= cfg.min_snv) & ave_bq_ok[None, :] & not_n[None, :])
    any_q = qual.any(axis=0)
    w = np.flatnonzero(any_q)
    if len(w) == 0:
        return _empty_candidates()
    r_masked = np.where(qual[:, w], ratio[:, w], -1.0)
    best = np.argmax(r_masked, axis=0)
    k = len(w)
    from grom_tpu_torch.stats.binom import lookup_cdf
    binom = lookup_cdf(mq_table, total[w], counts[best, w], cfg.max_trials)
    hez = lookup_cdf(hez_table, total[w], counts[best, w], cfg.max_trials)
    kk = np.arange(k)
    return SnvCandidates(
        pos=pos[w], alt=best.astype(np.int8),
        ratio=r_masked[best, kk].astype(np.float64),
        binom_cdf=binom, hez_cdf=hez,
        counts=counts[:, w], lowmq=lowmq[:, w],
        bq_all=bq_all[w], mq_all=mq_all[w], bq=bq[w], mq=mq_s[w],
        bq_read_count=bq_rc[w], mq_read_count=mq_rc[w],
        read_count_all=rc_all[w],
        pos_in_read=pir4[:, w][best, kk], fstrand=fs4[:, w][best, kk],
    )


def _empty_candidates() -> SnvCandidates:
    z = np.empty(0, np.int64)
    z4 = np.empty((4, 0), np.int64)
    return SnvCandidates(z, np.empty(0, np.int8), np.empty(0), np.empty(0),
                         np.empty(0), z4, z4, z, z, z, z, z, z, z, z, z)


def concat_candidates(parts: List[SnvCandidates]) -> SnvCandidates:
    """Concatenate per-chunk candidate batches (ascending position order)."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return _empty_candidates()
    if len(parts) == 1:
        return parts[0]
    cat = np.concatenate
    return SnvCandidates(
        pos=cat([p.pos for p in parts]),
        alt=cat([p.alt for p in parts]),
        ratio=cat([p.ratio for p in parts]),
        binom_cdf=cat([p.binom_cdf for p in parts]),
        hez_cdf=cat([p.hez_cdf for p in parts]),
        counts=cat([p.counts for p in parts], axis=1),
        lowmq=cat([p.lowmq for p in parts], axis=1),
        bq_all=cat([p.bq_all for p in parts]),
        mq_all=cat([p.mq_all for p in parts]),
        bq=cat([p.bq for p in parts]),
        mq=cat([p.mq for p in parts]),
        bq_read_count=cat([p.bq_read_count for p in parts]),
        mq_read_count=cat([p.mq_read_count for p in parts]),
        read_count_all=cat([p.read_count_all for p in parts]),
        pos_in_read=cat([p.pos_in_read for p in parts]),
        fstrand=cat([p.fstrand for p in parts]))


def flush_filter(cand: SnvCandidates, chrom: np.ndarray, arr: ChromArrays,
                 cfg: GromConfig, drv: DerivedConfig, scan_start: int,
                 scan_end: int, skipped: int) -> np.ndarray:
    """Replicates the batched depth filter (src/GROM.c:11203-11230, :15025):
    candidates accumulate into a list flushed when it reaches
    ``sv_list_len - 10`` entries; at each flush the cumulative mean depth over
    non-N bases of [0, window_base) gates candidates:
    keep iff read_count_all <= round(1.75 * ave_rd) or ratio >= 0.4.
    Returns a bool keep-mask over candidates.
    """
    l0 = window_len_l0(cfg, drv)
    flush_size = cfg.sv_list_len - 10
    K = len(cand)
    keep = np.zeros(K, dtype=bool)
    L = len(chrom)

    def range_stats(a: int, b: int):
        """(Σ depth over non-N bases, #non-N bases) of [a, b) — incremental
        slice sums; the round-3 whole-chromosome cumsums were an O(L)
        16B/base transient."""
        if b <= a:
            return 0, 0
        ref = chrom[a:b]
        nn = (ref != ord("N")) & (ref != ord("n"))
        d = arr.rd_hi[a:b].astype(np.int64) + arr.rd_lo[a:b]
        return int(d[nn].sum()), int(nn.sum())

    start_idx = 0
    last_group_pos = 0
    rc_total = 0
    base_total = 0
    while start_idx < K:
        end_idx = min(start_idx + flush_size, K)
        if end_idx - start_idx == flush_size:
            # mid-scan flush at the scan position of the last candidate
            flush_scan = int(cand.pos[end_idx - 1])
            bound = window_base_at(flush_scan, scan_start, l0, skipped)
        else:
            bound = window_base_final(scan_end, scan_start, l0, skipped)
        bound = max(bound, last_group_pos)
        bound_c = min(bound, L)
        inc_d, inc_b = range_stats(last_group_pos, bound_c)
        rc_total += inc_d
        base_total += inc_b
        last_group_pos = bound_c
        ave = (rc_total / base_total) if base_total else math.nan
        thresh = c_round(cfg.snv_rd_min_factor * ave)
        sel = slice(start_idx, end_idx)
        rc = cand.read_count_all[sel].astype(np.float64)
        keep[sel] = np.where(
            np.isnan(thresh), cand.ratio[sel] >= cfg.high_cov_min_snv_ratio,
            (rc <= thresh) | (cand.ratio[sel] >= cfg.high_cov_min_snv_ratio))
        start_idx = end_idx
    return keep


def genotype_string(ratio: float, ploidy: int) -> str:
    """GT from round(ratio*ploidy) copies, min 1 (src/GROM.c:11229-11252)."""
    cn = int(c_round(ratio * ploidy))
    if cn == 0:
        cn = 1
    return "/".join("1" if i < cn else "0" for i in range(ploidy))


def format_snv_rows(cand: SnvCandidates, keep: np.ndarray, chrom: np.ndarray,
                    chr_name: str, cfg: GromConfig,
                    lseq: int = 0) -> List[str]:
    """Exact reference VCF rows (src/GROM.c:15072, same format at :11254):
    note the empty ID column (two consecutive tabs) and REF preserving FASTA
    case. With -f (cfg.vcf_output False) emits the tabular format instead
    (src/GROM.c:11271-11320): 0-based position, never-written rd columns
    (always 0 — the reference prints malloc'd-but-unfilled arrays, which
    large-allocation zero pages make deterministic), tri-nucleotide context,
    and an lseq+lseq-1 flank string whose right half prints REVERSED with the
    reference's off-by-one N at index len-1."""
    if not cfg.vcf_output:
        return _format_snv_tabular(cand, keep, chrom, chr_name, cfg, lseq)
    rows = []
    for i in np.flatnonzero(keep):
        p = int(cand.pos[i])
        alt_i = int(cand.alt[i])
        gt = genotype_string(float(cand.ratio[i]), cfg.ploidy)
        n_alt = int(cand.counts[alt_i, i])
        rca = int(cand.read_count_all[i])
        bq_mean = cand.bq_all[i] / rca if rca else math.nan
        mq_mean = cand.mq_all[i] / rca if rca else math.nan
        pir = cand.pos_in_read[i] / n_alt if n_alt else math.nan
        fs = cand.fstrand[i] / n_alt if n_alt else math.nan
        rows.append(
            "%s\t%d\t\t%c\t%c\t.\t.\t.\tGT:PR:AF:A:C:G:T:AL:CL:GL:TL:BQ:MQ:PIR:FS\t"
            "%s:%e:%e:%d:%d:%d:%d:%d:%d:%d:%d:%.2f:%.2f:%.2f:%.2f"
            % (chr_name, p + 1, chr(chrom[p]), _DNA[alt_i], gt,
               cand.binom_cdf[i], cand.ratio[i],
               cand.counts[0, i], cand.counts[1, i], cand.counts[2, i], cand.counts[3, i],
               cand.lowmq[0, i], cand.lowmq[1, i], cand.lowmq[2, i], cand.lowmq[3, i],
               bq_mean, mq_mean, pir, fs))
    return rows


def _format_snv_tabular(cand: SnvCandidates, keep: np.ndarray,
                        chrom: np.ndarray, chr_name: str, cfg: GromConfig,
                        lseq: int) -> List[str]:
    """Tabular SNV rows (src/GROM.c:11271-11320)."""
    rows = []
    L = len(chrom)
    for i in np.flatnonzero(keep):
        p = int(cand.pos[i])
        alt_i = int(cand.alt[i])
        n_alt = int(cand.counts[alt_i, i])
        rca = int(cand.read_count_all[i])
        bq_mean = cand.bq_all[i] / rca if rca else math.nan
        mq_mean = cand.mq_all[i] / rca if rca else math.nan
        pir = cand.pos_in_read[i] / n_alt if n_alt else math.nan
        fs = cand.fstrand[i] / n_alt if n_alt else math.nan
        parts = ["SNV\t%s\t%d\t%c\t%e\t%d\t%d"
                 % (chr_name, p, _DNA[alt_i], cand.ratio[i], 0, 0)]
        for nt in range(4):
            parts.append("\t%d" % cand.counts[nt, i])
        for nt in range(4):
            parts.append("\t%d" % cand.lowmq[nt, i])
        parts.append("\t%d\t%d\t%d\t%d\t%d\t%d\t%d"
                     % (cand.bq[i], cand.bq_all[i], cand.mq[i],
                        cand.mq_all[i], cand.bq_read_count[i],
                        cand.mq_read_count[i], rca))
        if 0 < p < L - 1:
            tri = "%c%c%c" % (chrom[p - 1], chrom[p], chrom[p + 1])
        else:
            tri = "..."
        parts.append("\t%.2f\t%.2f\t%s" % (pir, fs, tri))
        # flank: lseq left chars (p-lseq+1..p, N below 0), then lseq-1 right
        # chars printed in DESCENDING order p+lseq-1..p+1 with N at any index
        # >= L-1 (the reference's boundary check, src/GROM.c:11303-11313)
        flank = []
        for b in range(lseq):
            q = p - lseq + 1 + b
            flank.append("N" if q < 0 else chr(chrom[q]))
        for b in range(lseq - 1):
            q = p + lseq - 1 - b
            flank.append("N" if q >= L - 1 else chr(chrom[q]))
        parts.append("\t%s" % "".join(flank))
        parts.append("\t%e\t%e" % (cand.binom_cdf[i], cand.hez_cdf[i]))
        rows.append("".join(parts))
    return rows
