"""The plain reference of the benchmark: what GROM's calling rules give on
the reads that ``synth.py`` made, in NumPy, independent of the program.

It imports nothing of the program and takes nothing the program made. It
replays each contig's reads from the same seed (``synth.contig_stream``),
then works out again, from those reads and the configuration's thresholds:

* the SNV rows: the per-base tallies of every position where an alt base
  reaches the screen (high-mapq count, low-mapq count, base and mapping
  quality sums, forward strand, position in read), the screen's decision
  and each row's fields but PR (the binomial tail, which needs GROM's
  tables): GT, AF (the float32 ratio GROM prints), A..T, AL..TL, BQ, MQ,
  PIR and FS;
* the depth lists (high- and low-mapq depth, mapq sums), and from them the
  CNV copy number of any interval: GROM's insert size, GC and ACGT
  triangle weights, excessive-coverage block mask, GC-bin depth sampling
  and its trimmed mean (with GROM's comparator that reads the low 32 bits
  of each double) in float64, giving each CNV row's CN and CS;
* the CNV rows themselves (``cnvref.py``): the z-scores, the null window
  model and the seed walk in float64, each row's interval, SD, Z, CN and
  CS.

``judge`` counts the rows of a run that disagree with it: an SNV row whose
fields differ or that the screen would not pass, a reference candidate the
run left out, a CNV row the reference does not write or one it writes that
the run left out, and any SV, indel or translocation row (no reads carry
one). It also counts, apart and not as wrong, the planted CNV events that
no row covers: GROM writes a row only below its p-value limit, so an event
that the reference does not call either says nothing of the run.

``precision="lower"`` computes the same in the next precision below the one
the configuration states (AF in bfloat16; the z-scores, null model, walk,
averages and copy number in float32): the control, which ``judge`` has to
fail.
"""

from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

import cnvref
import synth

_CODE = np.full(256, 4, np.int8)
for _i, _ch in enumerate(b"ACGT"):
    _CODE[_ch] = _i
    _CODE[_ch | 0x20] = _i
_DNA = "ACGT"
# Abramowitz-Stegun 7.1.26, as GROM evaluates erf
_AP, _A1, _A2, _A3, _A4, _A5 = (0.3275911, 0.254829592, -0.284496736,
                                1.421413741, -1.453152027, 1.061405429)


def c_round(x: float) -> float:
    """C's round(): half away from zero."""
    return math.floor(x + 0.5) if x >= 0 else math.ceil(x - 0.5)


def bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), as
    float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


@dataclass
class Contig:
    name: str
    length: int
    genome: np.ndarray
    pos: np.ndarray
    mpos: np.ndarray
    tlen: np.ndarray
    flag: np.ndarray
    mapq: np.ndarray
    seq: np.ndarray          # [R, rl] uint8
    qual: np.ndarray         # [R, rl] uint8
    rl: int                  # read length
    hotspots: list = field(default_factory=list)
    depressions: list = field(default_factory=list)


def replay(specs: List[dict]) -> List[Contig]:
    """Each contig's genome and reads, drawn again from its seed."""
    out = []
    for refid, spec in enumerate(specs):
        stream = synth.contig_stream(spec, refid)
        head = next(stream)
        R, rl = len(head["pos"]), head["read_len"]
        seq = np.empty((R, rl), np.uint8)
        qual = np.empty((R, rl), np.uint8)
        for sl in stream:
            seq[sl["s0"]:sl["s1"]] = synth.slice_bases(head, sl)
            qual[sl["s0"]:sl["s1"]] = sl["qual"]
        out.append(Contig(spec["name"].lower(), int(spec["length"]),
                          head["genome"], head["pos"].astype(np.int64),
                          head["mpos"].astype(np.int64), head["tlen"],
                          head["flag"], head["mapq"].astype(np.int64), seq,
                          qual, rl, list(spec.get("hotspots") or []),
                          list(spec.get("depressions") or [])))
    return out


# ---------------------------------------------------------------------------
# insert size and the scan range
# ---------------------------------------------------------------------------

def insert_stats(contigs: List[Contig], g: dict) -> Tuple[int, int]:
    """(insert mean, insert max) by GROM's rule: the insert of each proper
    pair's leftmost mate (mate on the same contig, pos < mpos, tlen > 0)
    in file order, up to the sample size; median, drop inserts over 5x it,
    median again; the max a two-sided quantile at ``insert_num_st_devs``
    SDs, read one past the cut when the quantile index is 0."""
    parts = []
    for c in contigs:
        paired = ((c.flag & 0x1) != 0) & ((c.flag & 0x8) == 0) \
            & ((c.flag & 0x2) != 0) & (c.pos < c.mpos) & (c.tlen > 0) \
            & ((c.flag & 0x4) == 0) & ((c.flag & 0x400) == 0)
        parts.append(c.tlen[paired].astype(np.int64))
    s = np.concatenate(parts)[:g["insert_sample_size"]]
    count = len(s)
    s = np.sort(s, kind="stable")
    median = int(s[count // 2])
    end = int(np.searchsorted(s, median * g["insert_max_mult"],
                              side="right")) or 1
    mean = int(s[end // 2])
    x = g["insert_num_st_devs"] / math.sqrt(2.0)
    t = 1.0 / (1.0 + _AP * x)
    erf = 1.0 - (_A1 * t + _A2 * t**2 + _A3 * t**3 + _A4 * t**4
                 + _A5 * t**5) * math.exp(-(x**2))
    min_index = int((1.0 - erf) / 2.0 * end / 2)
    max_index = end - min_index
    imax = int(s[max_index]) if max_index < count else int(s[count - 1])
    return max(mean, contigs[0].rl), imax


def scan_start(mean: int, imax: int, g: dict) -> int:
    """First scanned position: reads starting before it are not used."""
    l0 = g["overlap_mult"] * 8 * max(2 * mean - 1, imax + 1)
    return (2 * l0) // 4 + 1


# ---------------------------------------------------------------------------
# SNV rows
# ---------------------------------------------------------------------------

@dataclass
class SnvExpect:
    rows: Dict[int, str]         # 1-based pos -> row without PR
    required: set                # positions a sound run must emit
    excluded: set                # candidates the depth filter must drop


def _div(a, b, prec):
    if prec == "lower":
        return np.float32(a) / np.float32(b)
    return float(a) / float(b)


def snv_expect(c: Contig, start: int, imax: int, rd_depth: np.ndarray,
               g: dict, prec: str = "stated") -> SnvExpect:
    elig = c.pos >= start
    pos, seq, qual, mapq, flag = (c.pos[elig], c.seq[elig], c.qual[elig],
                                  c.mapq[elig], c.flag[elig])
    gen, RL = c.genome, c.rl
    # alt events of high-mapq, high-quality bases: candidate positions
    keys = []
    for r0 in range(0, len(pos), 500_000):
        p = pos[r0:r0 + 500_000]
        s = seq[r0:r0 + 500_000]
        q = qual[r0:r0 + 500_000]
        at = p[:, None] + np.arange(RL)
        ref = gen[at]
        mm = (s != ref) & (q >= g["min_base_qual"]) \
            & (mapq[r0:r0 + 500_000] >= g["min_mapq"])[:, None] \
            & (_CODE[ref] < 4)
        rr, kk = np.nonzero(mm)
        keys.append(at[rr, kk] * 4 + _CODE[s[rr, kk]])
    keys = np.concatenate(keys) if keys else np.zeros(0, np.int64)
    uk, cnt = np.unique(keys, return_counts=True)
    P = np.unique(uk[cnt >= g["min_snv"]] // 4)
    # every read over each candidate position
    lo = np.searchsorted(pos, P - (RL - 1), side="left")
    hi = np.searchsorted(pos, P, side="right")
    n = hi - lo
    cand = np.repeat(np.arange(len(P)), n)
    r = np.repeat(lo, n) + (np.arange(n.sum()) - np.repeat(np.cumsum(n) - n,
                                                            n))
    k = P[cand] - pos[r]
    b = _CODE[seq[r, k]]
    q = qual[r, k].astype(np.int64)
    mq = mapq[r]
    fwd = (flag[r] & 16) == 0
    mmv = seq[r, k] != gen[P[cand]]
    hi_m = (mq >= g["min_mapq"]) & (q >= g["min_base_qual"]) & (b < 4)
    low = ~((mq >= g["min_mapq"]) & (q >= g["min_base_qual"])) & (b < 4)
    pir = np.where(mmv | fwd, k, RL - k)
    K = len(P)
    ch = cand * 4 + np.minimum(b, 3)

    def tally(mask, w=None, channels=True):
        idx = ch[mask] if channels else cand[mask]
        ww = None if w is None else w[mask]
        return np.bincount(idx, ww, minlength=K * 4 if channels else K) \
            .astype(np.int64).reshape((K, 4) if channels else (K,))

    counts = tally(hi_m)
    lowmq = tally(low)
    fstrand = tally(hi_m & fwd)
    posin = tally(hi_m, pir)
    bq_all = tally(hi_m | low, q, channels=False)
    mq_all = tally(hi_m | low, mq, channels=False)
    rca = tally(hi_m | low, channels=False)
    total = counts.sum(1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = counts.astype(np.float32) / total[:, None].astype(np.float32)
        ave_bq_ok = bq_all / rca >= g["min_ave_bq"]
    if prec == "lower":
        ratio = bf16(ratio)
    ref_code = _CODE[gen[P]]
    is_alt = np.arange(4)[None, :] != ref_code[:, None]
    ok = is_alt & (ratio >= np.float32(g["min_snv_ratio"])) \
        & (counts >= g["min_snv"]) & ave_bq_ok[:, None] \
        & (ref_code < 4)[:, None]
    # the depth filter: a high-depth site needs a high ratio; sites within
    # 2 of the threshold (a running mean in GROM) go either way
    nn = _CODE[gen] < 4
    thr = c_round(g["snv_rd_min_factor"] * rd_depth[nn].sum() / nn.sum())
    scan_end = int(pos[-1]) - g["overlap_mult"] * imax if len(pos) else 0
    out = SnvExpect({}, set(), set())
    for i in np.flatnonzero(ok.any(1)):
        rm = np.where(ok[i], ratio[i], -1.0)
        a = int(np.argmax(rm))
        rat = float(rm[a])
        p1 = int(P[i]) + 1
        if rat < g["high_cov_min_snv_ratio"] and rca[i] > thr + 2:
            out.excluded.add(p1)
            continue
        cn = int(c_round(rat * g["ploidy"])) or 1
        gt = "/".join("1" if j < cn else "0" for j in range(g["ploidy"]))
        na = int(counts[i, a])
        out.rows[p1] = (
            "%s\t%d\t\t%c\t%c\t.\t.\t.\tGT:PR:AF:A:C:G:T:AL:CL:GL:TL:BQ:MQ:"
            "PIR:FS\t%s:%e:%d:%d:%d:%d:%d:%d:%d:%d:%.2f:%.2f:%.2f:%.2f"
            % (c.name, p1, chr(gen[P[i]]), _DNA[a], gt, rat,
               *counts[i], *lowmq[i],
               _div(bq_all[i], rca[i], prec), _div(mq_all[i], rca[i], prec),
               _div(posin[i, a], na, prec), _div(fstrand[i, a], na, prec)))
        if (rat >= g["high_cov_min_snv_ratio"] or rca[i] <= thr - 2) \
                and P[i] < scan_end - 10:
            out.required.add(p1)
    return out


def strip_pr(row: str) -> str:
    """An SNV row without its PR value (the second sample field)."""
    head, _, sample = row.rpartition("\t")
    parts = sample.split(":")
    return head + "\t" + ":".join(parts[:1] + parts[2:])


# ---------------------------------------------------------------------------
# depth lists and CNV copy number
# ---------------------------------------------------------------------------

def depth_lists(c: Contig, start: int, g: dict):
    """(rd_hi, rd_lo, rd_mq): the depth of eligible reads whose whole span
    lies inside the contig, by high or low mapq, and their mapq sums."""
    L = c.length
    keep = (c.pos >= start) & (c.pos + c.rl < L)
    s, e, mq = c.pos[keep], c.pos[keep] + c.rl, c.mapq[keep]
    hi = mq >= g["min_mapq"]

    def depth(sel, w=None):
        d = np.bincount(s[sel], None if w is None else w[sel], L + 1)
        d -= np.bincount(e[sel], None if w is None else w[sel], L + 1)
        return np.cumsum(d)[:L].astype(np.int64)

    return depth(hi), depth(~hi), depth(np.ones(len(s), bool), mq)


def _triangle(x: np.ndarray, m: int, L: int) -> np.ndarray:
    """T(p) = sum over |d| < m of (m - |d|) x[p + d], for p in
    [m - 1, L - 2m + 1)."""
    c1 = np.concatenate([[0], np.cumsum(x, dtype=np.int64)])
    S = np.concatenate([[0], np.cumsum(c1)])
    out = np.zeros(L, np.int64)
    lo, hi = m - 1, L - (2 * m - 1)
    if hi > lo:
        p = np.arange(lo, hi)
        out[lo:hi] = (S[p + m + 1] - S[p + 1]) - (S[p + 1] - S[p - m + 1])
    return out


def _ffill(defc: np.ndarray, init: int) -> np.ndarray:
    """-1 entries take the last class >= 0 before them (``init`` if none)."""
    idx = np.where(defc >= 0, np.arange(len(defc)), -1)
    np.maximum.accumulate(idx, out=idx)
    return np.where(idx >= 0, defc[np.maximum(idx, 0)], init)


def _masked_blocks(depth, acgt_base, L, g) -> List[Tuple[int, int]]:
    """GROM's excessive-coverage blocks: runs of 10 kb blocks whose mean
    depth passes twice the contig's mean over ACGT bases."""
    ave = depth[acgt_base].sum() / acgt_base.sum() if acgt_base.any() else 0.
    U = g["block_unit_size"]
    nb = L // U
    means = depth[:nb * U].reshape(nb, U).sum(1) / U
    over = np.flatnonzero(means > g["chr_rd_threshold_factor"] * ave)
    masked, temp, t_start, t_end, cur = [], 0, 0, 0, None
    for a in range(1, len(over)):
        if temp == 0:
            if temp + 1 > (over[a] - over[a - 1]) // 4:
                t_end = over[a] + 1
                temp += 1
            else:
                t_end = over[a - 1] + 1
            t_start = over[a - 1]
            temp += 1
        else:
            if temp + 1 > (over[a - 1] - t_start) // 4:
                t_end = over[a - 1] + 1
                temp += 1
            else:
                if temp >= g["min_blocks"] and cur is not None:
                    masked.append(cur)
                cur = None
                temp = 1
                t_start = over[a - 1]
                t_end = over[a - 1] + 1
            if temp >= g["min_blocks"]:
                cur = (t_start * U, t_end * U)
    if temp >= g["min_blocks"] and cur is not None:
        masked.append(cur)
    return masked


@dataclass
class CnvState:
    depth: np.ndarray
    mq_mean: np.ndarray
    gc: np.ndarray
    low_acgt: np.ndarray
    ave: np.ndarray
    nwin: np.ndarray         # [2, bins] merged sample sizes
    samples: list            # [2][bins] merged sorted depth samples
    blocks: list             # sampling blocks, clamped to the scan range
    mean: int                # insert mean


def cnv_state(c: Contig, lists, mean: int, g: dict) -> CnvState:
    rd_hi, rd_lo, rd_mq = lists
    L, m = c.length, mean
    W = 2 * m - 1
    depth = rd_hi + rd_lo
    mq_mean = np.where(depth > 0, rd_mq // np.maximum(depth, 1), 0)
    code = _CODE[c.genome]
    gc = np.zeros(L, np.int64)
    acgt = np.zeros(L, np.int64)
    lo, hi = m - 1, L - W
    if hi > lo:
        gc[lo:hi] = 100 * _triangle((code == 1) | (code == 2), m, L)[lo:hi] \
            // (m * m)
        acgt[lo:hi] = 100 * _triangle(code < 4, m, L)[lo:hi] // (m * m)
    # sampling blocks: the contig less its excessive-coverage runs
    blocks, s0 = [], 0
    for ms, me in _masked_blocks(depth, code < 4, L, g):
        if me - ms >= 10000:
            blocks.append((s0, ms))
            s0 = me
    blocks.append((s0, L))
    blocks = [(min(max(s, lo), hi), min(max(e, lo), hi)) for s, e in blocks]
    blocks = [(s, e) for s, e in blocks if e - s >= g["min_rd_window_len"]]
    NB = g["num_gc_bins"]
    P = np.concatenate([np.arange(s, e, m // 2) for s, e in blocks]) \
        if blocks else np.zeros(0, np.int64)
    P = P[acgt[P] >= 99]
    dv = depth[P]
    defc = np.where(dv == 0, -1, np.where(mq_mean[P] >= g["min_mapq"], 0, 1))
    key = _ffill(defc, 0) * NB + gc[P]
    if np.bincount(key, minlength=2 * NB).max(initial=0) > \
            g["sample_lists_len"]:
        raise ValueError("a GC bin holds more samples than GROM's list")
    samples = [np.sort(dv[key == kk]) for kk in range(2 * NB)]
    ave = np.zeros((2, NB))
    nwin = np.zeros((2, NB), np.int64)
    kept = []
    for cls in (0, 1):
        arr = samples[cls * NB:(cls + 1) * NB]
        n0 = [len(a) for a in arr]
        merged = list(arr)
        for b in range(2, NB - 2):
            if 20 <= n0[b] < 100:
                ext = [arr[b]] + [arr[a][:n0[a]] for a in range(b - 2, b + 3)
                                  if a != b]
                merged[b] = np.sort(np.concatenate(ext)
                                    [:g["sample_lists_len"]])
        kept.append(merged)
        for b in range(NB):
            nwin[cls, b] = len(merged[b])
            if len(merged[b]):
                ave[cls, b] = merged[b].astype(np.float64).sum() \
                    / len(merged[b])
    low_acgt = np.ones(L, np.int8)
    if hi > lo:
        ok = acgt[lo:hi] >= 99
        dc = np.where(mq_mean[lo:hi] >= g["min_mapq"], 0,
                      np.where(depth[lo:hi] > 0, 1, -1))
        cls = _ffill(np.where(ok, dc, -1), 0)
        low_acgt[lo:hi] = np.where(ok & (nwin[cls, gc[lo:hi]] >= 100), 0, 1)
    return CnvState(depth, mq_mean, gc, low_acgt, ave, nwin, kept, blocks,
                    m)


def broken_sort(v: np.ndarray) -> np.ndarray:
    """GROM's qsort of doubles with an int comparator: glibc's top-down
    merge sort ordering by the low 32 bits of each double, subtracted with
    int32 wraparound."""
    key = np.ascontiguousarray(v, np.float64).view(np.uint32)[0::2] \
        .astype(np.int64).tolist()

    def lt(i, j):
        d = (key[i] - key[j]) & 0xFFFFFFFF
        return d >= 0x80000000

    def msort(idx):
        n = len(idx)
        if n <= 1:
            return idx
        a = msort(idx[:n // 2])
        b = msort(idx[n // 2:])
        out, i, j = [], 0, 0
        while i < len(a) and j < len(b):
            if lt(b[j], a[i]):
                out.append(b[j])
                j += 1
            else:
                out.append(a[i])
                i += 1
        return out + a[i:] + b[j:]

    return v[np.array(msort(list(range(len(v)))), np.int64)] if len(v) else v


def copy_number(st: CnvState, start: int, end: int, g: dict,
                prec: str = "stated") -> Tuple[float, float]:
    """(CN, CS) of [start, end): the 10 % trimmed mean of depth over the
    GC-bin mean, times the ploidy, and the SD of all of them."""
    sl = slice(start, end)
    a = st.ave[(st.mq_mean[sl] < g["min_mapq"]).astype(np.int64),
               st.gc[sl]]
    sel = (st.low_acgt[sl] == 0) & (a > 0)
    ft = np.float32 if prec == "lower" else np.float64
    vals = st.depth[sl][sel].astype(ft) / a[sel].astype(ft)
    if not len(vals):
        return -1.0, 0.0
    v = broken_sort(vals)
    t0 = int(0.1 * len(v))
    t1 = len(v) - t0
    if t1 - t0 <= 0:
        return -1.0, 0.0
    ploidy = ft(g["ploidy"])
    cn = (v[t0:t1].sum() / ft(t1 - t0)) * ploidy
    cs = np.sqrt(((ploidy * v - cn) ** 2).sum() / ft(len(v)))
    return float(cn), float(cs)


# ---------------------------------------------------------------------------
# the expectation of a genome, and the judge
# ---------------------------------------------------------------------------

@dataclass
class Expect:
    contigs: List[Contig]
    snv: Dict[str, SnvExpect]
    cnv: Dict[str, CnvState]
    cnv_rows: Dict[str, List[str]]
    g: dict
    prec: str


def expect(specs: List[dict], g: dict, prec: str = "stated",
           contigs: Optional[List[Contig]] = None) -> Expect:
    contigs = contigs if contigs is not None else replay(specs)
    mean, imax = insert_stats(contigs, g)
    start = scan_start(mean, imax, g)
    snv, cnv, rows = {}, {}, {}
    for c in contigs:
        lists = depth_lists(c, start, g)
        snv[c.name] = snv_expect(c, start, imax, lists[0] + lists[1], g,
                                 prec)
        st = cnv[c.name] = cnv_state(c, lists, mean, g)
        dels, dups = cnvref.cnv_calls(st, c.genome, g, prec)
        rows[c.name] = [cnv_row(c.name, kind, s0, e0, sd, st, g, prec)
                        for kind, calls in (("DEL", dels), ("DUP", dups))
                        for s0, e0, sd in calls
                        if cnvref.sd_to_pvalue(sd) < cnvref.RD_PVAL]
    return Expect(contigs, snv, cnv, rows, g, prec)


def cnv_row(chrom: str, kind: str, start: int, end: int, sd: float,
            st: CnvState, g: dict, prec: str) -> str:
    """A CNV row as GROM writes it: SD, its p-value, CN and CS."""
    cn, cs = copy_number(st, start, end, g, prec)
    return ("%s\t%d\t.\t.\t<%s>\t.\t.\tEND=%d\tSD:Z:CN:CS\t%e:%e:%.2f:%e"
            % (chrom, start + 1, kind, end + 1, sd, cnvref.sd_to_pvalue(sd),
               cn, cs))


def _vcf_rows(text: str) -> List[str]:
    return [ln for ln in text.splitlines() if ln and not ln.startswith("#")]


def judge(vcf: str, ctx: str, ex: Expect) -> Tuple[int, dict]:
    """(rows wrong, counts by kind) of one pass's VCF and .ctx.vcf text
    against the expectation ``ex`` (made at the stated precision)."""
    d = dict(snv_rows=0, snv_wrong=0, snv_extra=0, snv_missing=0,
             cnv_rows=0, cnv_wrong=0, cnv_missing=0, planted_uncalled=0,
             other_rows=0, ctx_rows=len(_vcf_rows(ctx)))
    got_cnv: Dict[str, Counter] = {c.name: Counter() for c in ex.contigs}
    seen: Dict[str, set] = {c.name: set() for c in ex.contigs}
    cnv_calls: Dict[str, list] = {c.name: [] for c in ex.contigs}
    for row in _vcf_rows(vcf):
        f = row.split("\t")
        chrom = f[0]
        if chrom not in seen:
            d["other_rows"] += 1
        elif f[8].startswith("GT:PR:AF:"):
            d["snv_rows"] += 1
            p1 = int(f[1])
            seen[chrom].add(p1)
            want = ex.snv[chrom].rows.get(p1)
            if want is None:
                d["snv_extra"] += 1
            elif strip_pr(row) != want:
                d["snv_wrong"] += 1
        elif f[8] == "SD:Z:CN:CS":
            d["cnv_rows"] += 1
            s0, e0 = int(f[1]) - 1, int(f[7].split("=")[1]) - 1
            cnv_calls[chrom].append((f[4], s0, e0))
            got_cnv[chrom][row] += 1
        else:
            d["other_rows"] += 1
    for c in ex.contigs:
        want = Counter(ex.cnv_rows[c.name])
        d["cnv_wrong"] += sum((got_cnv[c.name] - want).values())
        d["cnv_missing"] += sum((want - got_cnv[c.name]).values())
        d["snv_missing"] += len(ex.snv[c.name].required - seen[c.name])
        for kind, events in (("<DEL>", c.depressions), ("<DUP>", c.hotspots)):
            for ev in events:
                s, e = int(ev[0]), int(ev[1])
                cover = max((min(e, ce) - max(s, cs)
                             for k, cs, ce in cnv_calls[c.name] if k == kind),
                            default=0)
                if cover < 0.5 * (e - s):
                    d["planted_uncalled"] += 1
    wrong = (d["snv_wrong"] + d["snv_extra"] + d["snv_missing"]
             + d["cnv_wrong"] + d["cnv_missing"] + d["other_rows"]
             + d["ctx_rows"])
    return wrong, d


def control_vcf(ex_low: Expect) -> str:
    """The control's VCF: the reference's own rows at the lower precision,
    SNVs at every required site and its CNV rows."""
    rows = []
    for c in ex_low.contigs:
        snv = ex_low.snv[c.name]
        for p1 in sorted(snv.rows):
            head, _, sample = snv.rows[p1].rpartition("\t")
            parts = sample.split(":")
            rows.append(head + "\t" + ":".join(parts[:1] + ["0.000000e+00"]
                                                + parts[1:]))
        rows += ex_low.cnv_rows[c.name]
    return "\n".join(rows) + "\n"
