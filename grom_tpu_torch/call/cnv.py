"""GC-normalized read-depth CNV engine.

Re-expresses the reference's CNV pipeline:
  * reference preprocessing — N segments, dinucleotide repeat runs, and the
    triangular-weighted GC%/ACGT% per base (src/GROM.c:1684-1862), computed
    here with a double-prefix-sum (O(n)) instead of the sliding counters;
  * CNV prep — per-base mean mapq, repeat-bias selection, 10kb
    excessive-coverage block masking → lowvar blocks (src/GROM.c:16633-17130);
  * detect_del_dup — GC-binned depth distributions (systematic stride
    sampling + reservoir overflow), ±2-bin merging, per-base midrank z-scores,
    the null window model, del/dup window growth scans, trimmed-mean copy
    number (src/GROM.c:18228-20357);
  * SD→p-value conversion with the reference's buggy ``t = 1/(1+p+x)``
    polynomial argument (src/GROM.c:17158) and <DEL>/<DUP> emission
    (src/GROM.c:17280-17493).

Faithfulness notes:
  * The reference sorts its double-typed copy-number ratio lists with an
    int comparator (src/GROM.c:20164 + :1105) — i.e. by the LOW 32 BITS of
    each double. We reproduce that exact (stable) ordering.
  * Reservoir sampling uses rand() seeded with time() in the reference, so
    overflow behavior (>100k samples per GC bin) is not reproducible even
    run-to-run there; we use numpy's PCG64 in that regime.
  * The custom bisection helpers (src/GROM.c:21630-21860) are ported
    verbatim — their edge behavior differs from textbook lower/upper bound.
    PROVENANCE: c_bisect_left/right are ~40-line GPL-2-derived algorithm
    ports (GROM, Smith & Grigoriev); parity genuinely requires their
    non-textbook edge behavior, so they are kept with this notice.

The port's copy of grom_tpu/call/cnv.py. Only the device branch of
``detect_del_dup`` differs: with ``engine="torch"`` or ``"mesh"`` the
z-scores, the null window model and the per-seed window math run on the
port's kernels (ops/cnv_device.py) on ``device``, held to the host's bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from grom_tpu_torch.config import DerivedConfig, GromConfig

_A_P = 0.3275911
_A1, _A2, _A3, _A4, _A5 = 0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429


# ---------------------------------------------------------------------------
# Bisection helpers (verbatim ports of src/GROM.c:21630-21860)
# ---------------------------------------------------------------------------

def c_bisect_left(lst, rd, start, end):
    index = start + (end - start) // 2
    low, high = start, end
    while True:
        if index <= start:
            return start if rd <= lst[start] else start + 1
        if index >= end - 1:
            return end - 1 if rd <= lst[end - 1] else end
        if rd <= lst[index]:
            high = index
            index = low + (index - low) // 2
            if high == index:
                return index + 1
        else:
            low = index
            index = index + (high - index) // 2
            if low == index:
                return index + 1


def c_bisect_right(lst, rd, start, end):
    index = start + (end - start) // 2
    low, high = start, end
    while True:
        if index <= start:
            return start if rd < lst[start] else start + 1
        if index >= end - 1:
            return end - 1 if rd < lst[end - 1] else end
        if rd < lst[index]:
            high = index
            index = low + (index - low) // 2
            if high == index:
                return index + 1
        else:
            low = index
            index = index + (high - index) // 2
            if low == index:
                return index + 1


# ---------------------------------------------------------------------------
# Reference preprocessing
# ---------------------------------------------------------------------------

@dataclass
class RefFeatures:
    gc_weighted: np.ndarray    # int per base, 0..100 (0 outside scan range)
    acgt_weighted: np.ndarray
    repeat_types: np.ndarray   # int per repeat run
    repeat_starts: np.ndarray
    repeat_ends: np.ndarray


_REPEAT_PAIRS = [b"AA", b"AC", b"AG", b"AT", b"CC", b"CG", b"CT", b"GG", b"GT", b"TT"]

# repeat-run RLE chunk (bases); test-patchable to exercise the run-carry
_REPEAT_RLE_CHUNK = 16 << 20


def _tri_weighted_native(chrom: np.ndarray, m: int, gc_w: np.ndarray,
                         ac_w: np.ndarray) -> bool:
    """Single-pass native triangular window sums (native/grom_prep.c);
    integer-exact vs the numpy path. True on success."""
    import ctypes

    from grom_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "gn_tri_weighted"):
        return False
    assert gc_w.dtype == np.int8 and ac_w.dtype == np.int8
    c = np.ascontiguousarray(chrom, np.uint8)
    rc = lib.gn_tri_weighted(
        c.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(len(c)),
        ctypes.c_long(m),
        gc_w.ctypes.data_as(ctypes.c_void_p),
        ac_w.ctypes.data_as(ctypes.c_void_p))
    return rc == 0


def preprocess_reference(chrom: np.ndarray, insert_mean: int,
                         min_repeat: int) -> RefFeatures:
    L = len(chrom)
    m = insert_mean
    W = 2 * m - 1
    total = m * m  # triangular weight sum (src/GROM.c:22265-22269)

    def tri_weighted(x):
        # T(p) = sum_{d=-(m-1)}^{m-1} (m-|d|)*x[p+d]
        #      = sum_{k=p-m+1}^{p} window_m(k)   where window_m(k) = sum x[k:k+m]
        # c1[i] = sum x[0:i];  window_m(k) = c1[k+m] - c1[k]
        # S[i] = sum_{j=0}^{i-1} c1[j]  (prefix sums of c1)
        # T(p) = (S[p+m+1] - S[p+1]) - (S[p+1] - S[p-m+1])
        c1 = np.concatenate([[0], np.cumsum(x)])                  # len L+1
        S = np.concatenate([[0], np.cumsum(c1)])                  # len L+2
        out = np.zeros(L, dtype=np.int64)
        lo = m - 1
        hi = L - W  # exclusive
        if hi > lo:
            p = np.arange(lo, hi)
            out[lo:hi] = (S[p + m + 1] - S[p + 1]) - (S[p + 1] - S[p - m + 1])
        return out

    # int8 per-base tracks: values are 0..100 percentages; at 250Mb the
    # int64 versions alone would cost 4GB
    gc_w = np.zeros(L, dtype=np.int8)
    ac_w = np.zeros(L, dtype=np.int8)
    lo, hi = m - 1, L - W
    if hi > lo and not _tri_weighted_native(chrom, m, gc_w, ac_w):
        # fallback only: the int64 masks + prefix sums are ~32B/base
        up = np.where(chrom >= 97, chrom - 32, chrom).astype(np.uint8)
        is_gc = ((up == ord("C")) | (up == ord("G"))).astype(np.int64)
        gc_w[lo:hi] = (100 * tri_weighted(is_gc)[lo:hi] // total
                       ).astype(np.int8)
        is_acgt = (is_gc.astype(bool) | (up == ord("A"))
                   | (up == ord("T"))).astype(np.int64)
        del is_gc
        ac_w[lo:hi] = (100 * tri_weighted(is_acgt)[lo:hi] // total
                       ).astype(np.int8)
        del is_acgt

    # dinucleotide repeat runs (types 0..9) over the same scan range
    r_types: List[int] = []
    r_starts: List[int] = []
    r_ends: List[int] = []
    if hi > lo:
        # 256x256 LUT: one gather instead of 20 mask passes over the
        # chromosome (each pass allocates a fresh L-byte temp — the
        # allocation tax dominates on sandboxed kernels)
        # case-insensitive LUT entries: indexing raw chrom bytes avoids a
        # whole-L uppercase temporary
        lut = np.full((256, 256), 10, dtype=np.int8)
        for t, pair in enumerate(_REPEAT_PAIRS):
            for a in (pair[0], pair[0] + 32):
                for b in (pair[1], pair[1] + 32):
                    lut[a, b] = t
                    lut[b, a] = t
        # Runs of identical type (<10), recorded when length-1 >=
        # min_repeat-1; a run reaching the last scanned position never
        # closes and is dropped, like the sequential scan
        # (src/GROM.c:1727-1764). Chunked RLE with a boundary-run carry:
        # ~75% of positions are change points, so the whole-chromosome
        # change/starts/ends int64 temporaries were ~24B/base (6GB at
        # 240Mb) — per-chunk they are bounded and pool-reused.
        n = hi - lo
        if n > 1:
            _RCHK = _REPEAT_RLE_CHUNK
            carry_start = 0          # relative start of the open run
            carry_type = -1          # -1 = no open run yet
            for c0 in range(0, n, _RCHK):
                c1 = min(c0 + _RCHK, n)
                pcc = lut[chrom[lo + c0:lo + c1],
                          chrom[lo + c0 + 1:lo + c1 + 1]]
                if not len(pcc):
                    continue
                change = np.flatnonzero(pcc[1:] != pcc[:-1]) + 1
                starts = np.concatenate([[0], change])
                ends = np.concatenate([change, [c1 - c0]])
                types = pcc[starts]
                if c0 > 0 and carry_type != int(types[0]):
                    # the carried run closed exactly at the chunk boundary
                    if (carry_type < 10 and c0 < n
                            and c0 - carry_start - 1 >= min_repeat - 1):
                        r_starts.append(lo + carry_start)
                        r_ends.append(lo + c0)
                        r_types.append(carry_type)
                # continue the carried run through the first stretch
                first_start = carry_start if (carry_type == int(types[0])
                                              and c0 > 0) else c0
                starts = starts + c0
                ends = ends + c0
                starts[0] = first_start
                # the trailing run stays open into the next chunk
                carry_start = int(starts[-1])
                carry_type = int(types[-1])
                closed = slice(0, len(starts) - 1) if c1 < n \
                    else slice(0, len(starts))
                s_c, e_c, t_c = starts[closed], ends[closed], types[closed]
                valid = (t_c < 10) & (e_c < n) & \
                    (e_c - s_c - 1 >= min_repeat - 1)
                if valid.any():
                    r_starts.extend(lo + s_c[valid])
                    r_ends.extend(lo + e_c[valid])
                    r_types.extend(t_c[valid].astype(np.int64))
    return RefFeatures(gc_w, ac_w, np.array(r_types, dtype=np.int64),
                       np.array(r_starts, dtype=np.int64),
                       np.array(r_ends, dtype=np.int64))


# ---------------------------------------------------------------------------
# CNV prep: mean mapq, repeat bias, block masking
# ---------------------------------------------------------------------------

@dataclass
class CnvPrep:
    mq_mean: np.ndarray              # caf_rd_mq_list after normalization
    most_biased_repeat: int
    lowvar_blocks: List[Tuple[int, int]]        # z-scan + sampling blocks
    chr_rd_ave: float


def prep_cnv(chrom: np.ndarray, feats: RefFeatures, rd_hi: np.ndarray,
             rd_lo: np.ndarray, rd_mq_sum: np.ndarray, cfg: GromConfig,
             drv: DerivedConfig,
             depth: Optional[np.ndarray] = None) -> CnvPrep:
    L = len(chrom)
    m = drv.insert_mean
    W = 2 * m - 1
    if depth is None:
        depth = rd_hi.astype(np.int32) + rd_lo.astype(np.int32)
    # per-base mean mapq fits int16 (mapq <= 255); computed in bounded
    # chunks — the fancy-indexed whole-chromosome form (rd_mq_sum[nz] //
    # depth[nz]) allocated ~4 full-size temporaries whose first-touch
    # faults dominated this phase. Σmapq <= 255*depth stays in int32.
    mq_mean = np.zeros(len(depth), np.int16)
    _CHK0 = 16 << 20
    for _c0 in range(0, len(depth), _CHK0):
        _c1 = min(_c0 + _CHK0, len(depth))
        d = depth[_c0:_c1]
        q = rd_mq_sum[_c0:_c1] // np.maximum(d, 1)
        mq_mean[_c0:_c1] = np.where(d > 0, q, 0).astype(np.int16)

    # repeat-bias selection (src/GROM.c:16642-16760); mean/stdev of eligible
    # depth in bounded chunks (the whole-chromosome f64 temporaries were
    # ~5GB at 250Mb; partial pairwise sums stay within the SD tolerance the
    # fixtures assert)
    lo, hi = m - 1, L - W
    cnt = 0
    dsum = 0
    CHK = 16 << 20
    for c0 in range(lo, max(hi, lo), CHK):
        c1 = min(c0 + CHK, hi)
        ok = feats.acgt_weighted[c0:c1] >= 99  # g_insert_min_acgt
        cnt += int(ok.sum())
        dsum += int(depth[c0:c1][ok].sum())
    ave = dsum / cnt if cnt else 0.0
    sqsum = 0.0
    for c0 in range(lo, max(hi, lo), CHK):
        c1 = min(c0 + CHK, hi)
        ok = feats.acgt_weighted[c0:c1] >= 99
        dd = depth[c0:c1][ok].astype(np.float64)
        sqsum += float(np.where(dd < 2 * ave, (dd - ave) ** 2,
                                ave * ave).sum())
    stdev = math.sqrt(sqsum / (cnt - 1)) if cnt > 1 else 0.0

    most_biased = -1
    if len(feats.repeat_types):
        n_types = 10
        r_ave = np.zeros(n_types)
        r_cnt = np.zeros(n_types, dtype=np.int64)
        r_vals = []
        for i in range(len(feats.repeat_types)):
            s, e = int(feats.repeat_starts[i]), int(feats.repeat_ends[i])
            v = depth[s:e].sum() / (e - s)
            r_vals.append(v)
            t = int(feats.repeat_types[i])
            r_ave[t] += v if v < 2 * ave else 2 * ave
            r_cnt[t] += 1
        with np.errstate(invalid="ignore"):
            r_ave = np.where(r_cnt > 0, r_ave / np.maximum(r_cnt, 1), np.nan)
        r_std = np.zeros(n_types)
        for i in range(len(feats.repeat_types)):
            t = int(feats.repeat_types[i])
            v = r_vals[i] if r_vals[i] < 2 * ave else 2 * ave
            r_std[t] += (v - r_ave[t]) ** 2
        for t in range(n_types):
            r_std[t] = math.sqrt(r_std[t] / (r_cnt[t] - 1)) if r_cnt[t] > 1 else 0.0
        best_cnt = 0
        for t in range(n_types):
            if r_cnt[t] > 100:  # g_rd_no_combine_min_windows
                if (r_ave[t] + cfg.min_repeat_stdev * r_std[t] < ave
                        and ave - cfg.min_repeat_stdev * stdev > r_ave[t]):
                    if r_cnt[t] > best_cnt:
                        most_biased = t
                        best_cnt = int(r_cnt[t])

    # 10kb excessive-coverage block masking (src/GROM.c:16784-17010);
    # byte-LUT gather on raw chrom (case-insensitive) instead of the
    # two whole-L uppercase copies + four mask passes
    _acgt_lut = np.zeros(256, np.bool_)
    _acgt_lut[np.frombuffer(b"ACGTacgt", np.uint8)] = True
    acgt_base = _acgt_lut[chrom]
    chr_block_total = 0
    block_count = 0
    for _c0 in range(0, L, _CHK0):
        _c1 = min(_c0 + _CHK0, L)
        ab = acgt_base[_c0:_c1]
        chr_block_total += int(depth[_c0:_c1][ab].sum())
        block_count += int(ab.sum())
    chr_rd_ave = chr_block_total / block_count if block_count else 0.0
    threshold = cfg.chr_rd_threshold_factor * chr_rd_ave

    n_blocks = L // cfg.block_unit_size
    U = cfg.block_unit_size
    block_means = (depth[:n_blocks * U].reshape(n_blocks, U)
                   .sum(axis=1, dtype=np.int64) / U)
    over = np.flatnonzero(block_means > threshold)

    # cluster over-blocks (the reference's temp_blocks state machine,
    # src/GROM.c:16847-16900); writes [start, end) block ranges
    masked: List[Tuple[int, int]] = []
    temp_blocks = 0
    t_start = t_end = 0
    cur_written: Optional[Tuple[int, int]] = None
    if len(over) > 1:
        for a in range(1, len(over)):
            if temp_blocks == 0:
                if (temp_blocks + 1) > (over[a] - over[a - 1]) // 4:
                    t_end = over[a] + 1
                    temp_blocks += 1
                else:
                    t_end = over[a - 1] + 1
                t_start = over[a - 1]
                temp_blocks += 1
            else:
                if (temp_blocks + 1) > (over[a - 1] - t_start) // 4:
                    t_end = over[a - 1] + 1
                    temp_blocks += 1
                else:
                    if temp_blocks >= cfg.min_blocks:
                        if cur_written is not None:
                            masked.append(cur_written)
                        cur_written = None
                    temp_blocks = 1
                    t_start = over[a - 1]
                    t_end = over[a - 1] + 1
                if temp_blocks >= cfg.min_blocks:
                    cur_written = (t_start * cfg.block_unit_size,
                                   t_end * cfg.block_unit_size)
    if temp_blocks >= cfg.min_blocks and cur_written is not None:
        masked.append(cur_written)
    elif cur_written is not None and temp_blocks >= cfg.min_blocks:
        masked.append(cur_written)

    # lowvar = complement of masked regions >= g_block_min (10000)
    lowvar: List[Tuple[int, int]] = []
    start = 0
    for (ms, me) in masked:
        if me - ms >= 10000:  # g_block_min
            lowvar.append((start, ms))
            start = me
    lowvar.append((start, L))
    # clamp to scan range and drop short blocks (src/GROM.c:16920-16983)
    clamped = []
    for s, e in lowvar:
        s = min(max(s, m - 1), L - W)
        e = min(max(e, m - 1), L - W)
        if e - s >= cfg.min_rd_window_len:
            clamped.append((s, e))
    return CnvPrep(mq_mean, most_biased, clamped, chr_rd_ave)


# ---------------------------------------------------------------------------
# detect_del_dup
# ---------------------------------------------------------------------------

def build_pval2sd(stdev_step: float = 0.01, sd_max: float = 10.0):
    """src/GROM.c:20714-20748: sd descending from 10, pval ascending.
    Evaluated with libm pow/exp like the reference — numpy's SIMD pow can
    differ in the last ulp, which moves bisect boundaries. The list has
    len+1 entries (src/GROM.c:20718 ``fdd_pval2sd_list_len += 1``): the
    final row is sd=0.0 / p=0.5, reached by near-median depths."""
    n = int(sd_max / stdev_step + 0.5) + 1
    sds = np.empty(n)
    pvals = np.empty(n)
    for i in range(n):
        sd = sd_max - i * stdev_step
        if sd < 0:
            sd = 0.0
        x = sd / math.sqrt(2.0)
        t = 1.0 / (1.0 + _A_P * x)
        erf = 1.0 - ((_A1 * t + _A2 * math.pow(t, 2) + _A3 * math.pow(t, 3)
                      + _A4 * math.pow(t, 4) + _A5 * math.pow(t, 5))
                     * math.exp(-math.pow(x, 2)))
        sds[i] = sd
        pvals[i] = (1.0 - erf) / 2.0
    return pvals, sds


@dataclass
class CnvCall:
    start: int
    end: int
    stdev: float
    cn: float = -1.0
    cn_stdev: float = 0.0
    pvalue: float = 1.0


def _broken_double_sort(vals: np.ndarray) -> np.ndarray:
    """qsort(double array, int comparator) — src/GROM.c:20164 + :1105.

    The comparator reads the LOW 32 BITS of each double as an int and
    subtracts with int32 WRAPAROUND, so it is not even transitive; the
    resulting permutation is whatever glibc's merge sort (msort_with_tmp)
    produces. We emulate that exact top-down merge with the wrapping
    comparator."""
    v = vals.astype(np.float64)
    raw = v.view(np.uint8).reshape(-1, 8)
    key32 = raw[:, :4].copy().view(np.int32).ravel()
    key = key32.astype(np.int64)

    # native emulation of the same merge (differential-tested below)
    from grom_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is not None and hasattr(lib, "gn_broken_sort") and len(v) > 1:
        import ctypes
        idx_out = np.empty(len(v), np.int64)
        lib.gn_broken_sort(key32.ctypes.data_as(ctypes.c_void_p),
                           ctypes.c_long(len(v)),
                           idx_out.ctypes.data_as(ctypes.c_void_p))
        return v[idx_out]

    def cmp_lt(i, j):
        # cmp(b2,b1) < 0  with int32 wraparound subtraction
        d = np.int32(np.int64(key[i]) - np.int64(key[j]))
        return int(d) < 0

    idx = list(range(len(v)))

    def msort(lo, n):
        if n <= 1:
            return
        n1 = n // 2
        n2 = n - n1
        msort(lo, n1)
        msort(lo + n1, n2)
        a = idx[lo:lo + n1]
        b = idx[lo + n1:lo + n]
        out = []
        i = j = 0
        while i < n1 and j < n2:
            if cmp_lt(b[j], a[i]):
                out.append(b[j])
                j += 1
            else:
                out.append(a[i])
                i += 1
        out.extend(a[i:])
        out.extend(b[j:])
        idx[lo:lo + n] = out

    import sys
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    with np.errstate(over="ignore"):
        msort(0, len(v))
    sys.setrecursionlimit(old)
    return v[np.array(idx, dtype=np.int64)] if len(v) else v


def _sample_distributions(chrom: np.ndarray, feats: RefFeatures,
                          prep: CnvPrep, rd_hi: np.ndarray,
                          rd_lo: np.ndarray, cfg: GromConfig,
                          drv: DerivedConfig, ploidy: int,
                          rng: Optional[np.random.Generator] = None,
                          depth: Optional[np.ndarray] = None):
    """GC-bin depth sampling + ±2-bin merge + bin stats/thresholds
    (src/GROM.c:18341-18640). Returns ((hi_arr, lo_arr), ave, std, nwin,
    del_thr, dup_thr) — the distribution inputs of the z-score, null-model
    and window-scan stages (shared by the host, native-C and device
    engines)."""
    m = drv.insert_mean
    if depth is None:
        depth = (rd_hi.astype(np.int32) + rd_lo.astype(np.int32))
    mq = prep.mq_mean
    gc = feats.gc_weighted
    acgt = feats.acgt_weighted
    NB = cfg.num_gc_bins
    cap = cfg.sample_lists_len
    rng = rng or np.random.default_rng(0)
    del_thr_p = 1.0 - 0.6 / ploidy
    dup_thr_p = 1.0 + 0.6 / ploidy

    # ---- GC-bin sampling (src/GROM.c:18341-18460) ----
    hi_samp: List[List[int]] = [[] for _ in range(NB)]
    lo_samp: List[List[int]] = [[] for _ in range(NB)]
    hi_all = np.zeros(NB, dtype=np.int64)
    lo_all = np.zeros(NB, dtype=np.int64)
    stride = m // 2
    # vectorized fast path: stride positions, acgt gate, sticky-class
    # forward fill; bins below the reservoir cap keep samples in position
    # order, so the result is identical to the sequential loop. Bins that
    # overflow the cap need the sequential reservoir (rare: cap=100k).
    P = np.concatenate([np.arange(bs, be, stride, dtype=np.int64)
                        for (bs, be) in prep.lowvar_blocks]) \
        if prep.lowvar_blocks else np.empty(0, np.int64)
    if len(P):
        P = P[acgt[P] >= 99]
    if len(P):
        d_v = depth[P]
        defc = np.where(d_v == 0, -1,
                        np.where(mq[P] >= cfg.min_mapq, 0, 1))
        fi = np.where(defc >= 0, np.arange(len(P)), -1)
        np.maximum.accumulate(fi, out=fi)
        cls_v = np.where(defc >= 0, defc,
                         np.where(fi >= 0, defc[np.maximum(fi, 0)], 0))
        g_v = gc[P]
        key = cls_v * NB + g_v
        bincnt = np.bincount(key, minlength=2 * NB)
        if bincnt.max(initial=0) <= cap:
            order = np.argsort(key, kind="stable")
            ks = key[order]
            ds = d_v[order]
            bounds = np.searchsorted(ks, np.arange(2 * NB + 1))
            for g in range(NB):
                hi_samp[g] = list(ds[bounds[g]:bounds[g + 1]])
                lo_samp[g] = list(ds[bounds[NB + g]:bounds[NB + g + 1]])
            hi_all[:] = bincnt[:NB]
            lo_all[:] = bincnt[NB:]
        else:
            for i in range(len(P)):
                d = int(d_v[i])
                g = int(g_v[i])
                cls = int(cls_v[i])
                samp, alls = ((hi_samp, hi_all) if cls == 0
                              else (lo_samp, lo_all))
                if len(samp[g]) < cap:
                    samp[g].append(d)
                else:
                    if rng.integers(alls[g]) == 0:
                        samp[g][rng.integers(len(samp[g]))] = d
                alls[g] += 1

    hi_arr = [np.sort(np.array(s, dtype=np.int64)) for s in hi_samp]
    lo_arr = [np.sort(np.array(s, dtype=np.int64)) for s in lo_samp]

    # ---- ±2-bin merge for sparse bins (src/GROM.c:18480-18545) ----
    hi_n0 = [len(a) for a in hi_arr]
    lo_n0 = [len(a) for a in lo_arr]
    hi_merged = list(hi_arr)
    lo_merged = list(lo_arr)
    for b in range(2, NB - 2):
        if 20 <= hi_n0[b] < 100:
            ext = [hi_arr[b]] + [hi_arr[a][:hi_n0[a]]
                                 for a in range(b - 2, b + 3) if a != b]
            allv = np.concatenate(ext)[:cap]
            hi_merged[b] = np.sort(allv)
        if 20 <= lo_n0[b] < 100:
            ext = [lo_arr[b]] + [lo_arr[a][:lo_n0[a]]
                                 for a in range(b - 2, b + 3) if a != b]
            allv = np.concatenate(ext)[:cap]
            lo_merged[b] = np.sort(allv)
    hi_arr, lo_arr = hi_merged, lo_merged
    hi_n = [len(a) for a in hi_arr]
    lo_n = [len(a) for a in lo_arr]

    # ---- bin stats and thresholds (src/GROM.c:18560-18640) ----
    ave = np.zeros((2, NB))
    std = np.zeros((2, NB))
    nwin = np.zeros((2, NB), dtype=np.int64)
    del_thr = np.zeros((2, NB))
    dup_thr = np.zeros((2, NB))
    for idx, (arrs, ns) in enumerate(((hi_arr, hi_n), (lo_arr, lo_n))):
        for b in range(NB):
            n = ns[b]
            nwin[idx, b] = n
            if n > 0:
                a = arrs[b].astype(np.float64)
                ave[idx, b] = a.sum() / n
                del_thr[idx, b] = del_thr_p * ave[idx, b]
                dup_thr[idx, b] = dup_thr_p * ave[idx, b]
                if n > 1:
                    std[idx, b] = math.sqrt(
                        ((a - ave[idx, b]) ** 2).sum() / (n - 1))
    return (hi_arr, lo_arr), ave, std, nwin, del_thr, dup_thr


def detect_del_dup(chrom: np.ndarray, feats: RefFeatures, prep: CnvPrep,
                   rd_hi: np.ndarray, rd_lo: np.ndarray, cfg: GromConfig,
                   drv: DerivedConfig, ploidy: int,
                   rng: Optional[np.random.Generator] = None,
                   gen1000_out: Optional[List[str]] = None,
                   depth: Optional[np.ndarray] = None,
                   engine: str = "host", device="cuda"
                   ) -> Tuple[List[CnvCall], List[CnvCall]]:
    L = len(chrom)
    m = drv.insert_mean
    W = 2 * m - 1
    if depth is None:
        depth = (rd_hi.astype(np.int32) + rd_lo.astype(np.int32))
    mq = prep.mq_mean
    gc = feats.gc_weighted
    acgt = feats.acgt_weighted
    NB = cfg.num_gc_bins
    cap = cfg.sample_lists_len
    rng = rng or np.random.default_rng(0)

    from grom_tpu_torch.utils.timing import phase as _ph0
    with _ph0("cnv.sample"):
        (hi_arr, lo_arr), ave, std, nwin, del_thr, dup_thr = \
            _sample_distributions(chrom, feats, prep, rd_hi, rd_lo, cfg, drv,
                                  ploidy, rng=rng, depth=depth)
    hi_n = [len(a) for a in hi_arr]
    lo_n = [len(a) for a in lo_arr]

    # ---- low_acgt_or_windows mask (src/GROM.c:18683-18750) ----
    # chunked: the int64 temporaries here would otherwise cost ~30B/base
    # at once (8GB transient on a 250Mb chromosome); the sticky class
    # carries across chunks via its last value
    low_acgt = np.ones(L, dtype=np.int8)
    scan_lo, scan_hi = m - 1, L - W
    carry_cls = 0
    CHK = 16 << 20
    for c0 in range(scan_lo, max(scan_hi, scan_lo), CHK):
        c1 = min(c0 + CHK, scan_hi)
        if c1 <= c0:
            break
        sl_r = slice(c0, c1)
        ok_acgt = acgt[sl_r] >= 99
        # sticky class: the reference updates last_low ONLY at positions
        # passing the acgt gate (src/GROM.c:18691-18706) — positions below
        # the gate neither read nor advance the class state
        def_cls = np.where(mq[sl_r] >= cfg.min_mapq, 0,
                           np.where(depth[sl_r] > 0, 1, -1))
        def_cls = np.where(ok_acgt, def_cls, -1).astype(np.int8)
        cls_ff = _sticky_ffill(def_cls, carry_cls)
        carry_cls = int(cls_ff[-1]) if len(cls_ff) else carry_cls
        nwin_at = nwin[cls_ff, gc[sl_r]]
        low_acgt[sl_r] = np.where(ok_acgt & (nwin_at >= 100), 0, 1)

    # ---- per-base z-scores (src/GROM.c:18770-18965) ----
    # NOTE: the z loop runs over g_lowvar_block_* which main RESET to the
    # whole chromosome before calling detect_del_dup (src/GROM.c:17123-17125);
    # only the SAMPLING above uses the masked blocks.
    full_blocks = [(m - 1, L - W)]
    pv_p, pv_sd = build_pval2sd()
    pv_len = len(pv_p)
    stdev_list = np.zeros(L)
    mf = cfg.mapq_factor

    # native fast path (native/grom_cnv.c): bit-identical C ports of the
    # z-score, null-model and window-scan stages below; the numpy code
    # remains the differential oracle (tests/test_native_cnv.py)
    if engine in ("torch", "mesh"):
        # the port's kernels (ops/cnv_device.py, csrc/cnv.cu) on ``device``:
        # z-scores (mapq weight included), the null model and the per-seed
        # window math, bitwise equal to the native path below. The repeat
        # rescore, the outer walk and the copy number stay on the host.
        import torch

        from grom_tpu_torch.ops import cnv_device, state
        lo_z, hi_z = full_blocks[0]
        # z on the device, zero outside [lo_z, hi_z): the null model reads
        # it there; the host gets one copy
        z_dev = torch.zeros(L, dtype=torch.float64, device=device)
        if hi_z > lo_z:
            with _ph0("cnv.zscores_dev"):
                tables = state.cnv_tables(list(hi_arr) + list(lo_arr), ave,
                                          std, pv_p, pv_sd, device)
                zin = state.z_inputs(depth, mq, gc, low_acgt, lo_z, hi_z,
                                     device)
                cnv_device.zscores(zin, tables, NB, cfg.min_mapq, mf,
                                   cfg.dup_threshold_factor,
                                   cfg.ranks_stdev != 0, z_dev[lo_z:hi_z])
                torch.from_numpy(stdev_list)[lo_z:hi_z].copy_(
                    z_dev[lo_z:hi_z])
        # the null model reads the PRE-rescore z (src/GROM.c:18975-19015)
        with _ph0("cnv.nullmodel_dev"):
            # in blocks, as the low_acgt mask above: the [L] int64 gathers
            # of nwin would cost 16 bytes a base at once
            gate_nm = np.empty(L, np.bool_)
            for c0 in range(0, L, CHK):
                sl = slice(c0, c0 + CHK)
                gate_nm[sl] = (low_acgt[sl] == 0) & np.where(
                    mq[sl] >= cfg.min_mapq, nwin[0, gc[sl]] > 1,
                    nwin[1, gc[sl]] > 1)
            seg = cnv_device.null_segments(prep.lowvar_blocks,
                                           cfg.max_rd_window_len,
                                           cfg.sampling_rate)
            win_std = cnv_device.null_model(
                z_dev, state.to_device(gate_nm, np.bool_, device), seg,
                cfg.min_rd_window_len, cfg.max_rd_window_len)
        if prep.most_biased_repeat != -1:
            with _ph0("cnv.rescore"):
                _repeat_rescore(feats, prep, depth, low_acgt, acgt,
                                stdev_list, pv_p, pv_sd, cfg, m, rng)
        scan_blocks = [(m - 1, L - W)]
        with _ph0("cnv.winscan_dev"):
            dels = cnv_device.window_scan(scan_blocks, depth, mq, gc, nwin,
                                          low_acgt, stdev_list, del_thr,
                                          win_std, cfg, L, +1, device)
            dups = cnv_device.window_scan(scan_blocks, depth, mq, gc, nwin,
                                          low_acgt, stdev_list, dup_thr,
                                          win_std, cfg, L, -1, device)
        with _ph0("cnv.copynum"):
            _copy_number(dels, dups, depth, mq, gc, low_acgt, ave, ploidy,
                         cfg)
        if gen1000_out is not None and cfg.gen1000_window > 0:
            gen1000_out.extend(_gen1000_track(depth, mq, gc, low_acgt, ave,
                                              ploidy, cfg, L))
        return dels, dups

    nat = _native_cnv_ctx(hi_arr, lo_arr, depth, mq, gc, low_acgt, ave, std,
                          pv_p, pv_sd, NB, cfg)
    if nat is not None:
        from grom_tpu_torch.utils.timing import phase as _ph
        lo_z, hi_z = full_blocks[0]
        if hi_z > lo_z:
            with _ph("cnv.zscores"):
                nat.zscores(lo_z, hi_z, stdev_list)
        # null-model windows are collected from the PRE-rescore z: the
        # reference samples them inside its z loop (src/GROM.c:18975-19015)
        # and the repeat rescore (:19018-19180) runs after
        with _ph("cnv.nullmodel"):
            win_std = nat.null_model(prep.lowvar_blocks, stdev_list)
        if prep.most_biased_repeat != -1:
            with _ph("cnv.rescore"):
                _repeat_rescore(feats, prep, depth, low_acgt, acgt,
                                stdev_list, pv_p, pv_sd, cfg, m, rng)
        scan_blocks = [(m - 1, L - W)]
        with _ph("cnv.winscan"):
            dels = nat.scan(scan_blocks, stdev_list, del_thr, win_std, L, +1)
            dups = nat.scan(scan_blocks, stdev_list, dup_thr, win_std, L, -1)
        with _ph("cnv.copynum"):
            _copy_number(dels, dups, depth, mq, gc, low_acgt, ave, ploidy,
                         cfg)
        if gen1000_out is not None and cfg.gen1000_window > 0:
            gen1000_out.extend(_gen1000_track(depth, mq, gc, low_acgt, ave,
                                              ploidy, cfg, L))
        return dels, dups
    # The reference walks every base keying a (class, gc, depth) z cache
    # (src/GROM.c:18770-18965); we resolve the sticky class vectorized,
    # then evaluate one z per unique key and scatter.
    for (bs, be) in full_blocks:
        if be <= bs:
            continue
        sl = slice(bs, be)
        nloc = be - bs
        hi_mq_v = mq[sl] >= cfg.min_mapq
        gcv = gc[sl]
        eligible = (low_acgt[sl] == 0) & np.where(
            hi_mq_v, nwin[0, gcv] > 1, nwin[1, gcv] > 1)
        defz = np.where(hi_mq_v, 0, np.where(depth[sl] > 0, 1, -1))
        # last_low updates only at eligible definite-class positions
        upd = eligible & (defz >= 0)
        fi = np.where(upd, np.arange(nloc), -1)
        np.maximum.accumulate(fi, out=fi)
        cls_v = np.where(defz >= 0, defz,
                         np.where(fi >= 0, defz[np.maximum(fi, 0)], 0))
        n_hi = np.array(hi_n, dtype=np.int64)
        n_lo = np.array(lo_n, dtype=np.int64)
        n_at = np.where(cls_v == 0, n_hi[gcv], n_lo[gcv])
        valid = eligible & (n_at > 0)
        vi = np.flatnonzero(valid)
        if len(vi) == 0:
            continue
        # composite scalar key (cls,gc,depth) — np.unique on int64 is far
        # cheaper than axis=0 row dedup
        d_v = depth[sl][vi].astype(np.int64)
        dspan = int(d_v.max()) + 1 if len(d_v) else 1
        skeys = (cls_v[vi].astype(np.int64) * 101 + gcv[vi]) * dspan + d_v
        dense = 202 * dspan
        if dense <= (1 << 24):
            # dense-key unique: O(n) presence scan instead of a sort
            present = np.zeros(dense, bool)
            present[skeys] = True
            ukeys = np.flatnonzero(present)
            rank = np.cumsum(present) - 1
            inv = rank[skeys]
        else:
            ukeys, inv = np.unique(skeys, return_inverse=True)
        base = np.empty(len(ukeys))
        kd = (ukeys % dspan).astype(np.int64)
        kg = ((ukeys // dspan) % 101).astype(np.int64)
        kc = (ukeys // (dspan * 101)).astype(np.int64)
        if cfg.ranks_stdev != 0:
            # vectorized midrank z per unique (cls, gc, depth) key: the
            # custom bisects equal np.searchsorted except the one quirk —
            # n == 2 with result 0 returns 1 (verified exhaustively for
            # n <= 8 and randomized to n = 300)
            def _fx(ss, n):
                return np.where(ss == 0, 1, ss) if n == 2 else ss

            for cls in (0, 1):
                for g in np.unique(kg[kc == cls]):
                    midx = np.flatnonzero((kc == cls) & (kg == g))
                    arr = hi_arr[g] if cls == 0 else lo_arr[g]
                    n = hi_n[g] if cls == 0 else lo_n[g]
                    d_u = kd[midx]
                    out = np.empty(len(midx))
                    below = d_u < ave[cls, g]
                    if below.any():
                        dv = d_u[below]
                        bi = _fx(np.searchsorted(arr, dv, "right"), n)
                        bi2 = _fx(np.searchsorted(arr, dv, "left"), n)
                        di = np.where(bi <= 0, 0.5, bi.astype(np.float64))
                        di2 = np.where(bi2 <= 0, 0.5, bi2.astype(np.float64))
                        prob = (di + di2) / (2 * n)
                        pi = np.clip(np.searchsorted(pv_p, prob, "right"),
                                     0, pv_len - 1)
                        out[below] = pv_sd[pi]
                    hi_side = ~below
                    if hi_side.any():
                        dv = d_u[hi_side]
                        clamp = cfg.dup_threshold_factor * ave[cls, g]
                        # int truncation of the clamp key (C int parameter,
                        # src/GROM.c:18867)
                        key_l = np.where(dv > clamp, np.int64(clamp), dv)
                        bi = n - _fx(np.searchsorted(arr, key_l, "left"), n)
                        bi2 = n - _fx(np.searchsorted(arr, dv, "right"), n)
                        di = np.where(bi <= 0, 0.5, bi.astype(np.float64))
                        di2 = np.where(bi2 <= 0, 0.5, bi2.astype(np.float64))
                        prob = (di + di2) / (2 * n)
                        pi = np.clip(np.searchsorted(pv_p, prob, "right"),
                                     0, pv_len - 1)
                        out[hi_side] = -pv_sd[pi]
                    base[midx] = out
        else:
            # -K 0: direct (ave-d)/σ with the 2x-mean dup clamp, one
            # vectorized pass over the unique keys
            # (src/GROM.c:18838-18858, :18920-18940)
            sb = std[kc, kg]
            av = ave[kc, kg]
            with np.errstate(divide="ignore", invalid="ignore"):
                plain = np.where(sb != 0, (av - kd) / sb, 0.0)
                clamped = np.where(
                    sb != 0, (cfg.dup_threshold_factor - 1) * (-av) / sb, 0.0)
            base[:] = np.where(kd > cfg.dup_threshold_factor * av,
                               clamped, plain)
        w = np.where(hi_mq_v[vi],
                     mf + (1.0 - mf) * (mq[sl][vi] - cfg.min_mapq) / 40.0,
                     mf)
        stdev_list[bs + vi] = w * base[inv]

    # ---- null window model (src/GROM.c:18975-19015, 19180-19215) ----
    # BEFORE the repeat rescore: the reference samples its null windows
    # inside the z loop, so win_std reflects the pre-rescore z values
    win_std = _null_window_model(prep, depth, mq, gc, nwin, low_acgt,
                                 stdev_list, cfg, L)

    # ---- repeat rescoring (src/GROM.c:19018-19180) ----
    if prep.most_biased_repeat != -1:
        _repeat_rescore(feats, prep, depth, low_acgt, acgt, stdev_list,
                        pv_p, pv_sd, cfg, m, rng)

    # ---- del/dup window scans ----
    scan_blocks = [(m - 1, L - W)]
    dels = _window_scan(scan_blocks, depth, mq, gc, nwin, low_acgt,
                        stdev_list, del_thr, win_std, cfg, L, side=+1)
    dups = _window_scan(scan_blocks, depth, mq, gc, nwin, low_acgt,
                        stdev_list, dup_thr, win_std, cfg, L, side=-1)

    # ---- copy number (src/GROM.c:20052-20250) ----
    _copy_number(dels, dups, depth, mq, gc, low_acgt, ave, ploidy, cfg)

    # ---- optional fixed-window CN track, -N (src/GROM.c:20244-20345) ----
    if gen1000_out is not None and cfg.gen1000_window > 0:
        gen1000_out.extend(_gen1000_track(depth, mq, gc, low_acgt, ave,
                                          ploidy, cfg, L))
    return dels, dups


def _copy_number(dels, dups, depth, mq, gc, low_acgt, ave, ploidy, cfg):
    """Per-call trimmed-mean copy number (src/GROM.c:20052-20250)."""
    for lst in (dels, dups):
        for c in lst:
            sl = slice(c.start, c.end)
            cls_v = (mq[sl] < cfg.min_mapq).astype(np.int64)
            a_v = ave[cls_v, gc[sl]]
            sel = (low_acgt[sl] == 0) & (a_v > 0)
            vals = depth[sl][sel] / a_v[sel]
            if len(vals):
                v = _broken_double_sort(np.asarray(vals))
                t0 = int(0.1 * len(v))
                t1 = len(v) - t0
                if t1 - t0 > 0:
                    c.cn = (v[t0:t1].sum() / (t1 - t0)) * ploidy
                    c.cn_stdev = math.sqrt(
                        (((ploidy * v - c.cn) ** 2).sum()) / len(v))
                else:
                    c.cn = -1.0
            else:
                c.cn = -1.0


class _NativeCnv:
    """Bound native CNV stage runner (see native/grom_cnv.c)."""

    def __init__(self, lib, dist_vals, dist_off, ave_f, std_f, depth, mq,
                 gc, low_acgt, pv_p, pv_sd, nb, cfg):
        self._lib = lib
        self._keep = (dist_vals, dist_off, ave_f, std_f, pv_p, pv_sd)
        self._depth = depth
        self._mq = mq
        self._gc = gc
        self._lowa = low_acgt
        self._nb = nb
        self._cfg = cfg
        import ctypes
        self._v = ctypes.c_void_p
        self._p = lambda a: a.ctypes.data_as(ctypes.c_void_p)

    def zscores(self, lo, hi, stdev_list):
        cfg = self._cfg
        dist_vals, dist_off, ave_f, std_f, pv_p, pv_sd = self._keep
        self._lib.gn_cnv_zscores(
            int(lo), int(hi), self._p(self._depth), self._p(self._mq),
            self._p(self._gc), self._p(self._lowa), self._p(dist_vals),
            self._p(dist_off), self._p(ave_f), self._p(std_f),
            self._p(pv_p), self._p(pv_sd), len(pv_p), self._nb,
            cfg.min_mapq, float(cfg.mapq_factor),
            float(cfg.dup_threshold_factor),
            1 if cfg.ranks_stdev != 0 else 0, self._p(stdev_list))

    def null_model(self, lowvar_blocks, stdev_list):
        cfg = self._cfg
        _, dist_off, _, _, _, _ = self._keep
        maxw = cfg.max_rd_window_len
        sums = np.zeros(maxw + 1)
        counts = np.zeros(maxw + 1, np.int64)
        blocks = np.asarray(lowvar_blocks, np.int64).reshape(-1)
        self._lib.gn_cnv_null_model(
            self._p(blocks), len(lowvar_blocks), self._p(self._depth),
            self._p(self._mq), self._p(self._gc), self._p(self._lowa),
            self._p(dist_off), self._p(stdev_list), self._nb,
            cfg.min_mapq, cfg.min_rd_window_len, maxw, cfg.sampling_rate,
            self._p(sums), self._p(counts))
        win_std = np.zeros(maxw + 1)
        sel = counts > 1
        win_std[sel] = np.sqrt(sums[sel] / (counts[sel] - 1))
        return win_std

    def scan(self, blocks, stdev_list, thr, win_std, L, side):
        cfg = self._cfg
        _, dist_off, _, _, _, _ = self._keep
        thr_f = np.ascontiguousarray(thr, np.float64).reshape(-1)
        out: List[CnvCall] = []
        for (bs, be0) in blocks:
            cap = 1 << 14
            while True:
                starts = np.empty(cap, np.int64)
                ends = np.empty(cap, np.int64)
                sds = np.empty(cap, np.float64)
                n = int(self._lib.gn_cnv_scan(
                    int(bs), int(be0), self._p(self._depth),
                    self._p(self._mq), self._p(self._gc), self._p(self._lowa),
                    self._p(dist_off), self._p(stdev_list), self._p(thr_f),
                    self._p(win_std), self._nb, cfg.min_mapq,
                    cfg.min_rd_window_len, cfg.max_rd_window_len, int(L),
                    float(cfg.max_rd_low_acgt_or_windows), int(side),
                    self._p(starts), self._p(ends), self._p(sds), cap))
                if n <= cap:
                    break
                cap = n
            for i in range(n):
                out.append(CnvCall(int(starts[i]), int(ends[i]),
                                   float(sds[i])))
        return out


def _native_cnv_ctx(hi_arr, lo_arr, depth, mq, gc, low_acgt, ave, std,
                    pv_p, pv_sd, nb, cfg) -> Optional["_NativeCnv"]:
    """Build the flattened bin-distribution views the native stages index;
    None when the native library is unavailable/disabled."""
    from grom_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "gn_cnv_zscores"):
        return None
    arrs = list(hi_arr) + list(lo_arr)
    lens = np.array([len(a) for a in arrs], np.int64)
    dist_off = np.zeros(2 * nb + 1, np.int64)
    np.cumsum(lens, out=dist_off[1:])
    dist_vals = (np.concatenate(arrs).astype(np.int64, copy=False)
                 if dist_off[-1] else np.zeros(1, np.int64))
    ave_f = np.ascontiguousarray(ave, np.float64).reshape(-1)
    std_f = np.ascontiguousarray(std, np.float64).reshape(-1)
    depth_c = np.ascontiguousarray(depth, np.int32)
    mq_c = np.ascontiguousarray(mq, np.int16)
    gc_c = np.ascontiguousarray(gc, np.int8)
    lowa_c = np.ascontiguousarray(low_acgt, np.int8)
    return _NativeCnv(lib, dist_vals, dist_off, ave_f, std_f, depth_c, mq_c,
                      gc_c, lowa_c, np.ascontiguousarray(pv_p, np.float64),
                      np.ascontiguousarray(pv_sd, np.float64), nb, cfg)


def _gen1000_track(depth, mq, gc, low_acgt, ave, ploidy, cfg, L) -> List[str]:
    """Fixed-window copy-number track (src/GROM.c:20270-20340): per complete
    window of -N bases, trimmed-nothing mean of depth/GC-mean ratios x ploidy
    and its stdev; windows with no usable base print CN -1. The class here is
    direct high/low mapq (no sticky state)."""
    W = cfg.gen1000_window
    ok = low_acgt == 0
    cls = np.where(mq >= cfg.min_mapq, 0, 1)
    a = ave[cls, gc]
    valid = ok & (a > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(valid, depth / np.where(a > 0, a, 1.0), 0.0)
    rows: List[str] = []
    for w in range(L // W):
        sl = slice(w * W, (w + 1) * W)
        v = ratio[sl][valid[sl]]
        cnt = len(v)
        if cnt > 0:
            # cumsum keeps the reference's sequential fp accumulation order
            cn = (float(np.cumsum(v)[-1]) / cnt) * ploidy
            sd = math.sqrt(float(np.cumsum((ploidy * v - cn) ** 2)[-1]) / cnt)
        else:
            cn = -1.0
            sd = 0.0
        rows.append("%d\t%e\t%e" % (w * W, cn, sd))
    return rows


def _sticky_ffill(def_cls: np.ndarray, init: int) -> np.ndarray:
    """Forward-fill -1 entries with the last definite class (initial=init)."""
    out = def_cls.copy()
    idx = np.arange(len(out))
    known = out >= 0
    fill_idx = np.where(known, idx, 0)
    np.maximum.accumulate(fill_idx, out=fill_idx)
    first = np.argmax(known) if known.any() else len(out)
    vals = out[fill_idx]
    vals[:first] = init
    vals[out >= 0] = out[out >= 0]
    return vals


def _repeat_rescore(feats, prep, depth, low_acgt, acgt, stdev_list, pv_p,
                    pv_sd, cfg, m, rng):
    """Repeat-segment distributions + rescoring (src/GROM.c:18294-18340 +
    :19018-19180)."""
    segs = 10  # g_repeat_segments
    cap = cfg.sample_lists_len
    samp: List[List[int]] = [[] for _ in range(segs)]
    alls = np.zeros(segs, dtype=np.int64)
    half = m // 2
    for i in range(len(feats.repeat_types)):
        if feats.repeat_types[i] != prep.most_biased_repeat:
            continue
        rs, re = int(feats.repeat_starts[i]), int(feats.repeat_ends[i])
        for pos in range(rs - half, re + half):
            if pos < 0 or pos >= len(depth) or acgt[pos] < 99:
                continue
            if pos < rs:
                seg = (segs - 1) * (pos - (rs - half)) // half
            elif pos >= re:
                seg = (segs - 1) * ((re + half) - pos) // half
            else:
                seg = segs - 1
            d = int(depth[pos])
            if len(samp[seg]) < cap:
                samp[seg].append(d)
            else:
                if rng.integers(alls[seg]) == 0:
                    samp[seg][rng.integers(len(samp[seg]))] = d
            alls[seg] += 1
    arrs = [np.sort(np.array(s, dtype=np.int64)) for s in samp]
    seg_ave = np.zeros(segs)
    for s in range(segs):
        n = len(arrs[s])
        if n > 0:
            t0 = n // 20
            t1 = n - t0
            seg_ave[s] = arrs[s][t0:t1].sum() / (t1 - t0) if t1 > t0 else 0.0
    pv_len = len(pv_p)
    for i in range(len(feats.repeat_types)):
        if feats.repeat_types[i] != prep.most_biased_repeat:
            continue
        rs, re = int(feats.repeat_starts[i]), int(feats.repeat_ends[i])
        for pos in range(rs - half, re + half):
            if pos < 0 or pos >= len(depth):
                continue
            if pos < rs:
                seg = (segs - 1) * (pos - (rs - half)) // half
            elif pos >= re:
                seg = (segs - 1) * ((re + half) - pos) // half
            else:
                seg = segs - 1
            if low_acgt[pos] != 0:
                continue
            n = len(arrs[seg])
            if n == 0:
                continue
            d = int(depth[pos])
            if d < seg_ave[seg]:
                bi = c_bisect_right(arrs[seg], d, 0, n)
                bi2 = c_bisect_left(arrs[seg], d, 0, n)
                sign = 1.0
            else:
                if d > cfg.dup_threshold_factor * seg_ave[seg]:
                    # int-truncated key, as above (src/GROM.c:19131-analog)
                    bi = c_bisect_left(arrs[seg], int(cfg.dup_threshold_factor * seg_ave[seg]), 0, n)
                else:
                    bi = c_bisect_left(arrs[seg], d, 0, n)
                bi2 = c_bisect_right(arrs[seg], d, 0, n)
                bi, bi2 = n - bi, n - bi2
                sign = -1.0
            di = 0.5 if bi <= 0 else float(bi)
            di2 = 0.5 if bi2 <= 0 else float(bi2)
            prob = (di + di2) / (2 * n)
            pi = c_bisect_right(pv_p, prob, 0, pv_len)
            pi = min(max(pi, 0), pv_len - 1)
            stdev_list[pos] = sign * pv_sd[pi]


def _null_window_model(prep, depth, mq, gc, nwin, low_acgt, stdev_list, cfg, L):
    """Per-length null window stdev (RMS) from sampled windows
    (src/GROM.c:18975-19015 + :19180-19215)."""
    maxw = cfg.max_rd_window_len
    minw = cfg.min_rd_window_len
    sums = np.zeros(maxw + 1)
    counts = np.zeros(maxw + 1, dtype=np.int64)

    hi_mq = mq >= cfg.min_mapq
    gate = (low_acgt == 0) & np.where(hi_mq, nwin[0, gc] > 1, nwin[1, gc] > 1)
    zg = np.where(gate, stdev_list, 0.0)
    cg = gate.astype(np.int64)

    # NOTE: the reference resets the window accumulators per BLOCK, not per
    # phase (src/GROM.c:18790-18800 vs :18975): phase 1 inherits phase 0's
    # unfinished window, which shifts all later window boundaries. Reproduce
    # by carrying (window_len, z_total, gated_count) across phases.
    for (bs, be) in prep.lowvar_blocks:
        wl0 = 0
        tot0 = 0.0
        cnt0 = 0
        for phase in range(cfg.sampling_rate):
            adj = phase * maxw // cfg.sampling_rate
            s = bs + adj
            while s < be:
                room = maxw - wl0
                e = min(s + room, be)
                n_seg = e - s
                zc = tot0 + np.concatenate([[0.0], np.cumsum(zg[s:e])])
                cc = cnt0 + np.concatenate([[0], np.cumsum(cg[s:e])])
                lens = np.arange(wl0 + 1, wl0 + n_seg + 1)
                rec = lens >= minw
                if rec.any():
                    li = lens[rec]
                    vals_cnt = cc[1:][rec]
                    ok = vals_cnt > 0
                    v = np.zeros(len(li))
                    v[ok] = zc[1:][rec][ok] / vals_cnt[ok]
                    sums[li[ok]] += v[ok] ** 2
                    counts[li[ok]] += 1
                if wl0 + n_seg < maxw:
                    # block (phase segment) ended mid-window: carry state
                    wl0 += n_seg
                    tot0 = float(zc[-1])
                    cnt0 = int(cc[-1])
                    break
                # window completed exactly at maxw: reset and continue
                wl0 = 0
                tot0 = 0.0
                cnt0 = 0
                s = e

    win_std = np.zeros(maxw + 1)
    for w in range(minw, maxw + 1):
        if counts[w] > 1:
            win_std[w] = math.sqrt(sums[w] / (counts[w] - 1))
    return win_std


def _window_scan(blocks, depth, mq, gc, nwin, low_acgt, stdev_list,
                 thr, win_std, cfg, L, side: int) -> List[CnvCall]:
    """Vectorized window growth scan, semantically identical to
    the reference scan (src/GROM.c:19358-20035) — differential-tested against
    the GPL-derived oracle port in grom_tpu/testing/cnv_oracle.py.

    The reference walks every base and, per seed, every base of the grow
    window — O(L + seeds*maxw) Python-level steps. Here the outer walk
    jumps between precomputed seed candidates (class-resolved lazily via
    forward-filled last-definite-class indices, reproducing the sticky
    ``mq_index``/``last_low`` state), and the minw/grow inner loops are
    evaluated as cumulative-sum array expressions per seed. The rare
    slide/trim phases stay as direct loops."""
    minw = cfg.min_rd_window_len
    maxw = cfg.max_rd_window_len
    min_sd = 3.0  # g_one_base_read_depth_min_rd_low_stdev
    max_low = cfg.max_rd_low_acgt_or_windows
    max_dist = maxw + 500  # g_max_distance_since_last_del_good
    out: List[CnvCall] = []

    # compact dtypes — every full-length temp here is alive at once and a
    # 250Mb chromosome would pay 2GB per int64 array (positions fit int32,
    # classes int8)
    idx = np.arange(L, dtype=np.int32)
    defc = np.where(mq >= cfg.min_mapq, np.int8(0),
                    np.where(depth > 0, np.int8(1), np.int8(-1)))
    # index of last position <= p with a definite class (ungated / gated)
    ld_all = np.where(defc >= 0, idx, np.int32(-1))
    np.maximum.accumulate(ld_all, out=ld_all)
    lowa = low_acgt == 0
    ld_gated = np.where(lowa & (defc >= 0), idx, np.int32(-1))
    np.maximum.accumulate(ld_gated, out=ld_gated)
    defc_safe = defc[np.maximum(ld_all, 0)]
    defg_safe = defc[np.maximum(ld_gated, 0)]
    del idx
    if side > 0:
        sok0 = depth <= thr[0, gc]
        sok1 = depth <= thr[1, gc]
    else:
        sok0 = depth >= thr[0, gc]
        sok1 = depth >= thr[1, gc]
    cand = np.where(defc == 0, sok0,
                    np.where(defc == 1, sok1, sok0 | sok1))
    svals = side * stdev_list
    lowa_i = lowa.astype(np.int8)

    def gated_cls(p, start, fallback):
        q = ld_gated[p]
        return int(defc[q]) if q >= start else fallback

    for (bs, be0) in blocks:
        be = be0 - minw
        if be <= bs:
            continue
        cand_idx = np.flatnonzero(cand[bs:be]) + bs
        run_start = bs   # first position of the current contiguously-visited run
        ll0 = 0          # last_low value on entry to run_start
        i = 0
        n_cand = len(cand_idx)
        while i < n_cand:
            pos = int(cand_idx[i])
            # outer sticky class at pos (src/GROM.c:19366-19380)
            dc = defc[pos]
            if dc >= 0:
                mq_index = int(dc)
            else:
                q = ld_all[pos]
                mq_index = int(defc[q]) if q >= run_start else ll0
            sok_cls = sok0 if mq_index == 0 else sok1
            if not sok_cls[pos]:
                i += 1
                continue

            # ---- seed accepted: evaluate minw + grow windows as arrays ----
            # the first-window loop always covers [pos, pos+minw); the grow
            # loop stops at pa >= be (src/GROM.c:19504). Two-tier: evaluate a
            # capped prefix first — the fail index depends only on data
            # before it, so a capped result is valid whenever the first fail
            # lands inside the cap (the common case: most seeds die within a
            # few hundred bases); only surviving seeds pay the full maxw-wide
            # arrays.
            n = max(minw, min(maxw, be - pos))
            n_eval = min(n, max(2 * minw, 512))
            while True:
                w_end = pos + n_eval
                qg = ld_gated[pos:w_end]
                cls_w = np.where(qg >= pos, defg_safe[pos:w_end], mq_index)
                sok_w = np.where(cls_w == 0, sok0[pos:w_end], sok1[pos:w_end])
                lowa_w = lowa[pos:w_end]
                inc = lowa_w & sok_w
                wl = np.arange(1, n_eval + 1, dtype=np.int64)
                lc2 = np.cumsum(inc)
                lc2_excl = lc2 - inc
                fail = (~inc) & (2 * lc2_excl < wl)
                fail_idx = np.flatnonzero(fail)
                f1 = int(fail_idx[0]) if len(fail_idx) else n_eval
                if f1 < n_eval or n_eval == n:
                    break
                n_eval = n
            n = n_eval

            stop_base = False
            begin = False
            c_start = c_end = 0
            c_sd = 0.0
            last_good = 0
            temp_pos = pos
            next_pos = pos + 1

            if f1 < minw:
                # stopped inside the first window (src/GROM.c:19420-19435)
                stop_base = True
                temp_pos = pos + f1
                next_pos = temp_pos + 1
            else:
                # first-window check (src/GROM.c:19440-19470)
                low_count0 = int(lowa_i[pos:pos + minw].sum())
                # cumsum, not sum: keeps the reference's sequential fp
                # accumulation order so c_sd matches to the last ulp
                low_total0 = float(np.cumsum(svals[pos:pos + minw])[-1])
                if (low_count0 > 0 and win_std[minw] > 0
                        and low_total0 / (low_count0 * win_std[minw]) >= min_sd
                        and (minw - low_count0) / minw <= max_low):
                    begin = True
                    c_start = pos
                    last_good = pos + minw
                    c_end = pos + minw
                    c_sd = low_total0 / (low_count0 * win_std[minw])

                # grow segment [minw, f2) with cumulative totals
                f2 = f1  # first fail overall (>= minw here)
                g_end = min(f2, n)
                if g_end > minw:
                    gsl = slice(pos + minw, pos + g_end)
                    # seed the cumsum with low_total0 so the fp adds happen
                    # in the reference's ((t0+s1)+s2)+... association
                    lt = np.cumsum(np.concatenate(
                        [[low_total0], np.where(lowa[gsl], svals[gsl], 0.0)]))[1:]
                    lc = low_count0 + np.cumsum(lowa_i[gsl])
                    wlg = wl[minw:g_end]
                    ws = win_std[wlg]
                    with np.errstate(divide="ignore", invalid="ignore"):
                        ts = np.where((lc > 0) & (ws > 0),
                                      lt / (lc * ws), 0.0)
                    good = (inc[minw:g_end] & (ws > 0)
                            & (ts >= min_sd)
                            & ((wlg - lc) / wlg <= max_low))
                    gi = np.flatnonzero(good)
                    if len(gi):
                        pa_good = pos + minw + gi
                        if not begin:
                            begin = True
                            c_start = pos
                        last_good = int(pa_good[-1])
                        c_end = last_good
                        c_sd = max(c_sd, float(ts[gi].max()))
                if f2 < n:
                    stop_base = True          # fail inside grow: no temp_pos
                elif n < maxw:
                    stop_base = True          # hit be (src/GROM.c:19504)
                # gated sticky mq-class after the last processed position
                lp = pos + f2 if f2 < n else pos + n - 1
                mqi = gated_cls(lp, pos, mq_index)

                if not stop_base and begin:
                    c_end, c_sd, last_good, mqi = _slide_phase(
                        pos, maxw, L, max_dist, last_good, c_end, c_sd, mqi,
                        mq, depth, lowa, nwin, gc, svals, win_std, cfg,
                        min_sd, max_low)
                if begin:
                    c_end, trim_pos = _trim_phase(
                        c_start, c_end, minw, mqi, mq, depth, lowa,
                        sok0, sok1, cfg, max_low)
                    out.append(CnvCall(c_start, c_end, c_sd))
                    next_pos = c_end + 2
                elif stop_base:
                    next_pos = temp_pos + 1
                else:
                    next_pos = pos + 1

            if stop_base and not begin:
                next_pos = temp_pos + 1
            # carry the outer sticky state across the jump
            q = ld_all[pos]
            ll0 = int(defc[q]) if q >= run_start else ll0
            run_start = next_pos
            i = int(np.searchsorted(cand_idx, next_pos))
    return out


def _slide_phase(pos, maxw, L, max_dist, last_good, c_end, c_sd, mqi,
                 mq, depth, lowa, nwin, gc, svals, win_std, cfg,
                 min_sd, max_low):
    """Max-window slide extension (src/GROM.c:19510-19600); rare, kept as a
    direct loop with the reference's stale sticky-class semantics."""
    pa = pos + maxw
    s_total = 0.0
    s_count = 0
    mqb = mqi
    while pa < L and (pa - last_good) <= max_dist:
        if pa == pos + maxw:
            for pb in range(pa - maxw + 1, pa + 1):
                if mq[pb] >= cfg.min_mapq:
                    mqb = 0
                elif depth[pb] > 0:
                    mqb = 1
                if lowa[pb] and nwin[mqb, gc[pb]] > 1:
                    s_total += svals[pb]
                    s_count += 1
        else:
            pb = pa - maxw
            if mq[pb] >= cfg.min_mapq:
                mqb = 0
            elif depth[pb] > 0:
                mqb = 1
            if lowa[pb] and nwin[mqb, gc[pb]] > 1:
                s_total -= svals[pb]
                s_count -= 1
            if mq[pa] >= cfg.min_mapq:
                mqi = 0
            elif depth[pa] > 0:
                mqi = 1
            if lowa[pa] and nwin[mqi, gc[pa]] > 1:
                s_total += svals[pa]
                s_count += 1
        if (s_count > 0 and win_std[maxw] > 0
                and s_total / (s_count * win_std[maxw]) >= min_sd
                and (maxw - s_count) / maxw <= max_low):
            last_good = pa
            c_end = pa
            ts = s_total / (s_count * win_std[maxw])
            if ts > c_sd:
                c_sd = ts
        pa += 1
    return c_end, c_sd, last_good, mqi


def _trim_phase(c_start, c_end, minw, mqi, mq, depth, lowa, sok0, sok1,
                cfg, max_low):
    """Trailing trim (src/GROM.c:19585-19660); bounded by the call length."""
    pos = c_end
    while pos > c_start + minw:
        if mq[pos] >= cfg.min_mapq:
            mqi = 0
        elif depth[pos] > 0:
            mqi = 1
        sok = sok0 if mqi == 0 else sok1
        if not sok[pos]:
            pos -= 1
            c_end = pos
        else:
            lc2 = 0
            lc3 = 0
            pa = c_end
            mqa = mqi
            stop_w = False
            while pa > c_start + minw and not stop_w:
                if lowa[pa]:
                    if mq[pa] >= cfg.min_mapq:
                        mqa = 0
                    elif depth[pa] > 0:
                        mqa = 1
                    lc3 += 1
                    soka = sok0 if mqa == 0 else sok1
                    if soka[pa]:
                        lc2 += 1
                if (lc3 == 0 or (lc3 > 0 and lc2 / lc3 < 0.5)
                        or (c_end - pa + 1 - lc3) / (c_end - pa + 1.0) > max_low):
                    c_end = pa - 1
                    stop_w = True
                pa -= 1
            pos = pa
    return c_end, pos


# ---------------------------------------------------------------------------
# P-values and emission (src/GROM.c:17146-17500)
# ---------------------------------------------------------------------------

def sd_to_pvalue(sd: float) -> float:
    """The reference's SD→p conversion with its buggy t = 1/(1+p+x)
    (src/GROM.c:17158)."""
    x = abs(sd) / math.sqrt(2.0)
    t = 1.0 / (1.0 + _A_P + x)
    erf = 1.0 - (_A1 * t + _A2 * t**2 + _A3 * t**3 + _A4 * t**4 + _A5 * t**5) * math.exp(-x**2)
    return (1.0 - erf) / 2.0


def format_cnv_rows(chr_name: str, dels: List[CnvCall], dups: List[CnvCall],
                    cfg: GromConfig) -> List[str]:
    """CNV emission (src/GROM.c:17344-17470). In tabular mode each section
    (DEL, then DUP) is preceded by its own column-header line — printed even
    when the section is empty (src/GROM.c:17247, :17380) — and rows use
    "DEL RD"/"DUP RD" type tags with 0-based coordinates and %e copy
    numbers (src/GROM.c:17364, :17419)."""
    from grom_tpu_torch.vcfio.tabular import CNV_HEADER
    rows = []
    for lst, tag in ((dels, "DEL"), (dups, "DUP")):
        if not cfg.vcf_output:
            rows.append(CNV_HEADER)
        for c in lst:
            c.pvalue = sd_to_pvalue(c.stdev)
        for c in lst:
            if c.pvalue < cfg.rd_pval_threshold:
                if not cfg.vcf_output:
                    rows.append("%s RD\t%s\t%d\t%d\t%e\t%e\t%e\t%e"
                                % (tag, chr_name, c.start, c.end, c.stdev,
                                   c.pvalue, c.cn, c.cn_stdev))
                else:
                    rows.append(
                        "%s\t%d\t.\t.\t<%s>\t.\t.\tEND=%d\tSD:Z:CN:CS\t%e:%e:%.2f:%e"
                        % (chr_name, c.start + 1, tag, c.end + 1, c.stdev,
                           c.pvalue, c.cn, c.cn_stdev))
    return rows


def call_cnv(chrom: np.ndarray, rd_hi: np.ndarray, rd_lo: np.ndarray,
             rd_mq_sum: np.ndarray, cfg: GromConfig, drv: DerivedConfig,
             chr_name: str, is_chrx: bool = False,
             gen1000_out: Optional[List[str]] = None,
             engine: str = "host", release=None,
             device="cuda") -> List[str]:
    """Full CNV pipeline for one chromosome. rd_mq_sum is the raw per-base
    mapq sum (normalized to mean in here, mirroring src/GROM.c:16637).
    When -N is set, the fixed-window CN track rows land in gen1000_out.
    With ``engine="torch"`` or ``"mesh"`` the CNV kernels run on
    ``device``.

    NOTE (-g 1 chrX ploidy): the reference INTENDS to halve ploidy for a
    male X (src/GROM.c:17024-17035) but the name it compares,
    caf_bam_name, is only ever initialized inside the unreachable
    tumor-SV block (src/GROM.c:1593, :1998-2001; no getopt flag reaches
    g_tumor_sv_index) — at :17024 it is uninitialized stack memory, so
    the comparison never matches and ploidy is NEVER halved in practice
    (verified empirically: the binary's -g 1 output on a chrX chromosome
    is byte-identical to -g 0, tests/data/cnvrich oracle.male). We
    reproduce the shipped behavior; ``is_chrx`` is kept in the signature
    for a future --fix-gender mode."""
    del is_chrx  # see NOTE: the reference's halving is dead code
    from grom_tpu_torch.utils.timing import phase
    ploidy = cfg.ploidy
    with phase("cnv.prep_ref"):
        feats = preprocess_reference(chrom, drv.insert_mean, cfg.min_repeat)
    # one output temporary; astype(int32) on already-int32 inputs copied
    # the chromosome twice more
    depth = np.add(rd_hi, rd_lo, dtype=np.int32)
    with phase("cnv.prep"):
        prep = prep_cnv(chrom, feats, rd_hi, rd_lo, rd_mq_sum, cfg, drv,
                        depth=depth)
    # from here on only (depth, mq_mean) per-base inputs are needed —
    # release the three caf_rd_* lists (3GB at 250Mb) before the z-score /
    # null-model / window-scan stages peak
    del rd_hi, rd_lo, rd_mq_sum
    if release is not None:
        release()
    dels, dups = detect_del_dup(chrom, feats, prep, None, None, cfg, drv,
                                ploidy, gen1000_out=gen1000_out, depth=depth,
                                engine=engine, device=device)
    return format_cnv_rows(chr_name, dels, dups, cfg)
