"""Binomial CDF lookup tables, reproduced exactly from the reference.

The reference precomputes two (max_trials+1)^2 = 1001x1001 double tables on
first run and caches them as tab-separated "%e" text next to the binary
(src/GROM.c:21134-21586):

* ``hez`` table, p=0.5  — after a post-pass (src/GROM.c:21310-21329) holds the
  LOWER tail P(X <= k) with clamping and a sticky-1 fix.
* ``mq`` table, p=10^(-min_mapq/10) — holds the UPPER tail P(X >= k), with a
  row shortcut that zeroes the remainder of a row once values stall
  (src/GROM.c:21441-21445).

Per (n, k) the reference picks one of three evaluation branches
(src/GROM.c:21234-21296):
  1. Poisson approximation when (n>=20 and p<=0.05) or (n>=100 and n*p<=10),
     with the k-factorial accumulated in a C ``long`` — which *wraps* for
     k>=21. We reproduce the wraparound (int64) bit-for-bit because the mq
     table's cached text depends on it.
  2. Normal approximation (continuity-corrected, A&S erf polynomial) when
     n*p*(1-p) >= 5 and k >= 17 (hez) / 20 (mq) — including the polynomial's
     out-of-domain behavior for negative z.
  3. Exact binomial sum otherwise, with the reference's incremental
     combinations recurrence evaluated in double in the same op order.

Everything is vectorized over n (rows); the k recurrences are a short host
scan. Build time is tens of milliseconds; results are device-resident
constants afterwards.
"""

from __future__ import annotations

import math
import os
from functools import lru_cache

import numpy as np

from grom_tpu_torch.stats.normal import erf_as_np

_SQRT2 = math.sqrt(2.0)


def _poisson_cdf_matrix(n_vals: np.ndarray, p: float, max_k: int,
                        rows_needed: np.ndarray) -> np.ndarray:
    """cdf[n_idx, s] = sum_{k=0}^{s-1} lam^k e^-lam / wrapped_factorial(k),
    replicating C ``long`` overflow in the factorial (src/GROM.c:21237-21249).

    pow/exp go through libm (math.pow/math.exp) rather than numpy's SIMD
    kernels: the deep upper tails are computed as 1-cdf with catastrophic
    cancellation, so a 1-ulp difference in a term is visible in the cached
    table text. Only ``rows_needed`` rows are evaluated.
    """
    lam = n_vals.astype(np.float64) * p  # [N]
    # wrapped factorial: kf[0]=1, kf[1]=1, kf[k]=kf[k-1]*k for k>=2 (int64 wrap)
    kf = np.ones(max_k, dtype=np.int64)
    with np.errstate(over="ignore"):
        for k in range(2, max_k):
            kf[k] = kf[k - 1] * np.int64(k)
    kf_d = kf.astype(np.float64)
    cdf = np.zeros((len(lam), max_k + 1), dtype=np.float64)
    mpow, mexp = math.pow, math.exp
    np_err = np.seterr(all="ignore")  # wrapped factorial can be 0/negative
    for i in np.flatnonzero(rows_needed):
        la = float(lam[i])
        e = mexp(-la)
        run = 0.0
        row = cdf[i]
        for k in range(max_k):
            try:
                run += mpow(la, k) * e / kf_d[k]
            except (OverflowError, ZeroDivisionError):
                run = math.inf if run > 0 else math.nan
            row[k + 1] = run
    np.seterr(**np_err)
    return cdf


def _normal_cdf_matrix(n_vals: np.ndarray, p: float, max_k: int) -> np.ndarray:
    """cdf[n_idx, s] via continuity-corrected normal approx + A&S erf
    (src/GROM.c:21252-21275). Both sign branches reduce to (1-erf(z))/2."""
    n = n_vals.astype(np.float64)[:, None]
    s = np.arange(max_k + 1, dtype=np.float64)[None, :]
    mean = n * p
    stdev = np.sqrt(n * p * (1.0 - p))
    with np.errstate(divide="ignore", invalid="ignore"):
        num_stdevs = (mean - s + 0.5) / stdev
        erf = erf_as_np(num_stdevs / _SQRT2)
    return (1.0 - erf) / 2.0


_INT64_MIN = np.int64(-9223372036854775808)


def _trunc_to_long(x: np.ndarray) -> np.ndarray:
    """C double→long conversion with x86-64 semantics: truncate toward zero;
    NaN/±inf/out-of-range all become INT64_MIN (cvttsd2si behavior). The
    reference declares its combinations accumulator as ``long``
    (src/GROM.c:21154), so every recurrence step truncates — and overflows
    park the accumulator at INT64_MIN. Table parity depends on this."""
    t = np.trunc(x)
    in_range = np.isfinite(t) & (t >= -9.223372036854776e18) & (t < 9.223372036854776e18)
    out = np.full(x.shape, _INT64_MIN, dtype=np.int64)
    safe = np.where(in_range, t, 0.0)
    out[in_range] = safe[in_range].astype(np.int64)
    return out


def _exact_cdf_matrix(n_vals: np.ndarray, p: float, max_k: int,
                      rows_needed: np.ndarray | None = None) -> np.ndarray:
    """cdf[n_idx, s] by the reference's incremental exact sum
    (src/GROM.c:21277-21296), identical floating-point op order — including
    the integer truncation of the ``long`` combinations accumulator.

    For p != 0.5 the (1-p)^(n-k) factor goes through libm (math.pow) on the
    needed rows, since numpy's SIMD pow can differ by 1 ulp (visible through
    the 1-cdf cancellation in the cached table text). For p = 0.5 all powers
    of two are exact and the vectorized path is bit-identical.
    """
    n = n_vals.astype(np.int64)
    N = len(n)
    cdf = np.zeros((N, max_k + 1), dtype=np.float64)
    comb = np.ones(N, dtype=np.int64)
    n_minus_k = n.copy()  # C long
    run = np.zeros(N, dtype=np.float64)
    use_libm = p != 0.5
    if rows_needed is None:
        rows_needed = np.ones(N, dtype=bool)
    need_idx = np.flatnonzero(rows_needed)
    with np.errstate(over="ignore", invalid="ignore"):
        for k in range(max_k):
            nmk_f = n_minus_k.astype(np.float64)
            if use_libm:
                q_pow = np.zeros(N, dtype=np.float64)
                mpow = math.pow
                q = 1.0 - p
                for i in need_idx:
                    q_pow[i] = mpow(q, nmk_f[i])
            else:
                q_pow = np.power(1.0 - p, nmk_f)
            run = run + comb.astype(np.float64) * (p ** k) * q_pow
            cdf[:, k + 1] = run
            if k > 0:
                comb = _trunc_to_long((comb.astype(np.float64) / (k + 1.0)) * nmk_f)
            else:
                comb = comb * n_minus_k  # long * long, no truncation round-trip
            n_minus_k = n_minus_k - 1
    return cdf


def _upper_tail_table(p: float, max_trials: int, normal_min_successes: int,
                      mq_row_shortcut: bool) -> np.ndarray:
    """First-pass table T[n][s] = clamp01(1 - cdf(s)) for s<=n, else 0, with
    per-(n,s) branch choice as in the reference."""
    size = max_trials + 1
    table = np.zeros((size, size), dtype=np.float64)
    n_vals = np.arange(1, size, dtype=np.int64)

    poisson_rows = ((n_vals >= 20) & (p <= 0.05)) | ((n_vals >= 100) & (n_vals * p <= 10))
    npq = n_vals * p * (1.0 - p)

    cdf_p = _poisson_cdf_matrix(n_vals, p, size, poisson_rows)
    cdf_n = _normal_cdf_matrix(n_vals, p, max_trials)
    cdf_e = _exact_cdf_matrix(n_vals, p, max_trials, rows_needed=~poisson_rows)

    s = np.arange(size)[None, :]
    use_poisson = poisson_rows[:, None] & np.ones_like(s, dtype=bool)
    use_normal = (~use_poisson) & (npq >= 5)[:, None] & (s >= normal_min_successes)
    cdf = np.where(use_poisson, cdf_p[:, :size],
                   np.where(use_normal, cdf_n, cdf_e))
    # clamp exactly as the reference: <0 -> 0, >1 -> 1 (NaN passes through)
    cdf = np.where(cdf < 0, 0.0, cdf)
    cdf = np.where(cdf > 1, 1.0, cdf)
    vals = 1.0 - cdf
    # only s <= n are written; the rest stay 0 from initialization
    valid = s <= n_vals[:, None]
    table[1:, :] = np.where(valid, vals, 0.0)

    if mq_row_shortcut:
        # src/GROM.c:21441-21445: scanning s ascending, an entry becomes 0 if
        # the previous stored entry is 0, or the previous two are equal; once
        # triggered it cascades to the end of the row (within s<=n).
        for i, n in enumerate(n_vals):
            row = table[n]
            prev_zero = row[:-1] == 0
            prev2_equal = np.zeros(size - 1, dtype=bool)
            prev2_equal[1:] = row[1:-1] == row[:-2]
            trig = np.flatnonzero((prev_zero | prev2_equal)[: int(n)])
            if len(trig):
                row[trig[0] + 1:int(n) + 1] = 0.0
    return table


_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".cache", "grom_tpu")


def _disk_cached(name: str, builder):
    """Binary .npy cache of a table (the reference caches %e text next to its
    binary, src/GROM.c:21331; we keep a lossless .npy in ~/.cache)."""
    path = os.path.join(_CACHE_DIR, name + ".npy")
    try:
        if os.path.exists(path):
            t = np.load(path)
            if t.shape[0] == t.shape[1]:
                return t
    except Exception:
        pass
    t = builder()
    try:
        os.makedirs(_CACHE_DIR, exist_ok=True)
        tmp = "%s.tmp%d.npy" % (path, os.getpid())
        np.save(tmp, t)
        os.replace(tmp, path)
    except OSError:
        pass
    return t


@lru_cache(maxsize=4)
def build_hez_table(max_trials: int = 1000) -> np.ndarray:
    """p=0.5 table; after the post-pass holds P(X <= k) (src/GROM.c:21310-21329)."""
    return _disk_cached(f"hez_{max_trials}",
                        lambda: _build_hez_table_uncached(max_trials))


def _build_hez_table_uncached(max_trials: int = 1000) -> np.ndarray:
    t = _upper_tail_table(0.5, max_trials, normal_min_successes=17,
                          mq_row_shortcut=False)
    size = max_trials + 1
    out = t.copy()
    # The post-pass loop covers rows 0..max_trials-1 ONLY (src/GROM.c:21310);
    # row max_trials keeps its first-pass upper-tail values.
    out[:-1, :-1] = 1.0 - t[:-1, 1:]
    out[:-1, :-1] = np.where(out[:-1, :-1] < 0, 0.0, out[:-1, :-1])
    out[:-1, -1] = 1.0
    # sticky-1 forward fix: once a stored value equals exactly 1, the rest of
    # the row (through column max_trials-1) is 1
    for r in range(size - 1):
        ones = np.flatnonzero(out[r, :-1] == 1.0)
        if len(ones):
            out[r, ones[0]:] = 1.0
    return out


@lru_cache(maxsize=8)
def build_mq_table(min_mapq: int = 20, max_trials: int = 1000) -> np.ndarray:
    """p=10^(-q/10) table holding P(X >= k) with the row-stall shortcut."""
    def build():
        p = 10.0 ** (-min_mapq / 10.0)
        return _upper_tail_table(p, max_trials, normal_min_successes=20,
                                 mq_row_shortcut=True)
    return _disk_cached(f"mq_{min_mapq}_{max_trials}", build)


# ---------------------------------------------------------------------------
# GROM-compatible text cache (src/GROM.c:21331-21355)
# ---------------------------------------------------------------------------

def table_filename_hez(directory: str, max_trials: int = 1000) -> str:
    return os.path.join(directory, f"GROM_hez_binom_table_{max_trials}.txt")


def table_filename_mq(directory: str, min_mapq: int = 20, max_trials: int = 1000) -> str:
    q = min_mapq if min_mapq > 10 else 10
    return os.path.join(directory, f"GROM_mq_binom_table_{q}_{max_trials}.txt")


def save_table_text(table: np.ndarray, path: str) -> None:
    """Write in the reference's cached format: rows of %e joined by tabs."""
    with open(path, "w") as f:
        for row in table:
            f.write("\t".join("%e" % v for v in row))
            f.write("\n")


def load_table_text(path: str, max_trials: int = 1000) -> np.ndarray:
    size = max_trials + 1
    out = np.zeros((size, size), dtype=np.float64)
    with open(path) as f:
        for r, line in enumerate(f):
            if r >= size:
                break
            out[r, :] = np.array(line.rstrip("\n").split("\t"), dtype=np.float64)
    return out


def lookup_cdf(table: np.ndarray, n: np.ndarray, k: np.ndarray,
               max_trials: int = 1000) -> np.ndarray:
    """Reference lookup semantics (src/GROM.c:11137-11146): when n exceeds
    max_trials, rescale k proportionally with integer division and read the
    last row."""
    n = np.asarray(n, dtype=np.int64)
    k = np.asarray(k, dtype=np.int64)
    over = n > max_trials
    safe_n = np.where(n > 0, n, 1)
    k_idx = np.where(over, k * max_trials // safe_n, k)
    n_idx = np.where(over, max_trials, n)
    k_idx = np.clip(k_idx, 0, max_trials)
    n_idx = np.clip(n_idx, 0, max_trials)
    return table[n_idx, k_idx]
