"""Normal-distribution helpers: the Abramowitz-Stegun erf polynomial and the
p-value↔SD lookup used throughout the caller.

The reference evaluates erf via A&S 7.1.26 everywhere (e.g. src/GROM.c:21589-21626,
:17146-17170, :20735-20748). We reproduce the exact polynomial — including its
behavior for negative arguments, where the reference applies the same formula
outside its valid domain (src/GROM.c:21262-21272) — because table values and
p-values must match numerically.
"""

from __future__ import annotations

import math

import numpy as np

# A&S 7.1.26 constants (src/GROM.c:21157-21162)
_P = 0.3275911
_A1 = 0.254829592
_A2 = -0.284496736
_A3 = 1.421413741
_A4 = -1.453152027
_A5 = 1.061405429


def erf_as(x: float) -> float:
    """Scalar A&S erf approximation, exactly as the reference computes it.

    Valid for x >= 0; for x < 0 this deliberately reproduces the reference's
    out-of-domain evaluation (t can blow up), since cached-table parity
    depends on it.
    """
    t = 1.0 / (1.0 + _P * x)
    return 1.0 - (_A1 * t + _A2 * t**2 + _A3 * t**3 + _A4 * t**4 + _A5 * t**5) * math.exp(-(x**2))


def erf_as_np(x: np.ndarray) -> np.ndarray:
    """Vectorized A&S erf (float64), same out-of-domain semantics as erf_as."""
    x = np.asarray(x, dtype=np.float64)
    t = 1.0 / (1.0 + _P * x)
    poly = _A1 * t + _A2 * t**2 + _A3 * t**3 + _A4 * t**4 + _A5 * t**5
    return 1.0 - poly * np.exp(-(x**2))


def upper_tail_pvalue(num_stdevs: np.ndarray) -> np.ndarray:
    """P(Z >= num_stdevs) with the reference's formula (both branches of
    src/GROM.c:21258-21273 algebraically reduce to (1-erf(x/sqrt(2)))/2)."""
    return (1.0 - erf_as_np(np.asarray(num_stdevs) / math.sqrt(2.0))) / 2.0


def build_pval2sd_table(stdev_step: float = 0.01, max_sd: float = 10.0):
    """The p-value → SD table built per run (src/GROM.c:20735-20748):
    SD values 0, step, 2*step, ... with two-sided... actually one-sided upper
    tail p for each SD; later bisected to convert window p-values into SD
    scores. Returns (pvals_desc, sds_asc) as float64 arrays.
    """
    sds = np.arange(0.0, max_sd + stdev_step / 2, stdev_step, dtype=np.float64)
    pvals = upper_tail_pvalue(sds)
    return pvals, sds


def pval_to_sd(pvals: np.ndarray, table_p: np.ndarray, table_sd: np.ndarray) -> np.ndarray:
    """Convert p-values to SD scores via the run table (monotone decreasing
    table_p). Equivalent to the reference's bisection over its list."""
    # table_p is decreasing; searchsorted needs increasing -> search on reversed
    idx = np.searchsorted(-table_p, -np.asarray(pvals), side="left")
    idx = np.clip(idx, 0, len(table_sd) - 1)
    return table_sd[idx]
