"""Seeded inputs for the z-score kernel (ops/cnv_device.py ``zscores``)
built to break its count tables and its carried sticky class:
``tests/test_torch_cnv_kernels.py`` holds the plain version to a numpy
reference of the host and to grom_tpu on them, and ``chip_smoke.py`` holds
the CUDA kernel to the plain version on them.

* "short and empty rows": bin rows of 0, 1 and 2 values (the reference
  bisection's n == 2 quirk);
* "keys above vmax": depths past a row's largest value;
* "key_l from the clamp": depths above dup_thr_factor x the bin mean;
* "wide rows": rows reaching far past a small table cap (the tail
  bisection);
* "desert": 2.5 M bases with no class update, so the class of the last
  update before them is carried over hundreds of 2,048-base tiles;
* "far first update": no update before base 1.7 M (class 0 until then).
"""

from __future__ import annotations

import numpy as np

CASES = ("short and empty rows", "keys above vmax", "key_l from the clamp",
         "wide rows", "desert", "far first update")
# the z stage's parameters the cases are made for
MIN_MAPQ, MAPQ_FACTOR, DUP_THR_FACTOR = 20, 0.5, 2


def bin_stats(arrs):
    """(ave, std) of the bin rows, as the host derives them."""
    ave = np.array([a.mean() if len(a) else 0.0 for a in arrs])
    std = np.array([a.std(ddof=1) if len(a) > 1 else 0.0 for a in arrs])
    return ave, std


def zscore_case(case: str, seed: int = 0):
    """Seeded z inputs for one of ``CASES``: (per-base depth int32, mq
    int16, gc int8, low_acgt int8, the 2 nb bin rows, the table cap,
    nb)."""
    rng = np.random.default_rng(seed)
    nb = 6
    sizes = [40, 1, 2, 0, 25, 300, 2, 1, 30, 0, 12, 80]
    arrs = [np.sort(rng.integers(0, 60, s)) for s in sizes]
    cap = 1 << 12
    n = 30_000
    if case == "wide rows":
        # a repeat's depth outliers: rows reaching far past a small cap
        arrs[0] = np.sort(np.concatenate([arrs[0], rng.integers(
            500, 50_000, 40)]))
        arrs[8] = np.sort(np.concatenate([arrs[8], [60, 61, 61, 900]]))
        cap = 24
    if case in ("desert", "far first update"):
        n = 3_000_000
    depth = rng.integers(0, 90, n).astype(np.int32)
    mq = rng.integers(0, 60, n).astype(np.int16)
    gc = rng.integers(0, nb, n).astype(np.int8)
    la = (rng.random(n) < 0.15).astype(np.int8)
    if case == "keys above vmax":
        depth[::3] = rng.integers(60, 5_000, len(depth[::3]))
    if case == "wide rows":
        depth[::2] = rng.integers(0, 60_000, len(depth[::2]))
    if case == "key_l from the clamp":
        # deep bases above dup_f x the bin mean, keyed at the clamp
        depth[::4] = rng.integers(100, 400, len(depth[::4]))
    if case == "desert":
        # no class update over [0.4 M, 2.9 M): low mapq and no depth (no
        # definite class) or outside the ACGT gate, so the class of the
        # last update before it carries over hundreds of tiles
        sl = slice(400_000, 2_900_000)
        depth[sl] = np.where(rng.random(2_500_000) < 0.5, 0, depth[sl])
        mq[sl] = rng.integers(0, 20, 2_500_000)
        la[sl] = np.where(depth[sl] > 0, 1, la[sl])
        # the last update before it is class 1
        mq[399_990:400_000] = 5
        depth[399_990:400_000] = 7
        la[399_990:400_000] = 0
    if case == "far first update":
        # no update before base 1.7 M: the class starts at 0 there
        sl = slice(0, 1_700_000)
        depth[sl] = 0
        mq[sl] = rng.integers(0, 20, 1_700_000)
    return depth, mq, gc, la, arrs, cap, nb
