"""The cnvmany dataset recipe: a CNV-dense 3Mb chromosome whose
reference-GROM oracle emits DOZENS of <DEL>/<DUP> rows (31 in default mode,
29 under -K 0) — approximating the tilapia golden file's scale (127 RD DELs;
its BAM blob is missing upstream, so live-oracle fixtures substitute,
SURVEY §4). Events span GC-composition blocks, repeat runs and both CNV
polarity classes.

The dataset is fully deterministic (bulk_sim + fixed seed), so only the
oracle VCFs are committed (tests/data/cnvmany); tests regenerate the
BAM/FASTA on the fly. tools/make_cnvmany.py refreshes the oracles against
the reference binary."""

from __future__ import annotations

from typing import Tuple

LENGTH = 3_000_000
SEED = 31
COVERAGE = 25.0

DEPRESSIONS = [
    (60_000 + i * 100_000, 60_000 + i * 100_000 + w, k)
    for i, (w, k) in enumerate(
        [(4000, 0.30), (9000, 0.35), (3000, 0.25), (14000, 0.40),
         (5000, 0.30), (8000, 0.28), (3500, 0.35), (11000, 0.32),
         (4500, 0.25), (7000, 0.40), (6000, 0.28), (12000, 0.35),
         (3800, 0.30), (9500, 0.28), (5200, 0.25), (8800, 0.35),
         (4200, 0.30), (10500, 0.40), (6400, 0.28), (7600, 0.32),
         (5600, 0.30), (8200, 0.35), (4700, 0.25), (9100, 0.38),
         (6800, 0.30), (11500, 0.35), (5100, 0.28), (7900, 0.32)])
]
# duplication-like hotspots (extra_cov is in absolute depth units:
# +22..32 on a 25x base -> CN ~3.8-4.6)
HOTSPOTS = [
    (110_000 + i * 320_000, 110_000 + i * 320_000 + w, x)
    for i, (w, x) in enumerate(
        [(5000, 28.0), (8000, 24.0), (4000, 32.0), (10000, 25.0),
         (6000, 30.0), (9000, 22.0), (5500, 27.0), (7500, 31.0)])
]
GC_BLOCKS = [(i * 250_000, (i + 1) * 250_000, frac)
             for i, frac in enumerate([0.30, 0.60, 0.42, 0.55, 0.35,
                                       0.65, 0.48, 0.38, 0.52, 0.33,
                                       0.58, 0.45])]
REPEATS = [(2_700_000 + i * 9_000, 2_700_000 + i * 9_000 + 600, b"AC")
           for i in range(30)]

ORACLE_FLAGS = ["-V", "0.0001"]


def build(prefix: str, level: int = 1) -> Tuple[str, str]:
    """Deterministically (re)generate the cnvmany .fa/.bam/.bai.
    Returns (fa, bam)."""
    from grom_tpu_torch.testing.bulk_sim import bulk_dataset
    return bulk_dataset(prefix, LENGTH, coverage=COVERAGE, seed=SEED,
                        snp_rate=2e-4, depressions=DEPRESSIONS,
                        hotspots=HOTSPOTS, gc_blocks=GC_BLOCKS,
                        repeats=REPEATS, level=level, chrom_name="chrcnv")
