"""The control of a cell's comparison: the plain reference put in the
program's place, computed in the next precision below the one the
configuration states (AF in bfloat16; the z-scores, null model, seed walk,
averages and copy number in float32), judged as a run's rows are. Its
``rows_wrong`` is the upper reading the limit is set below, and its
``detail`` gives the CNV rows' part apart (``cnv_wrong``, ``cnv_missing``).

    python3 benchmark/control.py --workload <cell> --seeds <n>,<n>,...

prints one JSON line a seed: {"workload", "seed", "rows_wrong", "detail"}.
It needs no card: the reference is NumPy.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import harness  # noqa: E402
import plainref  # noqa: E402


def reading(cell: dict, seed: int) -> dict:
    specs = harness.contig_specs(cell["config"], cell["traffic"], seed)
    grom = cell["config"]["grom"]
    ex = plainref.expect(specs, grom)
    low = plainref.expect(specs, grom, "lower", contigs=ex.contigs)
    wrong, detail = plainref.judge(plainref.control_vcf(low), "", ex)
    return dict(workload=cell["cell"]["name"], seed=seed, rows_wrong=wrong,
                detail=detail)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    for s in args.seeds.split(","):
        print(json.dumps(reading(cell, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
