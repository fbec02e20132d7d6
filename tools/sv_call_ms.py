"""Host milliseconds of one call of the port's SV entry scorer on one CUDA
card: ``SvScorer.__call__`` (numpy in, numpy out: the entries' upload, the
kernel, the copy back and its sync), on seeded entries of the size of the
largest detect window of chip_smoke.py's 24 Mb chromosome, with the real
binomial tables (max_trials 1000, add_factor 6).

    python3 tools/sv_call_ms.py [--repos DIR,...] [--n 59152] [--calls 50]

Each checkout of ``--repos`` runs in a fresh process, in the order given
and then reversed (parent, change, change, parent), so a parent commit
unpacked with ``git archive`` into a gitignored directory is timed beside
the change in one call. Every run's scores must equal the first run's.
Prints one line per run (median, min and max over the calls, after one
warm-up call), the card's name and power limit, and a JSON line with every
run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# run in the checkout's own interpreter process: seeded entries, the
# scorer on cuda:0, one warm-up call, then ``calls`` timed calls
_RUN = r"""
import hashlib, json, sys, time
import numpy as np
from grom_tpu_torch.ops.sv_device import SvScorer
from grom_tpu_torch.stats import binom
n, calls = int(sys.argv[1]), int(sys.argv[2])
mt, af = 1000, 6
rng = np.random.default_rng(5)
pos = np.sort(rng.integers(1000, 24_000_000, n)).astype(np.int64)
etype = rng.integers(1, 11, n).astype(np.int32)
count = rng.integers(0, af * 2 * mt, n).astype(np.int64)
count[::7] = 0
rs = pos - rng.integers(0, 400, n)
re = pos - rng.integers(-100, 300, n)
rd = rng.integers(0, 3 * mt, n).astype(np.int64)
wf, wr, cfh = (rng.integers(0, af * mt, n).astype(np.int64)
               for _ in range(3))
args = (pos, etype, count, rs, re, rd, wf, wr, cfh)
sc = SvScorer(binom.build_mq_table(20, mt), binom.build_hez_table(mt), af,
              mt, 3, 1e-4, 400, 101, "cuda")
out = sc(*args)
ms = []
for _ in range(calls):
    t0 = time.perf_counter()
    sc(*args)
    ms.append(1e3 * (time.perf_counter() - t0))
h = hashlib.sha256(b"".join(np.ascontiguousarray(o).tobytes()
                            for o in out)).hexdigest()
print(json.dumps({"median_ms": float(np.median(ms)), "min_ms": min(ms),
                  "max_ms": max(ms), "scores_sha256": h}))
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repos", default=REPO,
                    help="checkouts to time, comma-separated")
    ap.add_argument("--n", type=int, default=59_152)
    ap.add_argument("--calls", type=int, default=50)
    a = ap.parse_args()
    repos = [os.path.abspath(r) for r in a.repos.split(",")]
    runs = []
    for repo in repos + repos[::-1]:
        env = dict(os.environ, PYTHONPATH=repo + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        r = subprocess.run([sys.executable, "-c", _RUN, str(a.n),
                            str(a.calls)], cwd=repo, env=env,
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise RuntimeError("%s exited %d:\n%s" % (repo, r.returncode,
                                                       r.stderr[-4000:]))
        res = dict(json.loads(r.stdout.strip().splitlines()[-1]),
                   repo=os.path.relpath(repo, REPO), n=a.n)
        if runs and res["scores_sha256"] != runs[0]["scores_sha256"]:
            raise AssertionError("%s scores differ from %s's"
                                 % (res["repo"], runs[0]["repo"]))
        runs.append(res)
        print("SvScorer call %-14s n %d: median %.4f ms (min %.4f, max "
              "%.4f) over %d calls" % (res["repo"], a.n, res["median_ms"],
                                       res["min_ms"], res["max_ms"],
                                       a.calls), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
