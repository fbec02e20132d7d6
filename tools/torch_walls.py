"""Wall seconds of the 24 Mb / 30x chromosome of chip_smoke.py on every
engine, each run in a fresh process, on one CUDA card.

    python3 tools/torch_walls.py [--rounds 2] [--engines grom_tpu,host,...]
                                 [--repos DIR,...]

One round runs, by default, grom_tpu's host engine (``python -m
grom_tpu``, GROM_TPU_ENGINE=host) and the port's host, torch and mesh
engines (``python -m grom_tpu_torch``, GROM_TPU_TORCH_ENGINE=...);
``grom_tpu_noslab`` is grom_tpu's host engine without its huge-page slab
allocator (GROM_TPU_HUGEALLOC=0). Odd rounds run the engines in the
reverse order, so each sits early and late once per pair of rounds.
Every run has GROM_TPU_TIMING=1; its phase table is parsed from stderr
(the phases below and every ``mesh.*`` label of the mesh engine), and
for the port's engines its ``peak_memory`` line: the peak host RSS
(``rss_peak_kib``, ``rss_source``) and the peak at each timed phase's
last end (``phase_rss_kib``).
``--repos`` runs each engine from each of several checkouts in turn (a
parent commit unpacked with ``git archive`` into a gitignored directory
of this one: parent, change, change, parent over two rounds). Every VCF and .ctx.vcf must equal the first
run's, byte for byte apart from the ##fileDate line.

Prints one line per run (engine, wall, peak RSS, phases), the card's
name and power limit, and a JSON line with every run. The dataset and
outputs go under build/ (the dataset is chip_smoke.py's, generated at
first use).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "walls")
ENGINES = ("grom_tpu", "host", "torch", "mesh")
GROM_TPU = {"grom_tpu": {}, "grom_tpu_noslab": {"GROM_TPU_HUGEALLOC": "0"}}
PHASES = ("call.cnv", "cnv.winscan", "cnv.winscan_dev", "cnv.seed_eval_dev",
          "cnv.zscores_dev", "cnv.nullmodel_dev", "call.sv_detect",
          "ingest.read_bam", "scan.accumulate", "scan.device",
          "scan.deposits")


def run_one(engine: str, argv, vcf: str, repo: str = REPO) -> dict:
    env = dict(os.environ, GROM_TPU_TIMING="1",
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    if engine in GROM_TPU:
        # grom_tpu's slab allocator keeps no warm pool outside the checkout
        env.update(GROM_TPU_ENGINE="host", GROM_TPU_SHM_POOL="0",
                   **GROM_TPU[engine])
        mod = "grom_tpu"
    else:
        env["GROM_TPU_TORCH_ENGINE"] = engine
        mod = "grom_tpu_torch"
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", mod, *argv, "-o", vcf],
                       cwd=repo, env=env, capture_output=True, text=True,
                       timeout=900)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError("%s exited %d:\n%s" % (engine, r.returncode,
                                                  r.stderr[-4000:]))
    phases, mem = {}, {}
    for ln in r.stderr.splitlines():
        m = re.match(r"^(\S+)\s+([\d.]+)s\s", ln)
        if m and (m.group(1) in PHASES or m.group(1).startswith("mesh.")):
            phases[m.group(1)] = float(m.group(2))
        elif ln.startswith("peak_memory {"):
            mem = json.loads(ln.split(" ", 1)[1])
    return {"engine": engine, "repo": os.path.relpath(repo, REPO),
            "wall_s": wall, "phases": phases,
            "rss_peak_kib": mem.get("rss_peak_kib"),
            "rss_source": mem.get("rss_source"),
            "phase_rss_kib": mem.get("phase_rss_kib")}


def body(path: str) -> bytes:
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"##fileDate"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--engines", default=",".join(ENGINES))
    ap.add_argument("--repos", default=REPO,
                    help="checkouts to run the engines from, comma-separated")
    a = ap.parse_args()
    engines = tuple(a.engines.split(","))
    repos = [os.path.abspath(r) for r in a.repos.split(",")]
    for e in engines:
        if e not in ENGINES and e not in GROM_TPU:
            ap.error("unknown engine %r" % e)
    import torch
    if not torch.cuda.is_available():
        print("torch_walls.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke
    os.makedirs(OUT, exist_ok=True)
    argv = chip_smoke.bulk_args()
    runs, first = [], None
    units = [(i, repo, e) for i, repo in enumerate(repos) for e in engines]
    for rnd in range(a.rounds):
        order = units if rnd % 2 == 0 else units[::-1]
        for i, repo, engine in order:
            vcf = os.path.join(OUT, "%s.%d.%d.vcf" % (engine, i, rnd))
            res = run_one(engine, argv, vcf, repo)
            if first is None:
                first = vcf
            for x, y in ((vcf, first), (vcf[:-4] + ".ctx.vcf",
                                        first[:-4] + ".ctx.vcf")):
                if body(x) != body(y):
                    raise AssertionError("%s differs from %s" % (x, y))
            runs.append(res)
            phases = " ".join("%s %.3f" % kv
                              for kv in sorted(res["phases"].items()))
            rss = res["rss_peak_kib"]
            print("%-9s %-14s %8.3f s  %s  %s" % (
                engine, res["repo"], res["wall_s"],
                "-" if rss is None else "%.3f GiB" % (rss / 2**20), phases),
                flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
