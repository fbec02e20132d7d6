"""The port's main path at a human chromosome's size on one CUDA card.

    python3 tools/torch_scale.py [--runs host,torch,mesh,torch_4m1m,torch_P8]
                                 [--length 250000000]

Generates grom_tpu's 250 Mb WGS-scale chromosome (tests/test_wgs_scale.py
``test_250mb_bounded_memory``: 30x, seed 11, SNP rate 1e-3, a hotspot at
40 Mb, a depression at 120 Mb, an AT repeat at 180 Mb) with the port's
``testing/bulk_sim.py bulk_dataset`` under build/ at first use (about 6.5
GB of BAM), then runs ``python -m grom_tpu_torch`` on it, each run a fresh
process with GROM_TPU_TIMING=1, in this order:

* ``host``: the host engine at the default geometry (16 Mi ingest chunks,
  4 Mi detect sub-chunks from 134,217,728 bases on): the reference output;
* ``torch``: the torch engine, default geometry;
* ``mesh``: the mesh engine, default geometry (a 1x1 grid on the card);
* ``torch_4m1m``: the torch engine at 4 Mi chunks and 1 Mi sub-chunks
  (GROM_TPU_CHUNK_BASES, GROM_TPU_DETECT_BASES), the second geometry of
  grom_tpu's test;
* ``torch_P8``: the torch engine under ``-P 8``: one chromosome, so one
  worker, capped at ``cli.deal(8, ["cuda:0"])``'s share of the card.

The device runs see only the first card (CUDA_VISIBLE_DEVICES). The host
run always runs first. Each device run's VCF and .ctx.vcf must be
byte-identical to the host run's, apart from the ##fileDate line, and
must launch every kernel of its engine's path. When a run ends, one JSON
line: its wall, its timed phases, its kernel launches, its
``peak_memory`` (the driver's line: peak host RSS with its label,
``vmhwm`` or ``sampled``, and the card's peak allocated and reserved
bytes; for ``-P`` also each worker's), its rows by type and
``identical``. A failed or differing run does not stop the runs after
it; the script then exits 1. It never falls back to the host engine or
to the plain versions of the kernels. ``--length`` cuts the chromosome
(planted features past the cut are dropped), never below 135,000,000
bases: below 134,217,728 the default ingest chunk is no longer 16 Mi.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "torch_scale")

# tests/test_wgs_scale.py test_250mb_bounded_memory's bulk_dataset arguments
DATASET = dict(length=250_000_000, coverage=30.0, seed=11, snp_rate=1e-3,
               hotspots=[(40_000_000, 40_060_000, 3.0)],
               depressions=[(120_000_000, 120_120_000, 0.4)],
               repeats=[(180_000_000, 180_040_000, b"AT")])
MIN_LENGTH = 135_000_000
# seconds a run may take (the slowest at 250 Mb took 962)
RUN_TIMEOUT_S = 2400

# run -> (engine, environment, extra CLI flags)
RUNS = {
    "host": ("host", {}, []),
    "torch": ("torch", {}, []),
    "mesh": ("mesh", {}, []),
    "torch_4m1m": ("torch", {"GROM_TPU_CHUNK_BASES": str(4 << 20),
                             "GROM_TPU_DETECT_BASES": str(1 << 20)}, []),
    "torch_P8": ("torch", {}, ["-P", "8"]),
}
PHASES = ("scan.device", "scan.accumulate", "scan.deposits",
          "ingest.read_bam", "call.cnv", "cnv.winscan_dev",
          "cnv.seed_eval_dev", "cnv.zscores_dev", "cnv.nullmodel_dev",
          "cnv.winscan", "cnv.zscores", "cnv.nullmodel", "call.sv_detect")
# the kernels each device engine's path launches
PATH_KERNELS = {"torch": ("tile_accumulate", "zscores", "seed_eval",
                          "null_model", "sv_score"),
                "mesh": ("tile_accumulate", "zscores", "seed_eval",
                         "null_model", "sv_score", "rd_scatter", "rd_scan")}


def say(*a) -> None:
    print(*a, flush=True)


def dataset(length: int):
    """(fasta, bam) of the chromosome cut to ``length``, generated under
    build/ at first use."""
    sys.path.insert(0, REPO)
    from grom_tpu_torch.testing.bulk_sim import bulk_dataset
    spec = dict(DATASET, length=length)
    for k in ("hotspots", "depressions", "repeats"):
        spec[k] = [f for f in spec[k] if f[1] <= length]
    prefix = os.path.join(OUT, "c%d_seed%d" % (length, spec["seed"]), "c")
    if not os.path.exists(prefix + ".bam.bai"):
        os.makedirs(os.path.dirname(prefix), exist_ok=True)
        t0 = time.perf_counter()
        bulk_dataset(prefix, **spec)
        say("dataset %d bases generated in %.1f s (%.2f GB of BAM)"
            % (length, time.perf_counter() - t0,
               os.path.getsize(prefix + ".bam") / 1e9))
    return prefix + ".fa", prefix + ".bam"


def body(path: str) -> bytes:
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"##fileDate"))


def row_types(vcf: str) -> dict:
    """Rows of a VCF by type: snv, indel, cnv, and sv_<ALT> for the
    symbolic SV alleles."""
    n = collections.Counter()
    with open(vcf) as f:
        for ln in f:
            if ln.startswith("#"):
                continue
            t = ln.rstrip("\n").split("\t")
            if t[8].startswith("SD:Z:CN"):
                n["cnv"] += 1
            elif t[4].startswith("<"):
                n["sv_" + t[4].strip("<>").lower()] += 1
            elif t[4] in ("A", "C", "G", "T") and t[7] == ".":
                n["snv"] += 1
            else:
                n["indel"] += 1
    return dict(sorted(n.items()))


def parse_stderr(err: str) -> dict:
    """The timed phases (wall seconds), and the ``launches``,
    ``peak_memory`` and ``parallel_job`` JSON lines of a run's stderr."""
    out = {"phases": {}, "launches": None, "peak_memory": None, "jobs": []}
    for ln in err.splitlines():
        m = re.match(r"^(\S+)\s+([\d.]+)s\s", ln)
        if m and m.group(1) in PHASES:
            out["phases"][m.group(1)] = float(m.group(2))
        elif ln.startswith("launches {"):
            out["launches"] = json.loads(ln.split(" ", 1)[1])
        elif ln.startswith("peak_memory {"):
            out["peak_memory"] = json.loads(ln.split(" ", 1)[1])
        elif ln.startswith("parallel_job {"):
            out["jobs"].append(json.loads(ln.split(" ", 1)[1]))
    if out["jobs"]:
        # a -P run's phases are its workers'
        for job in out["jobs"]:
            for k, v in job.get("phases", {}).items():
                if k in PHASES:
                    out["phases"][k] = out["phases"].get(k, 0.0) + v
    return out


def run_one(name: str, fa: str, bam: str) -> dict:
    """One run in a fresh process; returns its record (``rc`` non-zero and
    the end of its stderr when it failed)."""
    engine, env_extra, flags = RUNS[name]
    vcf = os.path.join(OUT, "%s.vcf" % name)
    env = dict(os.environ, GROM_TPU_TIMING="1", GROM_TPU_TORCH_ENGINE=engine,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    for k in ("GROM_TPU_CHUNK_BASES", "GROM_TPU_DETECT_BASES"):
        env.pop(k, None)
    env.update(env_extra)
    if engine != "host":
        visible = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        env["CUDA_VISIBLE_DEVICES"] = visible or "0"
    rec = {"run": name, "engine": engine, "env": env_extra, "flags": flags}
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-m", "grom_tpu_torch", "-i", bam,
                            "-r", fa, "-o", vcf, *flags], cwd=REPO, env=env,
                           capture_output=True, text=True,
                           timeout=RUN_TIMEOUT_S)
        rc, err = r.returncode, r.stderr
    except subprocess.TimeoutExpired as exc:
        rc = 124
        err = exc.stderr.decode() if isinstance(exc.stderr, bytes) else (
            exc.stderr or "")
    rec["wall_s"] = time.perf_counter() - t0
    rec["rc"] = rc
    with open(os.path.join(OUT, "%s.stderr" % name), "w") as f:
        f.write(err)
    rec.update(parse_stderr(err))
    if rc != 0:
        rec["stderr_tail"] = err[-3000:]
        return rec
    rec["vcf"] = vcf
    rec["rows"] = row_types(vcf)
    return rec


def check_run(rec: dict, ref: dict) -> list:
    """What is wrong with a finished device run: a file that differs from
    the host run's, a kernel of its path never launched, a missing
    reading."""
    bad = []
    for suf in ("", ".ctx"):
        a = rec["vcf"][:-4] + suf + ".vcf"
        b = ref["vcf"][:-4] + suf + ".vcf"
        if body(a) != body(b):
            bad.append("%s differs from the host run's" % os.path.basename(a))
    launches = rec["launches"] or {}
    for k in PATH_KERNELS[rec["engine"]]:
        if launches.get(k, 0) <= 0:
            bad.append("kernel %s was not launched" % k)
    card = (rec["peak_memory"] or {}).get("card")
    if rec["jobs"]:
        card = {"max_allocated": max(j["max_memory_allocated"] or 0
                                     for j in rec["jobs"])}
        if any(not j["device"].startswith("cuda") for j in rec["jobs"]):
            bad.append("a -P job ran off the card")
    if not card or not card.get("max_allocated"):
        bad.append("no peak card memory reading")
    return bad


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default=",".join(RUNS),
                    help="comma-separated subset of %s" % ",".join(RUNS))
    ap.add_argument("--length", type=int, default=DATASET["length"])
    a = ap.parse_args(argv)
    runs = [r for r in a.runs.split(",") if r]
    for r in runs:
        if r not in RUNS:
            ap.error("unknown run %r" % r)
    if a.length < MIN_LENGTH or a.length > DATASET["length"]:
        ap.error("--length must lie in [%d, %d]" % (MIN_LENGTH,
                                                    DATASET["length"]))
    runs = ["host"] + [r for r in RUNS if r in runs and r != "host"]
    if len(runs) > 1:
        import torch
        if not torch.cuda.is_available():
            print("torch_scale.py: the device runs need a CUDA card, and "
                  "torch.cuda.is_available() is false", file=sys.stderr)
            return 2
        smi = nvidia_smi_line()
        say("card", smi)
    else:
        smi = None
    os.makedirs(OUT, exist_ok=True)
    fa, bam = dataset(a.length)
    records, ok, ref = [], True, None
    for name in runs:
        rec = run_one(name, fa, bam)
        if rec["rc"] != 0:
            rec["problems"] = ["exited %d" % rec["rc"]]
        elif name == "host":
            rec["problems"] = []
            ref = rec
        else:
            rec["problems"] = check_run(rec, ref)
        rec["identical"] = rec["rc"] == 0 and not any(
            "differs" in p for p in rec["problems"])
        ok = ok and not rec["problems"]
        records.append(rec)
        say(json.dumps({k: v for k, v in rec.items() if k != "vcf"}))
        if name == "host" and ref is None:
            break
    if smi is not None:
        say(smi)
    say(json.dumps({"torch_scale": {"length": a.length, "ok": ok,
                                    "runs": [r["run"] for r in records]}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
