"""The port's main path at a human chromosome's size on one CUDA card.

    python3 tools/torch_scale.py [--runs host,torch,mesh,torch_4m1m,torch_P8]
                                 [--length 250000000] [--repos DIR,DIR]
                                 [--wide] [--memprof] [--probe]
                                 [--device-env NAME=VALUE ...]
    python3 tools/torch_scale.py --runs host,torch_hostcnv,mesh_hostcnv,host_devcnv

Generates grom_tpu's 250 Mb WGS-scale chromosome (tests/test_wgs_scale.py
``test_250mb_bounded_memory``: 30x, seed 11, SNP rate 1e-3, a hotspot at
40 Mb, a depression at 120 Mb, an AT repeat at 180 Mb) with the port's
``testing/bulk_sim.py bulk_dataset`` under build/ at first use (about 6.5
GB of BAM), then runs ``python -m grom_tpu_torch`` on it, each run a fresh
process with GROM_TPU_TIMING=1, in this order (the last three only when
``--runs`` names them):

* ``host``: the host engine at the default geometry (16 Mi ingest chunks,
  4 Mi detect sub-chunks from 134,217,728 bases on): the reference output;
* ``torch``: the torch engine, default geometry (a device engine's ingest
  chunk is at most 8 Mi, its sub-chunks 4 Mi);
* ``mesh``: the mesh engine, default geometry (a 1x1 grid on the card);
* ``torch_4m1m``: the torch engine at 4 Mi chunks and 1 Mi sub-chunks
  (GROM_TPU_CHUNK_BASES, GROM_TPU_DETECT_BASES), the second geometry of
  grom_tpu's test;
* ``torch_P8``: the torch engine under ``-P 8``: one chromosome, so one
  worker, capped at ``cli.deal(8, ["cuda:0"])``'s share of the card;
* ``torch_hostcnv``, ``mesh_hostcnv``: the torch and mesh engines with
  GROM_TPU_DEVICE_CNV=0 (the native C CNV stage on the depth lists the
  engine built);
* ``host_devcnv``: the host engine with GROM_TPU_DEVICE_CNV=1 and
  GROM_TPU_DEVICE_SV=1 (the CNV kernels and the SV scorer on the card).

The device runs see only the first card (CUDA_VISIBLE_DEVICES). The host
run always runs first. Each device run's VCF and .ctx.vcf must be
byte-identical to the host run's, apart from the ##fileDate line, must
launch every kernel of its path and none that its knobs keep off the
card. When a run ends, one JSON
line: its wall, its timed phases, its kernel launches, its
``peak_memory`` (the driver's line: peak host RSS with its label,
``vmhwm`` or ``sampled``, and the card's peak allocated and reserved
bytes; for ``-P`` also each worker's), the peak host RSS at each timed
phase's last end (``phase_rss_kib``, the timing table's ``livemax``; a
``-P`` run's are its worker's), its rows by type and ``identical``. A
device run whose peak RSS (a ``-P`` run's: its largest worker's) is above
the host run's is a problem, as is an output that differs. A failed or
differing run does not stop the runs after it; the script then exits 1.
It never falls back to the host engine or to the plain versions of the
kernels. ``--length`` cuts the chromosome (planted features past the cut
are dropped), never below 135,000,000 bases: below 134,217,728 the
default ingest chunk is no longer 16 Mi. ``--wide`` sets the host
engine's geometry there (16 Mi ingest chunks, 4 Mi detect sub-chunks:
GROM_TPU_CHUNK_BASES and GROM_TPU_DETECT_BASES) on every run that sets
none of its own, the device runs' included, and then
takes any ``--length`` of at least 16 Mi: the comparison of the engines'
host memory by site, at the geometry whose chunks it scales with, where
it is cheap (24 Mb: ``--length 24000000 --wide --probe --probe-args
"--events --numpy"``). ``--device-env NAME=VALUE`` (repeatable) sets a
variable on every device run (the host run keeps its own environment),
over what the run sets: e.g. ``GROM_TPU_CHUNK_BASES=8388608`` with ``--tag
c8m.`` runs the device engines at 8 Mi ingest chunks against the default
host run.

``--memprof`` runs each CLI under ``tools/memprof.py`` (its peak RSS
split into anonymous, shm, BAM and other file-backed pages at each
process's peak; the per-second CSV goes to build/torch_scale/) and keeps
its line as the record's ``memprof``. ``--probe`` runs each CLI through
``tools/peak_probe.py`` (numpy's live blocks, glibc's heap arena by
arena, torch's pinned host memory, the smaps split, the fetch in flight
and the most bytes the queued device jobs have held so far, at the peak
and at the end of the scan stage; with ``--events``, at each fetch's
start and end and each drained detect sub-chunk) and keeps its line as ``peak_probe`` (``--probe-args``
passes it options, e.g. ``"--numpy"``); the probe costs time of its own,
so its runs' walls are not comparable with others'. Each record's
``memory`` sums these up: the peak RSS, memprof's split at it, the
probe's reading nearest it (anonymous and file KiB, the chunks being
fetched, the heap's free KiB by arena, pinned bytes), the card bytes the
queued device jobs held at most and the card's peak at the scan's end.

``--repos A,B`` runs the host run from the last checkout first (the
reference), then from each other checkout (held byte for byte to the
reference, and to no RSS rule), then each device run from each checkout
in turn (A, B, A, B, ...): to hold a change against its parent in one
call, unpack the parent with ``git archive`` into a gitignored directory
(``proof/parent``) and pass ``proof/parent,.`` (``.,proof/parent`` runs
the parent's host run first).
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
# --wide: the default geometry from 134,217,728 bases on, set on each run
WIDE = {"GROM_TPU_CHUNK_BASES": str(16 << 20),
        "GROM_TPU_DETECT_BASES": str(4 << 20)}
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
    "torch_hostcnv": ("torch", {"GROM_TPU_DEVICE_CNV": "0"}, []),
    "mesh_hostcnv": ("mesh", {"GROM_TPU_DEVICE_CNV": "0"}, []),
    "host_devcnv": ("host", {"GROM_TPU_DEVICE_CNV": "1",
                             "GROM_TPU_DEVICE_SV": "1"}, []),
}
# the runs without --runs: all but the device policy's (one 3,600 s call
# holds either set at 250 Mb)
DEFAULT_RUNS = ("host", "torch", "mesh", "torch_4m1m", "torch_P8")
CNV_KERNELS = ("zscores", "seed_eval", "null_model")
MESH_KERNELS = ("rd_scatter", "rd_scan")
# (the kernels a run must launch, the kernels it must not), by engine and
# GROM_TPU_DEVICE_CNV
PATH_KERNELS = {
    ("torch", ""): (("tile_accumulate", "sv_score") + CNV_KERNELS,
                    MESH_KERNELS),
    ("mesh", ""): (("tile_accumulate", "sv_score") + CNV_KERNELS
                   + MESH_KERNELS, ()),
    ("torch", "0"): (("tile_accumulate", "sv_score"),
                     CNV_KERNELS + MESH_KERNELS),
    ("mesh", "0"): (("tile_accumulate", "sv_score") + MESH_KERNELS,
                    CNV_KERNELS),
    ("host", "1"): (CNV_KERNELS + ("sv_score",),
                    ("tile_accumulate",) + MESH_KERNELS),
}


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
    """The timed phases (wall seconds: every row of the timing table), and
    the ``launches``, ``peak_memory`` and ``parallel_job`` JSON lines of a
    run's stderr."""
    out = {"phases": {}, "launches": None, "peak_memory": None, "jobs": [],
           "phase_rss_kib": {}}
    probe = None
    in_table = False
    for ln in err.splitlines():
        m = re.match(r"^(\S+)\s+([\d.]+)s\s", ln) if in_table else None
        if ln.startswith("== grom_tpu timing =="):
            in_table = True
        elif m:
            out["phases"][m.group(1)] = float(m.group(2))
        elif ln.startswith("launches {"):
            out["launches"] = json.loads(ln.split(" ", 1)[1])
        elif ln.startswith("peak_memory {"):
            out["peak_memory"] = json.loads(ln.split(" ", 1)[1])
        elif ln.startswith("parallel_job {"):
            out["jobs"].append(json.loads(ln.split(" ", 1)[1]))
        elif ln.startswith("peak_probe {"):
            probe = json.loads(ln.split(" ", 1)[1])
    if probe is not None:
        out["peak_probe"] = probe
    rss = (out["peak_memory"] or {}).get("phase_rss_kib") or {}
    if out["jobs"]:
        # a -P run's phases are its workers'
        rss = {}
        for job in out["jobs"]:
            for k, v in job.get("phases", {}).items():
                out["phases"][k] = out["phases"].get(k, 0.0) + v
            for k, v in (job.get("phase_rss_kib") or {}).items():
                rss[k] = max(rss.get(k, 0), v)
    # in the order the peak grew
    out["phase_rss_kib"] = dict(sorted(rss.items(), key=lambda kv: kv[1]))
    return out


def rss_peak_kib(rec: dict):
    """A run's peak host RSS in KiB: its process's, or for a ``-P`` run
    its largest worker's; None when it printed none."""
    if rec["jobs"]:
        return max((j["max_rss_kib"] or 0) for j in rec["jobs"]) or None
    return (rec["peak_memory"] or {}).get("rss_peak_kib")


def memory_summary(rec: dict) -> dict:
    """A run's host and card memory readings in one place (see the module
    doc): None where a reading was not taken."""
    mem = rec.get("peak_memory") or {}
    out = {"rss_peak_kib": rec.get("rss_peak_kib"),
           "queued_jobs": mem.get("queued_jobs"),
           "card_peak_scan": (mem.get("depth_lists") or {}).get(
               "card_peak_scan")}
    if rec.get("jobs"):
        out["queued_jobs"] = [j.get("queued_jobs") for j in rec["jobs"]]
        out["card_peak_scan"] = [(j.get("depth_lists") or {}).get(
            "card_peak_scan") for j in rec["jobs"]]
    prof = (rec.get("memprof") or {}).get("procs") or []
    if prof:
        top = prof[0]
        out["memprof_gb"] = {k: top[k] for k in ("peak_gb", "anon_gb",
                                                 "bam_gb", "file_gb")}
    peak = (rec.get("peak_probe") or {}).get("peak")
    if peak:
        arenas = peak.get("arenas") or {}
        out["probe_peak"] = {
            "rss_kib": peak["rss_kib"], "anon_kib": peak["anon_kib"],
            "file_kib": peak["file_kib"], "fetching": peak.get("fetching"),
            "heap_free_kib": [a[1] for a in arenas.get("arenas", [])],
            "pinned": peak.get("pinned"), "queued": peak.get("queued")}
    return out


def run_one(name: str, fa: str, bam: str, repo: str = REPO,
            tag: str = "", memprof: bool = False,
            probe=None, wide: bool = False, device_env=None) -> dict:
    """One run of the checkout ``repo`` in a fresh process; returns its
    record (``rc`` non-zero and the end of its stderr when it failed). Its
    files are named ``<tag><name>``. ``memprof``: under tools/memprof.py;
    ``probe`` (a list of its options, maybe empty): through
    tools/peak_probe.py (both this checkout's). ``wide``: at 16 Mi / 4 Mi
    unless the run sets its own geometry; ``device_env``: variables set on
    a device run over its own."""
    engine, env_extra, flags = RUNS[name]
    if wide and "GROM_TPU_CHUNK_BASES" not in env_extra:
        env_extra = dict(WIDE, **env_extra)
    if device_env and name != "host":
        env_extra = dict(env_extra, **device_env)
    vcf = os.path.join(OUT, "%s%s.vcf" % (tag, name))
    env = dict(os.environ, GROM_TPU_TIMING="1", GROM_TPU_TORCH_ENGINE=engine,
               PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    for k in ("GROM_TPU_CHUNK_BASES", "GROM_TPU_DETECT_BASES",
              "GROM_TPU_DEVICE_CNV", "GROM_TPU_DEVICE_SV"):
        env.pop(k, None)
    env.update(env_extra)
    if name != "host":
        visible = env.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
        env["CUDA_VISIBLE_DEVICES"] = visible or "0"
    rec = {"run": name, "repo": os.path.relpath(repo, REPO),
           "engine": engine, "env": env_extra, "flags": flags}
    tools = os.path.join(REPO, "tools")
    cmd = [sys.executable] + (
        [os.path.join(tools, "peak_probe.py"), *probe, "--"]
        if probe is not None else ["-m", "grom_tpu_torch"]) + ["-i", bam, "-r", fa, "-o", vcf,
                                          *flags]
    if memprof:
        cmd = [sys.executable, os.path.join(tools, "memprof.py"),
               "--tag", "bam=" + bam, "--csv",
               os.path.join(OUT, "%s%s.memprof.csv" % (tag, name)),
               "--", *cmd]
    t0 = time.perf_counter()
    out = ""
    try:
        r = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                           text=True, timeout=RUN_TIMEOUT_S)
        rc, err, out = r.returncode, r.stderr, r.stdout
    except subprocess.TimeoutExpired as exc:
        rc = 124
        err = exc.stderr.decode() if isinstance(exc.stderr, bytes) else (
            exc.stderr or "")
    rec["wall_s"] = time.perf_counter() - t0
    rec["rc"] = rc
    if memprof:
        last = [ln for ln in out.splitlines() if ln.startswith('{"rc"')]
        rec["memprof"] = json.loads(last[-1]) if last else None
    with open(os.path.join(OUT, "%s%s.stderr" % (tag, name)), "w") as f:
        f.write(err)
    rec.update(parse_stderr(err))
    rec["rss_peak_kib"] = rss_peak_kib(rec)
    rec["memory"] = memory_summary(rec)
    if rc != 0:
        rec["stderr_tail"] = err[-3000:]
        return rec
    rec["vcf"] = vcf
    rec["rows"] = row_types(vcf)
    return rec


def differs(rec: dict, ref: dict) -> list:
    """The files of a finished run that differ from the host run's."""
    bad = []
    for suf in ("", ".ctx"):
        a = rec["vcf"][:-4] + suf + ".vcf"
        b = ref["vcf"][:-4] + suf + ".vcf"
        if body(a) != body(b):
            bad.append("%s differs from the host run's" % os.path.basename(a))
    return bad


def check_run(rec: dict, ref: dict) -> list:
    """What is wrong with a finished device run: a file that differs from
    the host run's, a kernel of its path never launched, a missing
    reading, a peak host RSS above the host run's, a kernel launched that
    the run's knobs keep off the card."""
    bad = differs(rec, ref)
    launches = rec["launches"] or {}
    need, banned = PATH_KERNELS[rec["engine"], rec["env"].get(
        "GROM_TPU_DEVICE_CNV", "")]
    for k in need:
        if launches.get(k, 0) <= 0:
            bad.append("kernel %s was not launched" % k)
    for k in banned:
        if launches.get(k, 0) > 0:
            bad.append("kernel %s was launched" % k)
    card = (rec["peak_memory"] or {}).get("card")
    if rec["jobs"]:
        card = {"max_allocated": max(j["max_memory_allocated"] or 0
                                     for j in rec["jobs"])}
        if any(not j["device"].startswith("cuda") for j in rec["jobs"]):
            bad.append("a -P job ran off the card")
    if not card or not card.get("max_allocated"):
        bad.append("no peak card memory reading")
    if rec["rss_peak_kib"] is None or ref["rss_peak_kib"] is None:
        bad.append("no peak host RSS reading")
    elif rec["rss_peak_kib"] > ref["rss_peak_kib"]:
        bad.append("peak host RSS %d KiB above the host run's %d KiB"
                   % (rec["rss_peak_kib"], ref["rss_peak_kib"]))
    return bad


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default=",".join(DEFAULT_RUNS),
                    help="comma-separated subset of %s" % ",".join(RUNS))
    ap.add_argument("--length", type=int, default=DATASET["length"])
    ap.add_argument("--memprof", action="store_true",
                    help="run each CLI under tools/memprof.py")
    ap.add_argument("--probe", action="store_true",
                    help="run each CLI through tools/peak_probe.py")
    ap.add_argument("--probe-args", default="",
                    help="options for tools/peak_probe.py, space-separated")
    ap.add_argument("--wide", action="store_true",
                    help="every run at 16 Mi / 4 Mi; any --length from "
                         "16 Mi on")
    ap.add_argument("--device-env", action="append", default=[],
                    metavar="NAME=VALUE",
                    help="set on every device run (repeatable)")
    ap.add_argument("--tag", default="",
                    help="a prefix for the runs' file names")
    ap.add_argument("--repos", default=".",
                    help="comma-separated checkouts, relative to the repo; "
                         "the reference host run is the last one's")
    a = ap.parse_args(argv)
    repos = [os.path.normpath(os.path.join(REPO, r))
             for r in a.repos.split(",") if r]
    for r in repos:
        if not os.path.isdir(os.path.join(r, "grom_tpu_torch")):
            ap.error("%s holds no grom_tpu_torch" % r)
    runs = [r for r in a.runs.split(",") if r]
    for r in runs:
        if r not in RUNS:
            ap.error("unknown run %r" % r)
    device_env = {}
    for kv in a.device_env:
        k, eq, v = kv.partition("=")
        if not eq or not k:
            ap.error("--device-env takes NAME=VALUE, not %r" % kv)
        device_env[k] = v
    floor = (16 << 20) if a.wide else MIN_LENGTH
    if a.length < floor or a.length > DATASET["length"]:
        ap.error("--length must lie in [%d, %d]" % (floor,
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
    tags = {r: a.tag + ("" if len(repos) == 1 else "%s." % (
        "this" if r == REPO else os.path.basename(r))) for r in repos}
    probe = a.probe_args.split() if a.probe else None
    todo = ([("host", repos[-1])] + [("host", r) for r in repos[:-1]]
            + [(n, r) for n in runs[1:] for r in repos])
    records, ok, ref = [], True, None
    for name, repo in todo:
        rec = run_one(name, fa, bam, repo, tags[repo], a.memprof, probe,
                      a.wide, device_env)
        if rec["rc"] != 0:
            rec["problems"] = ["exited %d" % rec["rc"]]
        elif ref is None:
            rec["problems"] = []
            ref = rec
        elif name == "host":
            rec["problems"] = differs(rec, ref)
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
