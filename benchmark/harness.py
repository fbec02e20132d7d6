"""One run of a benchmark cell of grom_tpu_torch (see ``run.py``).

Set-up: the cell's genome is generated from ``--seed`` into a directory
under ``$TMPDIR`` by ``synth.py`` in a child process; the port is
imported, its kernels and native library are loaded from
``build/grom_tpu_torch`` in the checkout (built on the first run there);
one warm-up pass calls the genome, which also writes the sidecar caches a
second run of a BAM finds.

The window: ``grom_tpu_torch.cli.main`` in-process, one pass calling every
contig of the genome (serially, or in the worker processes of the
traffic's ``-P``), passes back to back until ``--seconds`` have passed;
the pass in flight finishes. The card's peak counters are reset at its
start and this file's sampler reads the anonymous resident memory of this
process and of every live descendant every 20 ms. With ``--trace 1`` the
port's phase timing is on, and the card's activity is traced by
``torch.profiler``. A worker the pass spawns is measured by the
benchmark's probe in it (``workerprobe.py``): its card peak, and in the
traced run its CUDA activity and span events, for the part of the window
it lived in. A worker whose record never comes gives no result.

After the window: the rows of every pass are judged by the plain reference
(``plainref.py``); the last line on standard output is the result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional, Set

import workerprobe

# in a worker process that a pass spawns, this module is imported again
# (run.py is the parent's main script): start the benchmark's probe there
workerprobe.install()

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GIB = float(1 << 30)
PAGE = os.sysconf("SC_PAGE_SIZE")
LIMITS = {"rows_wrong": 0}
# a configuration's keys: what the generator draws the reads by, what the
# harness checks or sets, and what only documents the deployment
LAYOUT = ("coverage", "read_len", "insert_mean", "insert_sd", "err",
          "low_mapq_frac", "snp_rate", "hom_share", "indel_rate", "sv_count")
CONFIG_KEYS = set(LAYOUT) | {"contig_length", "engine", "grom"} | {
    "name", "source", "deployment", "precision", "guarantees", "assumed",
    "reduced"}
TRAFFIC_KEYS = {"why", "contigs", "flags", "env"}


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of BENCHMARK.json with its configuration, traffic
    and per-layer metrics."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit("no workload %r in BENCHMARK.json" % name)
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"]
                  if name in m.get("workloads", [name])]
    return dict(cell=cell, config=config, traffic=traffic,
                per_layer=per_layer, end_to_end=end_to_end,
                run_seconds=bench["run_seconds"])


def contig_specs(config: dict, traffic: dict, seed: int) -> List[dict]:
    """The generator's specs: the traffic's contigs with the
    configuration's read layout, each seeded from (seed, index). A key
    that neither file may hold, or a contig whose length is not the
    configuration's ``contig_length``, is refused."""
    for what, got, known in (("configuration", config, CONFIG_KEYS),
                             ("traffic", traffic, TRAFFIC_KEYS)):
        extra = sorted(set(got) - known)
        if extra:
            raise ValueError("unknown %s keys: %s" % (what, ", ".join(extra)))
    want = config.get("contig_length")
    if want is not None and any(int(c["length"]) != want
                                for c in traffic["contigs"]):
        raise ValueError("a traffic contig is not the configuration's "
                         "contig_length %d" % want)
    layout = {k: config[k] for k in LAYOUT}
    out = []
    for i, c in enumerate(traffic["contigs"]):
        spec = dict(layout)
        spec.update(c)
        spec["seed"] = [seed & (2**64 - 1), i]
        out.append(spec)
    return out


def anon_bytes(pid="self") -> int:
    """Anonymous resident bytes of a process: statm's resident less shared
    pages; 0 for a descendant that has ended."""
    try:
        with open("/proc/%s/statm" % pid) as f:
            v = f.read().split()
    except OSError:
        if pid == "self":
            raise
        return 0
    return (int(v[1]) - int(v[2])) * PAGE


def has_children() -> bool:
    """Whether this process has a child, running or not yet reaped: one
    system call, which reaps nothing."""
    try:
        os.waitid(os.P_ALL, 0, os.WEXITED | os.WNOHANG | os.WNOWAIT)
        return True
    except ChildProcessError:
        return False


def descendants(root: int) -> Set[int]:
    """The pids of the live (not zombie) descendants of ``root``, found by
    each process's parent in ``/proc/<pid>/stat``."""
    kids: Dict[int, List[int]] = {}
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % name) as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except (OSError, IndexError, ValueError):
            continue
        if state != "Z":
            kids.setdefault(int(ppid), []).append(int(name))
    out: Set[int] = set()
    todo = [root]
    while todo:
        for pid in kids.get(todo.pop(), ()):
            if pid not in out:
                out.add(pid)
                todo.append(pid)
    return out


def cmdline(pid: int) -> str:
    try:
        with open("/proc/%d/cmdline" % pid, "rb") as f:
            return f.read().replace(b"\0", b" ").decode(errors="replace")
    except OSError:
        return ""


class AnonSampler:
    """The peak of the anonymous resident memory of this process and every
    live descendant, summed at each read, read every ``period`` seconds;
    beside it this process's own peak, and each descendant seen with its
    command line. Descendants are looked for only while this process has
    a child, so a process without one reads as it alone."""

    def __init__(self, period: float = 0.02):
        self.period = period
        self.root = os.getpid()
        self.peak = self.own_peak = 0
        self.seen: Dict[int, str] = {}
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._loop, daemon=True,
                                   name="bench-anon")

    def sample(self) -> None:
        own = total = anon_bytes()
        if has_children():
            for pid in descendants(self.root):
                total += anon_bytes(pid)
                if pid not in self.seen:
                    self.seen[pid] = cmdline(pid)
        self.own_peak = max(self.own_peak, own)
        self.peak = max(self.peak, total)

    def spawned(self) -> Set[int]:
        """The descendants seen that ``multiprocessing`` spawned."""
        return {pid for pid, cmd in self.seen.items()
                if workerprobe.SPAWNED in cmd}

    def _loop(self):
        while not self._stop.is_set():
            self.sample()
            self._stop.wait(self.period)

    def start(self):
        self.sample()
        self._t.start()

    def stop(self) -> int:
        self._stop.set()
        self._t.join()
        self.sample()
        return self.peak


@contextmanager
def redirected(path: str):
    """Standard output and error of this process, file descriptors
    included, appended to ``path``."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = os.dup(1), os.dup(2)
    with open(path, "ab") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        os.close(saved[0])
        os.close(saved[1])


def generate(prefix: str, specs: List[dict]):
    """(fasta, bam, contigs) of ``synth.py`` run in a child process, so
    that the measured process holds none of the generator's memory."""
    with open(prefix + ".specs.json", "w") as f:
        json.dump(specs, f)
    r = subprocess.run([sys.executable, os.path.join(HERE, "synth.py"),
                        prefix, prefix + ".specs.json"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("the generator failed:\n" + r.stderr[-3000:])
    got = json.loads(r.stdout.strip().splitlines()[-1])
    return got["fasta"], got["bam"], got["contigs"]


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"),
        os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def body(path: str) -> List[str]:
    """A VCF's rows and column header, without the ``##`` lines (they carry
    the run's date)."""
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if not ln.startswith("##")]


def judge_passes(outs: List[str], specs: List[dict], grom: dict) -> tuple:
    """(rows wrong, counts): the last pass against the plain reference, and
    every other pass row for row against the last."""
    import plainref
    ex = plainref.expect(specs, grom)
    last = outs[-1]
    with open(last) as f, open(last[:-4] + ".ctx.vcf") as g:
        wrong, d = plainref.judge(f.read(), g.read(), ex)
    ref_rows = body(last)
    ref_ctx = body(last[:-4] + ".ctx.vcf")
    d["pass_rows_differ"] = 0
    for out in outs[:-1]:
        for a, b in ((body(out), ref_rows),
                     (body(out[:-4] + ".ctx.vcf"), ref_ctx)):
            d["pass_rows_differ"] += len(set(a) ^ set(b)) + abs(
                len(a) - len(b))
    return wrong + d["pass_rows_differ"], d


def window_faults(records: List[dict], missing: List[int],
                  spawned: Iterable[int]) -> List[str]:
    """Why a window gives no result: a worker's record that never came, a
    spawned descendant without the probe, a forbidden module in this
    process or in a worker."""
    out = []
    if missing:
        out.append("no record from worker(s) %s" % missing)
    bare = sorted(set(spawned) - {r["pid"] for r in records} - set(missing))
    if bare:
        out.append("worker(s) %s ran without the probe" % bare)
    found = set(workerprobe.forbidden_modules())
    for r in records:
        found |= set(r["forbidden"])
    if found:
        out.append("modules %s were loaded" % ", ".join(sorted(found)))
    return out


def fullest_card(on_card: List[tuple]) -> int:
    """The most card memory that processes alive at once held on one card:
    of ``(card, born_ns, ended_ns, peak_bytes)`` a process, the sum of the
    peaks of those on one card whose lives overlap the start of one of
    them, at its largest (0 where none ran on a card). A pool that spawns
    its workers for each pass sums one pass's workers, not every pass's."""
    return max((sum(p for c2, b2, e2, p in on_card
                    if c2 == c and b2 <= b < e2)
                for c, b, _, _ in on_card), default=0)


def main(argv: Optional[List[str]] = None, require_cuda: bool = True,
         device: str = "cuda", cell: Optional[dict] = None) -> int:
    """One run (see the module's docstring); returns the exit code. The
    tests pass ``require_cuda=False``, ``device="cpu"`` and a ``cell`` of
    their own (``load_cell``'s form)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_setup = time.perf_counter()
    cell = cell or load_cell(args.workload)
    config, traffic = cell["config"], cell["traffic"]
    chips = int(cell["cell"]["chips"])

    os.environ["GROM_TPU_TORCH_ENGINE"] = config["engine"]
    os.environ.pop("GROM_TPU_TIMING", None)
    # kernel caches at fixed paths inside the checkout (the port builds
    # into build/grom_tpu_torch itself), so only a checkout's first run
    # builds or compiles
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    for k, v in traffic.get("env", {}).items():
        os.environ[k] = str(v)

    import torch
    cuda = device.startswith("cuda")
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        print("no result: the cell needs %d CUDA device(s); this host has "
              "%d" % (chips, torch.cuda.device_count()
                      if torch.cuda.is_available() else 0),
              file=sys.stderr)
        return 2

    sys.path.insert(0, HERE)
    work = tempfile.mkdtemp(prefix="grom-bench-",
                            dir=os.environ.get("TMPDIR") or None)
    log = os.path.join(work, "program.log")
    # the workers' probes (workerprobe.py) report here; set before the
    # warm-up pass, so a pool alive from it into the window is measured too
    probes = os.path.join(work, "probes")
    os.mkdir(probes)
    os.environ[workerprobe.ENV] = probes
    try:
        specs = contig_specs(config, traffic, args.seed)
        t0 = time.perf_counter()
        fa, bam, info = generate(os.path.join(work, "g"), specs)
        gen_s = time.perf_counter() - t0
        genome_mb = sum(c["length"] for c in info) / 1e6

        t0 = time.perf_counter()
        with redirected(log):
            if ROOT not in sys.path:
                sys.path.insert(0, ROOT)
            from grom_tpu_torch import _build, cli, native
            from grom_tpu_torch.utils import timing
            if cuda:
                _build.build_all()
                for name in _build.LIBRARIES:
                    _build.library(name)
            native.get_lib()
        load_s = time.perf_counter() - t0

        def one_pass(out: str) -> int:
            argv = ["-i", bam, "-r", fa, "-o", out] + list(
                traffic.get("flags", []))
            with redirected(log):
                try:
                    return cli.main(argv)
                except Exception:  # a failed pass is counted, not fatal
                    import traceback
                    traceback.print_exc()
                    return 1

        t0 = time.perf_counter()
        warm_rc = one_pass(os.path.join(work, "warm.vcf"))
        warm_s = time.perf_counter() - t0
        # the card's counters and trace of this process, where the program
        # made a CUDA context in it (the parent of -P workers makes none)
        own_cuda = cuda and torch.cuda.is_initialized()
        if own_cuda:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_setup

        # ---- the window ----
        prof = None
        trace_path = os.path.join(work, "trace.json")
        if args.trace:
            timing.timing_enable(True)
            timing.reset()
            _build.reset_launches()
            if own_cuda:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
        if own_cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        window = workerprobe.Window(probes, lambda: descendants(os.getpid()))
        window.open(bool(args.trace))
        t_open = time.time_ns()
        sampler = AnonSampler()
        sampler.start()
        anon_start = sampler.peak
        outs, walls, failed = [], [], 0
        w0 = time.perf_counter()
        while True:
            out = os.path.join(work, "pass%03d.vcf" % len(outs))
            rc = one_pass(out)
            outs.append(out)
            walls.append(time.perf_counter() - w0 - sum(walls))
            failed += rc != 0
            if rc != 0 or time.perf_counter() - w0 >= args.seconds:
                break
        if own_cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - w0
        t_close = time.time_ns()
        anon_peak = sampler.stop()
        records, missing = window.close()
        own_card = torch.cuda.current_device() if own_cuda else None
        # (card, born, ended, peak allocated bytes) of each process on a card
        on_card = [(r["card"], r["born_ns"], r["end_ns"], r["card_peak"])
                   for r in records if r["card_peak"] is not None]
        if own_cuda:
            on_card.append((own_card, t_open, t_close,
                            torch.cuda.max_memory_allocated()))
        traces = [(r["trace"], r["card"], r["pid"]) for r in records
                  if r["trace"]]
        if prof is not None:
            prof.__exit__(None, None, None)
            prof.export_chrome_trace(trace_path)
            prof = None
            traces.insert(0, (trace_path, own_card, os.getpid()))
        spans, events = {}, None
        if args.trace:
            import spantree
            snap = timing.report(file=io.StringIO())
            spans = {k: v[0] for k, v in snap.items()}
            events = spantree.events()
            timing.timing_enable(False)
            theirs = [dict(e, pid=r["pid"], card=r["card"])
                      for r in records for e in r["events"] or ()]
            for e in theirs:
                spans[e["label"]] = (spans.get(e["label"], 0.0)
                                     + spantree.seconds(e))
            if events is not None or theirs:
                events = [dict(e, pid=os.getpid(), card=own_card)
                          for e in events or ()] + theirs
        launches = dict(_build.LAUNCHES)
        faults = window_faults(records, missing, sampler.spawned())
        if faults:
            print("no result: " + "; ".join(faults), file=sys.stderr)
            return 3
        gc.collect()
        if own_cuda:
            torch.cuda.empty_cache()

        # ---- the check ----
        t0 = time.perf_counter()
        if warm_rc != 0 or failed:
            wrong, detail = 1, {"failed_passes": failed + (warm_rc != 0)}
        else:
            wrong, detail = judge_passes(outs, specs, config["grom"])
        check_s = time.perf_counter() - t0
        correct = wrong <= LIMITS["rows_wrong"]

        mb = genome_mb * len(outs)
        result = dict(correct=bool(correct), attempted=len(outs),
                      failed=failed, metrics={})
        names = {m["name"]: m for m in
                 (cell["per_layer"] if args.trace else cell["end_to_end"])}
        card_peak = max((p[3] for p in on_card), default=None)
        if args.trace:
            import devtrace
            base_ns, rows = devtrace.merge(
                [devtrace.read_trace(*t) for t in traces])
            iv = [r[:4] for r in rows]
            cards = devtrace.by_card(rows, range(chips))
            if events is not None:
                events = [dict(e, start_ns=e["start_ns"] - base_ns,
                               end_ns=e["end_ns"] - base_ns) for e in events]
            ctx = dict(spans=spans, events=events, mb=mb,
                       window_s=window_s, intervals=iv, cards=cards,
                       launches=launches, passes=len(outs), contigs=info,
                       peaks=json.load(open(os.path.join(HERE,
                                                         "peaks.json"))))
            for name, m in names.items():
                v = metric_reader(name)(ctx)
                if v is not None:
                    result["metrics"][name] = {"value": v, "unit": m["unit"]}
        else:
            values = dict(called_mb_per_s=mb / window_s,
                          peak_host_anon_gib=anon_peak / GIB,
                          card_peak_gib=(card_peak / GIB
                                         if card_peak is not None else None),
                          setup_s=setup_s)
            for name, m in names.items():
                if values.get(name) is not None:
                    result["metrics"][name] = {"value": values[name],
                                               "unit": m["unit"]}
        if cuda:
            result["device"] = dict(
                platform="gpu", kind=torch.cuda.get_device_name(0),
                count=chips, memory_peak_bytes=fullest_card(on_card))
            if args.trace:
                busy = devtrace.mean_busy_seconds(cards)
                result["device"].update(busy_s=busy, window_s=window_s)
                result["breakdown"] = dict(
                    device_ops=devtrace.top_ops(iv),
                    idle_gaps=devtrace.idle_gaps(rows, events=events))
        else:
            result["device"] = dict(platform="cpu", kind="cpu", count=0,
                                    memory_peak_bytes=0)
        result["checks"] = {"rows_wrong": {"value": wrong,
                                           "limit": LIMITS["rows_wrong"]}}
        print("setup: generate %.3f s, load %.3f s, warm pass %.3f s; "
              "window %.3f s, %d passes of %.3f Mb (%s s), anonymous memory "
              "%.3f GiB at its start, %.3f GiB this process's peak; %d "
              "worker record(s) [pid, card, card peak, torch loaded] %s; "
              "check %.3f s; launches %s"
              % (gen_s, load_s, warm_s, window_s, len(outs), genome_mb,
                 " ".join("%.3f" % w for w in walls), anon_start / GIB,
                 sampler.own_peak / GIB, len(records),
                 json.dumps([[r["pid"], r["card"], r["card_peak"],
                              r["torch_loaded"]] for r in records]), check_s,
                 json.dumps(launches)),
              file=sys.stderr)
        if not correct:
            with open(log, errors="replace") as f:
                print("program log, last lines:\n" + f.read()[-3000:],
                      file=sys.stderr)
        print("check detail " + json.dumps(detail), file=sys.stderr)
        print("rows_wrong %d limit %d" % (wrong, LIMITS["rows_wrong"]),
              file=sys.stderr)
        sys.stderr.flush()
        print(json.dumps(result))
        sys.stdout.flush()
        return 0
    finally:
        os.environ.pop(workerprobe.ENV, None)
        shutil.rmtree(work, ignore_errors=True)
