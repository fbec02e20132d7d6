"""The card's idle time and host copies of one traced benchmark window,
laid to the port's spans (``grom_tpu_torch/utils/timing.py``).

    python3 tools/span_idle.py --workload human30x.chrom16 --seed N \
        [--seconds 51] [--out DIR]

Runs the cell's traced window in this process as ``benchmark/run.py
--trace 1`` does (``benchmark/harness.py``: the harness's result line is
printed as usual), keeps the profiler trace's clock, then prints one
``span_idle {...}`` JSON line and writes it, with the window's span
events (``events``), to ``<out>/span_idle.<workload>.<seed>.json``
(``--out``, default ``build/span_idle``):

* ``idle_by_span``: seconds of the window in which the card ran nothing,
  by the innermost main-thread span open then ("" where none is: between
  passes), and ``idle_outside_stages_share``: the share of the window
  idle under no span below ``contig`` (``run``, ``contig`` or none);
* ``copies_by_span``: seconds of each kind of host copy by the innermost
  main-thread span open at the copy's start;
* ``self_by_span``: each label's main-thread self seconds over the window;
* ``idle_gaps``: the ten longest gaps (``benchmark/devtrace.py``), each
  led by the span open at its midpoint (``benchmark/spantree.py``);
* the three span metrics of the cell's traced line, the passes' walls and
  anonymous bytes, and the spans a pass;
* ``walk``: the CNV walk's counts over the window, summed over the
  ``cnv.winscan_dev`` spans' attributes (``bases``, ``resumes``,
  ``batches``, ``calls``; 0 where the spans carry none);
* ``span_ns``: what one empty span costs on the main thread with timing
  on and CUDA initialized, and with timing off (the mean of 20,000).

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
SPANS = 20_000


def span_ns(timing, on: bool) -> float:
    """Mean nanoseconds of one empty ``phase`` on this thread."""
    timing.timing_enable(on)
    t0 = time.perf_counter_ns()
    for _ in range(SPANS):
        with timing.phase("probe"):
            pass
    dt = time.perf_counter_ns() - t0
    timing.timing_enable(False)
    return dt / SPANS


def analyse(evs, base: int, iv) -> dict:
    """The window's readings (see the module's docstring) from the span
    events ``evs``, a trace's ``baseTimeNanoseconds`` and its device
    intervals ``iv`` (``devtrace.device_intervals``)."""
    import devtrace
    import harness
    import spantree
    runs = sorted(spantree.labelled(evs, "run"),
                  key=lambda e: e["start_ns"])
    lo = (runs[0]["start_ns"] - base) * 1e-3
    hi = (runs[-1]["end_ns"] - base) * 1e-3
    window_s = (hi - lo) * 1e-6
    inner = spantree.Innermost(evs, base)
    idle = {}
    for s, e in spantree.idle_intervals(iv, lo, hi):
        for label, sec in inner.split(s, e).items():
            idle[label] = idle.get(label, 0.0) + sec
    copies = {}
    for s, e, name, cat in iv:
        if cat == "gpu_memcpy" and lo <= s < hi:
            key = "%s | %s" % (devtrace.short_name(name),
                               inner.at(s) or "(no span)")
            copies[key] = copies.get(key, 0.0) + (e - s) * 1e-6
    mb = sum(e["attrs"]["length"]
             for e in spantree.labelled(evs, "contig")) / 1e6
    metrics = {name: harness.metric_reader(name)(dict(mb=mb))
               for name in ("ingest_wait.s_per_mb", "fixed.s_per_contig",
                            "run_growth.mib_per_run")}
    walks = spantree.labelled(evs, "cnv.winscan_dev")
    by_value = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1]))
    return dict(
        window_s=window_s, passes=len(runs),
        pass_walls=[spantree.seconds(r) for r in runs],
        pass_anon_bytes=[r["attrs"].get("anon_bytes") for r in runs],
        spans=len(evs), spans_per_pass=len(evs) / len(runs),
        idle_s=sum(idle.values()), idle_by_span=by_value(idle),
        idle_outside_stages_share=100.0 * sum(
            idle.get(k, 0.0) for k in ("", "run", "contig")) / window_s,
        copies_by_span=by_value(copies),
        self_by_span=by_value(spantree.self_seconds(evs)),
        idle_gaps=spantree.named_gaps(iv, evs, base),
        walk={k: sum(e["attrs"].get(k, 0) for e in walks)
              for k in ("bases", "resumes", "batches", "calls")},
        metrics=metrics)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", default="51")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "span_idle"))
    args = ap.parse_args()
    sys.path[:0] = [BENCH, REPO]
    import devtrace
    import harness

    # the harness reads the trace once, through devtrace: keep its clock
    trace = {}
    read_intervals = devtrace.device_intervals

    def keep(path):
        with open(path) as f:
            trace["base"] = json.load(f)["baseTimeNanoseconds"]
        trace["iv"] = read_intervals(path)
        return trace["iv"]
    devtrace.device_intervals = keep
    rc = harness.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", args.seconds,
                       "--trace", "1"])
    if rc != 0 or "base" not in trace:
        return rc or 1

    import torch

    from grom_tpu_torch.utils import timing
    out = dict(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(0))
    evs = timing.events()
    out.update(analyse(evs, trace["base"], trace["iv"]))
    timing.reset()
    out["span_ns"] = {"on": span_ns(timing, True),
                      "off": span_ns(timing, False)}
    timing.reset()
    print("span_idle " + json.dumps(out), flush=True)
    os.makedirs(args.out, exist_ok=True)
    out["events"] = evs
    with open(os.path.join(args.out, "span_idle.%s.%d.json"
                           % (args.workload, args.seed)), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
