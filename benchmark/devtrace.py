"""The cards' activity over the traced window, read from the torch.profiler
chrome traces of every process that ran on a card: every kernel, copy and
memset interval, on one clock, with its card and process; their union on
each card, the kernels that took the most time and the longest gaps
between intervals.

An interval is ``(start_us, end_us, name, category)`` (``device_intervals``:
microseconds after its trace's ``baseTimeNanoseconds``); ``read_trace``
and ``merge`` add its card and pid, ``(start_us, end_us, name, category,
card, pid)``. The functions that take intervals take either form."""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Tuple

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_intervals(trace_path: str) -> List[Tuple[float, float, str, str]]:
    """(start_us, end_us, name, category) of each device activity."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    out = []
    for ev in events:
        cat = ev.get("cat", "")
        if ev.get("ph") == "X" and cat in _DEVICE_CATS and "dur" in ev:
            ts = float(ev["ts"])
            out.append((ts, ts + float(ev["dur"]), ev.get("name", ""), cat))
    out.sort()
    return out


def read_trace(trace_path: str, card: int, pid: int
               ) -> Tuple[int, List[tuple]]:
    """(baseTimeNanoseconds, [(start_us, end_us, name, category, card,
    pid)]) of one process's trace: each activity's card is the CUDA device
    its event names, else ``card``. The intervals come through
    ``device_intervals``, the one reader of a trace's intervals, which
    ``tools/span_idle.py`` hooks; the second read here takes the base and
    the devices."""
    iv = device_intervals(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    dev = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and ev.get("cat", "") in _DEVICE_CATS \
                and "dur" in ev and "device" in ev.get("args", {}):
            ts = float(ev["ts"])
            dev[(ts, ts + float(ev["dur"]), ev.get("name", ""),
                 ev["cat"])] = int(ev["args"]["device"])
    return (int(trace.get("baseTimeNanoseconds", 0)),
            [r + (dev.get(r, card), pid) for r in iv])


def merge(traces: List[Tuple[int, List[tuple]]]) -> Tuple[int, List[tuple]]:
    """Several processes' traces (``read_trace``'s) on one clock: (the
    earliest base, every interval shifted onto it, sorted)."""
    base = min((b for b, _ in traces), default=0)
    out = []
    for b, rows in traces:
        shift = (b - base) * 1e-3
        out += [(r[0] + shift, r[1] + shift) + r[2:] for r in rows]
    out.sort()
    return base, out


def by_card(rows: List[tuple], cards: Iterable[int]
            ) -> Dict[int, List[tuple]]:
    """Each card's intervals ``(start_us, end_us, name, category)``, for
    every card of ``cards`` and every other card that ran one."""
    out: Dict[int, List[tuple]] = {c: [] for c in cards}
    for r in rows:
        out.setdefault(r[4], []).append(r[:4])
    return out


def mean_busy_seconds(cards: Dict[int, List[tuple]]) -> float:
    """``busy_seconds`` of each card, averaged over the cards."""
    return sum(busy_seconds(iv) for iv in cards.values()) / len(cards)


def busy_seconds(iv: List[Tuple[float, float, str, str]]) -> float:
    """Seconds in which any device activity ran (the union of intervals)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e, *_ in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def seconds_by_name(iv) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for s, e, name, *_ in iv:
        out[name] = out.get(name, 0.0) + (e - s) * 1e-6
    return out


def short_name(name: str) -> str:
    """A kernel's name without its namespace or argument list."""
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:120]


def top_ops(iv, n: int = 10) -> List[list]:
    by: Dict[str, float] = {}
    for name, sec in seconds_by_name(iv).items():
        k = short_name(name)
        by[k] = by.get(k, 0.0) + sec
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(iv, n: int = 10, events: Optional[List[dict]] = None
              ) -> List[list]:
    """The longest gaps in which no card ran anything, named by the device
    activities on either side. With ``events`` (span events, ``start_ns``
    and ``end_ns`` after the trace's base), each name is led by the
    innermost main-thread span open at the gap's midpoint in the process
    whose activity the gap follows (``(no span)`` where none is)."""
    inner = None
    if events is not None:
        import spantree
        mine: Dict[object, List[dict]] = {}
        for e in events:
            mine.setdefault(e.get("pid"), []).append(e)
        inner = {pid: spantree.Innermost(evs, 0)
                 for pid, evs in mine.items()}
    gaps = []
    end, last = None, None
    for r in iv:
        s, e = r[0], r[1]
        if end is not None and s > end:
            name = "%s -> %s" % (short_name(last[2])[:60],
                                 short_name(r[2])[:60])
            if inner is not None:
                at = inner.get(last[5] if len(last) > 5 else None)
                name = "%s | %s" % (
                    (at.at((s + end) / 2) if at else "") or "(no span)",
                    name)
            gaps.append([name, (s - end) * 1e-6])
        if end is None or e >= end:
            end, last = e, r
    gaps.sort(key=lambda g: -g[1])
    return gaps[:n]


def roofline_share(ctx, kernels, bytes_moved: float):
    """Per cent of a kernel family's memory roofline: the least time the
    card's HBM needs for ``bytes_moved`` over the summed profiler time of
    the kernels whose names hold one of ``kernels``; None when none ran."""
    t = sum(e - s for s, e, name, cat in ctx["intervals"]
            if cat == "kernel" and any(k in name for k in kernels)) * 1e-6
    if t <= 0 or bytes_moved <= 0:
        return None
    return 100.0 * bytes_moved / ctx["peaks"]["hbm_bytes_per_s"] / t
