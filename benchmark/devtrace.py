"""The card's activity over the traced window, read from a torch.profiler
chrome trace: every kernel, copy and memset interval, their union, the
kernels that took the most time and the longest gaps between intervals."""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

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


def busy_seconds(iv: List[Tuple[float, float, str, str]]) -> float:
    """Seconds in which any device activity ran (the union of intervals)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e, _, _ in iv:
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
    for s, e, name, _ in iv:
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


def idle_gaps(iv, n: int = 10) -> List[list]:
    """The longest gaps in which the card ran nothing, named by the device
    activities on either side."""
    gaps = []
    end, last = None, ""
    for s, e, name, _ in iv:
        if end is not None and s > end:
            gaps.append(["%s -> %s" % (short_name(last)[:60],
                                       short_name(name)[:60]),
                         (s - end) * 1e-6])
        if end is None or e >= end:
            end, last = e, name
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
