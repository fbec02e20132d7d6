"""The port's spans over the traced window (``grom_tpu_torch.utils.timing``
``events()``): each event's label, start and end on the Unix-epoch clock
in nanoseconds, id, parent id, thread, contig id and attributes.

The harness takes them from the recorder loaded in its own process
(``events``) and from each worker's probe, tags each with its process's
``pid`` and ``card``, and hands them to the per-layer readers as
``ctx["events"]`` on the trace's clock: ``start_ns`` and ``end_ns`` in
nanoseconds after the merged trace's ``baseTimeNanoseconds`` (a chrome
trace's ``ts`` is microseconds after it). A program without that recorder
gives None, and so do the readers. Span ids are a process's own: match a
parent by ``pid`` and ``id``."""

from __future__ import annotations

import bisect
import sys
from typing import Dict, List, Optional, Tuple

import devtrace

MAIN = "MainThread"


def events() -> Optional[List[dict]]:
    """The loaded recorder's events, or None where it keeps none."""
    timing = sys.modules.get("grom_tpu_torch.utils.timing")
    read = getattr(timing, "events", None)
    return read() if read is not None else None


def seconds(ev: dict) -> float:
    return (ev["end_ns"] - ev["start_ns"]) * 1e-9


def labelled(evs: List[dict], label: str) -> List[dict]:
    return [e for e in evs if e["label"] == label]


def self_segments(evs: List[dict], thread: str = MAIN
                  ) -> List[Tuple[int, int, str]]:
    """(start_ns, end_ns, label) of the stretches of ``thread``'s time in
    which each span was its innermost open span, in time order: a span's
    interval less its children's on the same thread. The spans of one
    thread nest, so these partition the time its outermost spans cover."""
    own = [e for e in evs if e["thread"] == thread]
    kids: Dict[int, List[dict]] = {}
    for e in own:
        kids.setdefault(e["parent"], []).append(e)
    out = []
    for e in own:
        t = e["start_ns"]
        for k in sorted(kids.get(e["id"], ()), key=lambda k: k["start_ns"]):
            if k["start_ns"] > t:
                out.append((t, k["start_ns"], e["label"]))
            t = max(t, k["end_ns"])
        if e["end_ns"] > t:
            out.append((t, e["end_ns"], e["label"]))
    out.sort()
    return out


def self_seconds(evs: List[dict], thread: str = MAIN) -> Dict[str, float]:
    """Each label's self time on ``thread``: its spans' time less the part
    their child spans cover."""
    out: Dict[str, float] = {}
    for s, e, label in self_segments(evs, thread):
        out[label] = out.get(label, 0.0) + (e - s) * 1e-9
    return out


def idle_intervals(iv, lo_us: float, hi_us: float
                   ) -> List[Tuple[float, float]]:
    """(start_us, end_us) of each stretch of [lo_us, hi_us) in which the
    card ran none of the intervals ``iv`` (devtrace's
    ``device_intervals``, sorted)."""
    out = []
    end = lo_us
    for s, e, _, _ in iv:
        if s > end and end < hi_us:
            out.append((end, min(s, hi_us)))
        end = max(end, e)
    if end < hi_us:
        out.append((end, hi_us))
    return out


class Innermost:
    """The innermost main-thread span at a time on the trace's clock."""

    def __init__(self, evs: List[dict], base_ns: int):
        seg = self_segments(evs)
        self.starts = [(s - base_ns) * 1e-3 for s, _, _ in seg]
        self.ends = [(e - base_ns) * 1e-3 for _, e, _ in seg]
        self.labels = [lab for _, _, lab in seg]

    def at(self, t_us: float) -> str:
        i = bisect.bisect_right(self.starts, t_us) - 1
        return self.labels[i] if i >= 0 and t_us < self.ends[i] else ""

    def split(self, s_us: float, e_us: float) -> Dict[str, float]:
        """Seconds of [s_us, e_us) under each innermost span ("" where no
        main-thread span is open)."""
        out: Dict[str, float] = {}
        i = bisect.bisect_right(self.ends, s_us)
        t = s_us
        while t < e_us:
            if i < len(self.starts) and self.starts[i] <= t:
                u, label = min(self.ends[i], e_us), self.labels[i]
                i += 1
            else:
                u = min(self.starts[i], e_us) if i < len(self.starts) \
                    else e_us
                label = ""
            out[label] = out.get(label, 0.0) + (u - t) * 1e-6
            t = u
        return out


def named_gaps(iv, evs: List[dict], base_ns: int, n: int = 10
               ) -> List[list]:
    """devtrace's ``idle_gaps`` with ``evs`` on the Unix-epoch clock of a
    trace whose ``baseTimeNanoseconds`` is ``base_ns``: each gap's name led
    by the innermost main-thread span open at its midpoint."""
    return devtrace.idle_gaps(iv, n, [
        dict(e, start_ns=e["start_ns"] - base_ns,
             end_ns=e["end_ns"] - base_ns) for e in evs])


def least_squares_slope(y: List[float]) -> float:
    """The slope of ``y`` against 0, 1, 2, ... by least squares."""
    n = len(y)
    mx, my = (n - 1) / 2.0, sum(y) / n
    return (sum((i - mx) * (v - my) for i, v in enumerate(y))
            / sum((i - mx) ** 2 for i in range(n)))
