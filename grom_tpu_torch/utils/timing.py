"""Phase timing and spans of the port: the counterpart of the reference's
``#ifdef DO_TIMING`` rdtsc spans (src/GROM.c:58-65, :1111-1121, and the
timers[] blocks around each scan phase, e.g. :5849-6400, :16628-17001).

Off by default; GROM_TPU_TIMING=1 (or ``timing_enable()``) turns it on.
Off, ``phase`` hands back one shared do-nothing context: it reads no clock
and records nothing.

On, each ``with phase(label, **attrs)`` is a span. It adds its wall time,
the thread's CPU seconds and minor faults, the peak host RSS and the
card's running peak at its end to ``label``'s total, which ``report()``
prints as a table, and it records an event (``events()``):

* its label, start and end (``time.perf_counter_ns``);
* its id and its parent's: the innermost span open on its thread, or, for
  a thread's outermost span, the span open where the thread's target was
  wrapped by ``carry``; None where there is neither;
* its thread's name;
* its contig: the id of the innermost ``contig`` span around it, on its
  thread or on the thread that carried it;
* its attributes: those passed, those ``set`` on it, and, where torch has
  initialized CUDA, ``card_allocated`` and ``card_peak``: the current
  device's allocated bytes and their running peak at its end. Reading
  them does not synchronize, and nothing here resets the peak.

Events are kept in memory until ``reset()``. Thread-safe; each process
keeps its own.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

# the label of the span that opens a contig (driver.run): the contig of
# every span under it
CONTIG = "contig"


class Totals(NamedTuple):
    """One label's sums over its spans (``report()``)."""
    wall: float          # seconds
    cpu_usr: float       # thread CPU seconds
    cpu_sys: float
    minflt: int          # the thread's minor page faults
    calls: int
    livemax: int         # peak host RSS in bytes at the spans' ends
    card_peak: Optional[int]   # the card's running peak at the last end


_ZERO = Totals(0.0, 0.0, 0.0, 0, 0, 0, None)
_NO_SPAN = (None, None)   # (parent id, contig id) outside every span

_lock = threading.Lock()
_totals: Dict[str, Totals] = {}
_events: List[tuple] = []
_ids = itertools.count(1)
_local = threading.local()
_clock = time.perf_counter_ns
_enabled = os.environ.get("GROM_TPU_TIMING", "") == "1"


def _anchor_now() -> Tuple[int, int]:
    return time.time_ns(), _clock()


_anchor = _anchor_now()


def _thread_times() -> Tuple[float, float, int]:
    """(user, sys, minflt) of the calling thread (Linux)."""
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_THREAD)
        return ru.ru_utime, ru.ru_stime, ru.ru_minflt
    except (ImportError, ValueError, AttributeError):
        return 0.0, 0.0, 0


def _pool_live_max() -> int:
    """Peak resident host bytes of the process so far (utils/peakmem.py
    ``running_peak``: VmHWM, or the sampler's peak since ``peakmem.start``;
    0 if neither is read). Read at phase ends; the first phase whose end
    observes a new global peak is where it happened."""
    from grom_tpu_torch.utils import peakmem
    return (peakmem.running_peak() or 0) << 10


def _card_memory() -> Optional[Tuple[int, int]]:
    """(allocated, running peak) bytes of the current CUDA device where
    torch is loaded and has initialized CUDA, else None. Imports nothing,
    synchronizes nothing."""
    cuda = getattr(sys.modules.get("torch"), "cuda", None)
    if cuda is None or not cuda.is_initialized():
        return None
    st = cuda.memory_stats_as_nested_dict()["allocated_bytes"]["all"]
    return st["current"], st["peak"]


def _stack() -> list:
    """The calling thread's open spans: (id, contig id), innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = st = []
        return st


def _top() -> Tuple[Optional[int], Optional[int]]:
    st = _stack()
    return st[-1] if st else getattr(_local, "base", _NO_SPAN)


class _Off:
    """The context ``phase`` hands back when timing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return None

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("label", "attrs", "id", "parent", "contig", "t0", "cpu0")

    def __init__(self, label: str, attrs: dict):
        self.label = label
        self.attrs = attrs

    def set(self, **attrs) -> None:
        """Add attributes to the span's event."""
        self.attrs.update(attrs)

    def __enter__(self):
        self.parent, contig = _top()
        self.id = next(_ids)
        self.contig = self.id if self.label == CONTIG else contig
        _stack().append((self.id, self.contig))
        self.cpu0 = _thread_times()
        self.t0 = _clock()
        return self

    def __exit__(self, et, exc, tb):
        t1 = _clock()
        u1, s1, f1 = _thread_times()
        u0, s0, f0 = self.cpu0
        lm = _pool_live_max()
        card = _card_memory()
        _stack().pop()
        if card is not None:
            self.attrs["card_allocated"], self.attrs["card_peak"] = card
        ev = (self.id, self.parent, self.label, self.t0, t1,
              threading.current_thread().name, self.contig, self.attrs)
        with _lock:
            tot = _totals.get(self.label, _ZERO)
            _totals[self.label] = Totals(
                tot.wall + (t1 - self.t0) * 1e-9, tot.cpu_usr + (u1 - u0),
                tot.cpu_sys + (s1 - s0), tot.minflt + (f1 - f0),
                tot.calls + 1, max(tot.livemax, lm),
                card[1] if card is not None else tot.card_peak)
            _events.append(ev)
        return None


def timing_enable(on: bool = True) -> None:
    global _enabled, _anchor
    _enabled = on
    if on:
        _anchor = _anchor_now()


def timing_enabled() -> bool:
    return _enabled


def phase(label: str, **attrs):
    """A span under ``label`` (see the module's docstring) when timing is
    on; a shared context that does nothing when it is off. Its ``set``
    adds attributes; a caller whose attributes cost anything computes
    them only when ``timing_enabled()``."""
    if not _enabled:
        return _OFF
    return _Span(label, attrs)


def carry(target):
    """``target`` wrapped to run as a thread's target under the span open
    here: the thread's outermost spans take it as their parent, and its
    contig. ``target`` itself when timing is off."""
    if not _enabled:
        return target
    base = _top()

    def run(*args, **kwargs):
        _local.base = base
        try:
            return target(*args, **kwargs)
        finally:
            del _local.base
    return run


def reset() -> None:
    """Drop the totals and events, and take the clock anchor again."""
    global _anchor
    with _lock:
        _totals.clear()
        _events.clear()
        _anchor = _anchor_now()


def events() -> List[dict]:
    """The events since the last ``reset()``, in the order they ended:
    dicts of ``id``, ``parent``, ``label``, ``start_ns`` and ``end_ns`` on
    the Unix-epoch clock in nanoseconds (a torch.profiler chrome trace's
    ``baseTimeNanoseconds + ts * 1000``), ``thread``, ``contig`` and
    ``attrs``."""
    with _lock:
        evs = list(_events)
        wall0, perf0 = _anchor
    off = wall0 - perf0
    return [dict(id=i, parent=p, label=lab, start_ns=t0 + off,
                 end_ns=t1 + off, thread=th, contig=c, attrs=dict(a))
            for i, p, lab, t0, t1, th, c, a in evs]


def report(file=None) -> Dict[str, Totals]:
    """Print the per-phase table (wall, thread-user and thread-sys
    seconds, minor faults, peak host RSS at the phase's last end, calls)
    sorted by total wall time, and return a snapshot of it: ``Totals`` by
    label, wall seconds at index 0."""
    with _lock:
        snap = dict(_totals)
    if _enabled and snap:
        f = file or sys.stderr
        width = max(len(k) for k in snap)
        print("== grom_tpu timing ==", file=f)
        print("%-*s %9s %9s %9s %8s %8s"
              % (width, "", "wall", "cpu-usr", "cpu-sys", "minflt",
                 "livemax"), file=f)
        for k, t in sorted(snap.items(), key=lambda kv: -kv[1].wall):
            print("%-*s %8.3fs %8.3fs %8.3fs %7dk %7dM  x%d"
                  % (width, k, t.wall, t.cpu_usr, t.cpu_sys, t.minflt // 1000,
                     t.livemax >> 20, t.calls), file=f)
    return snap
