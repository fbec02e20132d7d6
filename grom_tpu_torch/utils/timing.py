"""Phase timing instrumentation — the TPU-host equivalent of the reference's
``#ifdef DO_TIMING`` rdtsc spans (src/GROM.c:58-65, :1111-1121, and the
timers[] blocks around each scan phase, e.g. :5849-6400, :16628-17001).

Off by default; enable with GROM_TPU_TIMING=1 (or timing_enable()). Timers
nest freely and aggregate by label across calls; report() prints a sorted
table to stderr. Thread-safe for the multiprocessing driver: each process
reports its own table.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Tuple

_lock = threading.Lock()
_totals: Dict[str, Tuple[float, float, float, int]] = {}
_enabled = os.environ.get("GROM_TPU_TIMING", "") == "1"


def _thread_times() -> Tuple[float, float, int]:
    """(user, sys, minflt) of the calling thread (Linux)."""
    try:
        import resource
        ru = resource.getrusage(resource.RUSAGE_THREAD)
        return ru.ru_utime, ru.ru_stime, ru.ru_minflt
    except (ImportError, ValueError, AttributeError):
        return 0.0, 0.0, 0


def _pool_acquired() -> int:
    """Cold slab bytes acquired so far: always 0, the port has no slab
    pool."""
    return 0


def _pool_live_max() -> int:
    """Peak resident host bytes of the process so far (utils/peakmem.py:
    VmHWM, or the sampler's peak since ``peakmem.start``; 0 if neither is
    read), the port's counterpart of the slab pool's live peak. Sampled at
    phase ends; the first phase whose end observes a new global peak is
    where it happened."""
    from grom_tpu_torch.utils import peakmem
    kib, _ = peakmem.host_peak()
    return (kib or 0) << 10


def timing_enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def timing_enabled() -> bool:
    return _enabled


@contextmanager
def phase(label: str) -> Iterator[None]:
    """Accumulate wall-clock time under ``label`` when timing is enabled."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    u0, s0, f0 = _thread_times()
    a0 = _pool_acquired()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        u1, s1, f1 = _thread_times()
        a1 = _pool_acquired()
        lm = _pool_live_max()
        with _lock:
            tot, du, ds, df, da, n, plm = _totals.get(
                label, (0.0, 0.0, 0.0, 0, 0, 0, 0))
            _totals[label] = (tot + dt, du + (u1 - u0), ds + (s1 - s0),
                              df + (f1 - f0), da + (a1 - a0), n + 1,
                              max(plm, lm))


def reset() -> None:
    with _lock:
        _totals.clear()


def report(file=None) -> Dict[str, Tuple[float, float, float, int]]:
    """Print the per-phase table (wall, thread-user, thread-sys seconds,
    calls) sorted by total wall time and return a snapshot of it."""
    with _lock:
        snap = dict(_totals)
    if _enabled and snap:
        f = file or sys.stderr
        width = max(len(k) for k in snap)
        print("== grom_tpu timing ==", file=f)
        print("%-*s %9s %9s %9s %8s %8s %8s"
              % (width, "", "wall", "cpu-usr", "cpu-sys", "minflt", "acq",
                 "livemax"), file=f)
        for k, (tot, du, ds, df, da, n, plm) in sorted(
                snap.items(), key=lambda kv: -kv[1][0]):
            print("%-*s %8.3fs %8.3fs %8.3fs %7dk %6dM %7dM  x%d"
                  % (width, k, tot, du, ds, df // 1000, da >> 20, plm >> 20,
                     n), file=f)
    return snap
