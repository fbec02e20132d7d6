"""Pooled numpy allocations for the per-chromosome hot path.

On sandboxed kernels (gVisor-class — this host included) first-touch page
faults cost ~5s/GiB of *sys* time, while writes to already-touched pages run
at memory bandwidth (~30x cheaper). The pipeline cycles through multi-GiB of
dense per-chromosome accumulators and decode buffers; pooling them turns
first-touch faults into cheap memset/overwrite.

The reference has the same concern in miniature: it allocates its ~70
window arrays once and reuses them across the whole run
(src/GROM.c:2548-5740). This pool is the whole-pipeline generalisation.

Usage contract: ``POOL.empty/zeros`` hand out views of pooled raw buffers.
``POOL.recycle()`` returns *everything previously handed out* to the free
list — the caller (the driver, at chromosome boundaries) guarantees no
live references remain. ``POOL.release(a)`` returns one array early.
Code that runs outside the driver (unit tests, library use) simply never
recycles, which degrades to ordinary allocation semantics.
"""

from __future__ import annotations

import threading
from typing import List

import numpy as np


class BufferPool:
    def __init__(self) -> None:
        self._free: List[np.ndarray] = []   # 1-D uint8 raw buffers
        self._used: List[np.ndarray] = []
        self._lock = threading.Lock()       # ingest producer + compute thread

    # -- internals ---------------------------------------------------------
    def _take_raw(self, nbytes: int) -> np.ndarray:
        with self._lock:
            best_i = -1
            best_cap = -1
            for i, b in enumerate(self._free):
                cap = b.nbytes
                if cap >= nbytes and (best_cap < 0 or cap < best_cap):
                    best_i, best_cap = i, cap
            # reuse only when the fit isn't grossly wasteful
            if best_i >= 0 and best_cap <= max(2 * nbytes,
                                               nbytes + (32 << 20)):
                raw = self._free.pop(best_i)
            else:
                raw = np.empty(max(int(nbytes), 1 << 12), np.uint8)
            self._used.append(raw)
            return raw

    # -- public ------------------------------------------------------------
    def empty(self, shape, dtype) -> np.ndarray:
        dt = np.dtype(dtype)
        shp = (int(shape),) if np.isscalar(shape) else tuple(int(s) for s in shape)
        n = 1
        for s in shp:
            n *= s
        raw = self._take_raw(n * dt.itemsize)
        return raw[: n * dt.itemsize].view(dt).reshape(shp)

    def zeros(self, shape, dtype) -> np.ndarray:
        a = self.empty(shape, dtype)
        a.fill(0)
        return a

    def release(self, a: np.ndarray) -> None:
        """Return one previously-taken array's raw buffer to the free list.
        The caller must drop all views of it."""
        base = a
        while isinstance(base, np.ndarray) and base.base is not None:
            base = base.base
        with self._lock:
            for i, u in enumerate(self._used):
                if u is base:
                    self._free.append(self._used.pop(i))
                    return

    def recycle(self) -> None:
        """All handed-out buffers become free. Caller guarantees no live
        views of pooled memory remain reachable."""
        with self._lock:
            self._free.extend(self._used)
            self._used.clear()

    def trim(self) -> None:
        with self._lock:
            self._free.clear()


POOL = BufferPool()
