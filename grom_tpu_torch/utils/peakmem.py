"""Peak memory of a run: the process's resident host memory and the card's.

* Host: the peak resident set size in KiB. ``VmHWM`` of
  ``/proc/self/status`` where the kernel gives it (label ``vmhwm``);
  otherwise the largest resident size a daemon thread saw reading
  ``/proc/self/statm`` every ``SAMPLE_S`` seconds since :func:`start`
  (label ``sampled``: a peak shorter than the period may be missed).
  ``getrusage``'s ru_maxrss is not used: a spawned ``-P`` worker inherits
  its parent's across the exec.
* Card: ``torch.cuda.max_memory_allocated`` and ``max_memory_reserved`` of
  the run's CUDA devices (the largest over them); None on the CPU.

:func:`report` gives both as one JSON-ready dict, which the driver prints
as a ``peak_memory {...}`` line under GROM_TPU_TIMING=1.
"""

from __future__ import annotations

import os
import threading
from typing import Iterable, Optional, Tuple

SAMPLE_S = 0.02
_PAGE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

_lock = threading.Lock()
_sampler: Optional["_Sampler"] = None


def vmhwm_kib(status: Optional[str] = None) -> Optional[int]:
    """VmHWM in KiB from ``status`` (the text of /proc/self/status; read
    when None), or None when it has no such line."""
    if status is None:
        try:
            with open("/proc/self/status") as f:
                status = f.read()
        except OSError:
            return None
    for ln in status.splitlines():
        if ln.startswith("VmHWM:"):
            return int(ln.split()[1])
    return None


def rss_kib() -> Optional[int]:
    """The current resident set size in KiB (/proc/self/statm), or None."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * _PAGE // 1024
    except (OSError, IndexError, ValueError):
        return None


class _Sampler:
    """A daemon thread keeping the largest ``rss_kib`` it reads."""

    def __init__(self):
        self.peak = rss_kib() or 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="grom-peakmem")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(SAMPLE_S):
            self.sample()

    def sample(self) -> int:
        v = rss_kib()
        if v is not None and v > self.peak:
            self.peak = v
        return self.peak

    def stop(self) -> None:
        self._stop.set()
        self._thread.join()


def start(status: Optional[str] = None) -> str:
    """Start watching this process's peak resident memory, and return the
    label its reading will carry: ``vmhwm`` when ``status`` (default: this
    process's /proc/self/status) has VmHWM, else ``sampled``, for which a
    sampler thread starts (once a process)."""
    global _sampler
    if vmhwm_kib(status) is not None:
        return "vmhwm"
    with _lock:
        if _sampler is None:
            _sampler = _Sampler()
    return "sampled"


def stop() -> None:
    """Stop the sampler thread, if one runs (its peak is forgotten)."""
    global _sampler
    with _lock:
        s, _sampler = _sampler, None
    if s is not None:
        s.stop()


def host_peak(status: Optional[str] = None
              ) -> Tuple[Optional[int], Optional[str]]:
    """(peak resident KiB, label): VmHWM when ``status`` (default: this
    process's) has it, else the sampler's peak since :func:`start`, else
    (None, None)."""
    v = vmhwm_kib(status)
    if v is not None:
        return v, "vmhwm"
    s = _sampler
    if s is not None:
        return s.sample(), "sampled"
    return None, None


def card_peak(devices: Iterable = ()) -> Optional[dict]:
    """The largest ``max_memory_allocated`` and ``max_memory_reserved``
    (bytes) over the CUDA devices among ``devices``; None when none is a
    CUDA device (the CPU)."""
    import torch
    cuda = sorted({torch.device(d) for d in devices
                   if torch.device(d).type == "cuda"}, key=str)
    if not cuda:
        return None
    cuda = [torch.device("cuda", torch.cuda.current_device())
            if d.index is None else d for d in cuda]
    for d in cuda:
        torch.cuda.synchronize(d)
    return {"max_allocated": max(torch.cuda.max_memory_allocated(d)
                                 for d in cuda),
            "max_reserved": max(torch.cuda.max_memory_reserved(d)
                                for d in cuda),
            "devices": [str(d) for d in cuda]}


def report(devices: Iterable = ()) -> dict:
    """The peaks as one dict: ``rss_peak_kib`` and ``rss_source``
    (``vmhwm`` or ``sampled``; None when neither could be read) of this
    process, and ``card`` (``card_peak``)."""
    kib, label = host_peak()
    return {"rss_peak_kib": kib, "rss_source": label,
            "card": card_peak(devices)}
