"""What a run of the port holds in host memory at its peak.

    python3 tools/peak_probe.py [--step-mib 256] [--numpy] [--trim-s S] \
        [--events] -- <grom_tpu_torch CLI arguments>

Runs the port's CLI (``cli.main``, as ``python -m grom_tpu_torch`` runs
it) in this process, with a thread that reads the resident set size
(``/proc/self/statm``) every 50 ms. Each time it has grown
``--step-mib`` past the last reading's, the thread takes a reading:

* the resident KiB of the mappings with a file and of those without one,
  and the files holding the most (``/proc/self/smaps``, as
  ``tools/rss_baseline.py`` splits it);
* glibc's heap (``mallinfo2``): bytes its arenas hold (``arena``), of
  them in use (``in_use``) and free but kept (``free``), and bytes in
  mmapped blocks (``mmap``); and arena by arena (``malloc_info``): the
  KiB each has from the system and of them free (``arenas``, main arena
  first; one arena a thread that allocated, the ingest producer's
  among them);
* whether an ingest fetch was in flight (``fetching``: the chunks being
  fetched) and the device bytes the queued device jobs (fed but not yet
  drained) have held at most so far in the running scan (``queued``: the
  ``queued_peak`` of the driver's last ``DEPTH_LISTS`` record);
* where the run has created a CUDA context, the pinned host memory of
  torch's caching host allocator (``torch.cuda.host_memory_stats()``:
  bytes of the blocks it holds, handed out or cached, now and at peak);
* with ``--numpy``, under ``tracemalloc``: the numpy data blocks alive
  (numpy reports each to tracemalloc in its own domain, 389047), their
  total, the largest blocks and the source lines that allocated the
  most. tracemalloc slows the scan stage many times over (every Python
  allocation is recorded).

The last reading is the one nearest the run's peak, within one step.
With ``--events``, a reading is also taken at each streamed ingest
fetch's start and end (on the producer thread) and after each drained
detect sub-chunk, each kept in ``events`` with its kind and range: the
comparison of the host, torch and mesh engines by site (numpy's blocks
with ``--numpy``). A
second reading is taken as each chromosome's scan stage ends
(``driver._finish_chromosome`` is entered), with every numpy block of
4·L bytes or more alive then (L, the chromosome's length: one int32
depth list); tracing stops there. ``--trim-s S`` (an experiment, not a
reading) calls glibc's ``malloc_trim(0)`` every S seconds from the
thread: it returns the free pages the heap keeps to the system, and so
shows how much of the peak they make. One line ``peak_probe {...}`` on
stderr at the end. The readings cost time of their own: take walls from
an unprobed run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import threading
import time
import tracemalloc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from rss_baseline import smaps_by_file, top_files  # noqa: E402

NUMPY_DOMAIN = 389047
TOP = 16


def _rss_kib() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") // 1024


class _MallInfo2(ctypes.Structure):
    _fields_ = [(k, ctypes.c_size_t) for k in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]


def heap_stats():
    """glibc's heap in KiB (``mallinfo2``), or None off glibc."""
    try:
        libc = ctypes.CDLL(None)
        fn = libc.mallinfo2
    except (OSError, AttributeError):
        return None
    fn.restype = _MallInfo2
    m = fn()
    return {"arena": m.arena >> 10, "in_use": m.uordblks >> 10,
            "free": m.fordblks >> 10, "top_free": m.keepcost >> 10,
            "mmap": m.hblkhd >> 10}


def arena_stats():
    """glibc's heap arena by arena (``malloc_info``'s XML): a list, main
    arena first, of [KiB from the system, KiB of it free], and the KiB of
    mmapped blocks; None off glibc."""
    import xml.etree.ElementTree as ET
    try:
        libc = ctypes.CDLL(None)
        info, memstream = libc.malloc_info, libc.open_memstream
    except (OSError, AttributeError):
        return None
    buf, size = ctypes.c_void_p(), ctypes.c_size_t()
    memstream.restype = ctypes.c_void_p
    memstream.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                          ctypes.POINTER(ctypes.c_size_t)]
    info.argtypes = [ctypes.c_int, ctypes.c_void_p]
    libc.fclose.argtypes = [ctypes.c_void_p]
    libc.free.argtypes = [ctypes.c_void_p]
    f = memstream(ctypes.byref(buf), ctypes.byref(size))
    if not f:
        return None
    info(0, f)
    libc.fclose(f)
    try:
        root = ET.fromstring(ctypes.string_at(buf, size.value))
    finally:
        libc.free(buf)

    def size_of(node, tag, kind):
        el = node.find("%s[@type='%s']" % (tag, kind))
        return int(el.get("size")) >> 10 if el is not None else 0

    arenas = [[size_of(h, "system", "current"),
               size_of(h, "total", "fast") + size_of(h, "total", "rest")]
              for h in root.findall("heap")]
    return {"arenas": arenas, "mmap": size_of(root, "total", "mmap")}


def pinned_stats():
    """Bytes of pinned host memory held by torch's caching host allocator
    (``allocated_bytes``: blocks handed out or cached; ``active_bytes``:
    handed out), current and peak; None before a CUDA context exists."""
    torch = sys.modules.get("torch")
    cuda = getattr(torch, "cuda", None)     # None while torch imports
    if cuda is None or not cuda.is_initialized():
        return None
    st = torch.cuda.host_memory_stats()
    return {k: st[k] for k in ("allocated_bytes.current",
                               "allocated_bytes.peak", "active_bytes.current",
                               "active_bytes.peak", "allocations.current")
            if k in st}


def numpy_blocks(min_bytes: int = 0) -> dict:
    """The numpy data blocks alive now: their count and KiB, the ``TOP``
    largest (KiB, allocating line) and the ``TOP`` lines that allocated
    the most KiB; with ``min_bytes``, also every block at least that
    large."""
    if not tracemalloc.is_tracing():
        return {}
    snap = tracemalloc.take_snapshot().filter_traces(
        [tracemalloc.DomainFilter(True, NUMPY_DOMAIN)])
    traces = sorted(snap.traces, key=lambda t: -t.size)

    def where(tb) -> str:
        return " <- ".join("%s:%d" % (os.path.relpath(fr.filename, REPO)
                                      if fr.filename.startswith(REPO)
                                      else os.path.basename(fr.filename),
                                      fr.lineno) for fr in tb[:3])

    out = {"n": len(traces), "kib": sum(t.size for t in traces) >> 10,
           "largest": [[t.size >> 10, where(t.traceback)]
                       for t in traces[:TOP]],
           "by_line": [[s.size >> 10, s.count, where(s.traceback)]
                       for s in snap.statistics("lineno")[:TOP]]}
    if min_bytes:
        out["at_least_%d" % min_bytes] = [[t.size, where(t.traceback)]
                                          for t in traces
                                          if t.size >= min_bytes]
    return out


def reading(min_bytes: int = 0) -> dict:
    rec = {"t_s": time.perf_counter() - T0, "rss_kib": _rss_kib()}
    with open("/proc/self/smaps") as f:
        by = smaps_by_file(f.read())
    rec["anon_kib"] = by["anon_kib"]
    rec["file_kib"] = sum(v[0] for v in by["file"].values())
    rec["top_files"] = top_files(by["file"], 8)
    rec["heap"] = heap_stats()
    rec["arenas"] = arena_stats()
    rec["pinned"] = pinned_stats()
    rec["fetching"] = sorted(FETCHING)
    rec["queued"] = queued_stats()
    rec["numpy"] = numpy_blocks(min_bytes)
    return rec


T0 = time.perf_counter()
# the ingest chunks whose fetch is in flight, (t0, t1)
FETCHING: set = set()


def queued_stats():
    """The device bytes the queued jobs of the running (or last) streamed
    scan have held at most so far; None before the first scan."""
    drv = sys.modules.get("grom_tpu_torch.driver")
    recs = getattr(drv, "DEPTH_LISTS", None)
    return recs[-1].get("queued_peak", 0) if recs else None


class Events:
    """``--events``: a reading at each streamed ingest fetch's start and
    end and after each drained detect sub-chunk, kept in order."""

    def __init__(self, driver):
        self.records: list = []
        self.lock = threading.Lock()
        streamed = driver.call_chromosome_streamed

        def probed_streamed(chrom, refid, out_name, cfg, drv, mq, hez,
                            fetch, *a, **kw):
            def probed_fetch(t0, t1):
                with self.lock:
                    FETCHING.add((t0, t1))
                self.log("fetch_start", t0, t1)
                try:
                    return fetch(t0, t1)
                finally:
                    with self.lock:
                        FETCHING.discard((t0, t1))
                    self.log("fetch_end", t0, t1)
            return streamed(chrom, refid, out_name, cfg, drv, mq, hez,
                            probed_fetch, *a, **kw)

        add = driver._ChunkDetect.add_window

        def probed_add(det, d0, d1, *a, **kw):
            out = add(det, d0, d1, *a, **kw)
            self.log("drained", d0, d1)
            return out

        driver.call_chromosome_streamed = probed_streamed
        driver._ChunkDetect.add_window = probed_add

    def log(self, kind: str, lo: int, hi: int) -> None:
        rec = dict(event=kind, lo=lo, hi=hi, **reading())
        with self.lock:
            self.records.append(rec)


class Watch:
    """The sampler thread: a reading each time the RSS has grown
    ``step_kib`` past the last reading's."""

    def __init__(self, step_kib: int, trim_s: float = 0.0):
        self.step = step_kib
        self.trim_s = trim_s
        self.trims = 0
        self.errors: list = []
        self.peak = None
        self.max_kib = 0
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self.loop, daemon=True,
                                       name="peak-probe")
        self.thread.start()

    def loop(self) -> None:
        trim = ctypes.CDLL(None).malloc_trim if self.trim_s else None
        next_trim = time.perf_counter() + self.trim_s
        while not self.stop.wait(0.05):
            if trim is not None and time.perf_counter() >= next_trim:
                trim(0)
                self.trims += 1
                next_trim = time.perf_counter() + self.trim_s
            kib = _rss_kib()
            self.max_kib = max(self.max_kib, kib)
            last = self.peak["rss_kib"] if self.peak else 0
            if kib >= last + self.step:
                try:
                    rec = reading()
                except Exception as exc:   # keep watching: say what failed
                    self.errors.append(repr(exc))
                    continue
                with self.lock:
                    if self.peak is None or rec["rss_kib"] > last:
                        self.peak = rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--step-mib", type=int, default=256)
    ap.add_argument("--numpy", action="store_true",
                    help="trace numpy's blocks (slow)")
    ap.add_argument("--trim-s", type=float, default=0.0,
                    help="malloc_trim(0) every this many seconds")
    ap.add_argument("--events", action="store_true",
                    help="a reading at each fetch's start and end and "
                         "each drained detect sub-chunk")
    ap.add_argument("cli", nargs=argparse.REMAINDER)
    a = ap.parse_args()
    argv = a.cli[1:] if a.cli[:1] == ["--"] else a.cli
    # the checkout to probe comes first on PYTHONPATH (tools/torch_scale.py
    # --repos); this one otherwise
    sys.path.append(REPO)
    if a.numpy:
        tracemalloc.start(3)
    from grom_tpu_torch import cli, driver
    scan_ends = []
    finish = driver._finish_chromosome

    def probed_finish(chrom, *args, **kw):
        scan_ends.append(dict(L=len(chrom), **reading(4 * len(chrom))))
        if tracemalloc.is_tracing():
            tracemalloc.stop()
        return finish(chrom, *args, **kw)

    driver._finish_chromosome = probed_finish
    events = Events(driver) if a.events else None
    watch = Watch(a.step_mib << 10, a.trim_s)
    rc = cli.main(argv)
    watch.stop.set()
    watch.thread.join()
    print("peak_probe " + json.dumps({
        "rss_max_sampled_kib": watch.max_kib, "trims": watch.trims,
        "errors": watch.errors[:5],
        "peak": watch.peak,
        "scan_end": scan_ends,
        "events": events.records if events else None}), file=sys.stderr,
        flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
