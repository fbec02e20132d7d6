"""The benchmark's probe in the worker processes that a pass spawns (the
port's ``-P`` pool), and the window as those workers see it.

A worker that ``multiprocessing`` spawns imports the parent's main script
again: ``benchmark/run.py``, and with it ``harness``, which calls
``install()``. The probe installs itself only in such a child, and only
where the harness has named a control directory in ``ENV`` (before its
warm-up pass). The harness opens and closes the window through files in
that directory (``Window``), so a worker spawned inside the window and one
alive before it opens are measured alike:

* ``<pid>.born`` when the probe installs; ``<pid>.open`` once the worker
  is in the window (at its start, or when the window opens);
* the worker's ``torch.cuda.max_memory_allocated`` on its card over its
  part of the window: its peak is reset when the window opens if the
  worker was alive before, and folded in before every reset the program
  makes (the port resets it at each job's start);
* in the traced run only, the worker's CUDA activity
  (``ProfilerActivity.CUDA``, as the harness traces itself) and the
  program's span events (its recorder switched on, and its events kept
  across the resets the program makes);
* every module of ``FORBIDDEN`` the worker has loaded;
* when it was born, when the pool's initializer returned, and when the
  record was written (Unix-epoch nanoseconds).

It writes ``<pid>.json`` (and ``<pid>.trace.json``) when the window closes
or when the worker exits, whichever comes first. It touches no CUDA before
the pool's initializer (the program's ``_init_worker``, which sets the
worker's card) has returned, and it imports torch in no worker: it uses
torch only where the worker has loaded it, so a host-engine worker stays
free of it.
"""

from __future__ import annotations

import atexit
import json
import os
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

ENV = "GROM_BENCH_PROBE"
FORBIDDEN = ("jax", "jaxlib", "flax", "grom_tpu")
OPENED, CLOSED = "window.open", "window.closed"
PERIOD = 0.05   # seconds between a probe's looks at the control directory
TIMING = "grom_tpu_torch.utils.timing"
SPAWNED = "--multiprocessing-fork"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _write_json(path: str, obj) -> None:
    """``obj`` as JSON at ``path``, whole or not at all."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, default=lambda o: o.item()
                  if hasattr(o, "item") else str(o))
    os.replace(tmp, path)


def _window(path: str) -> Optional[dict]:
    """The window's settings while it is open; None before it opens and
    after it closes."""
    if os.path.exists(os.path.join(path, CLOSED)):
        return None
    try:
        with open(os.path.join(path, OPENED)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


class Probe:
    """One worker's probe (see the module's docstring)."""

    def __init__(self, path: str):
        self.path = path
        self.pid = os.getpid()
        self.born_ns = time.time_ns()
        self.ready_ns = None       # when the pool's initializer returned
        self.lock = threading.Lock()
        self.state = "before"      # "in" the window, then "done"
        self.born_in_window = False
        self.trace = False
        self.card: Optional[int] = None
        self.peak = 0              # peaks folded in before program resets
        self.reset_peak = None     # torch's own reset_peak_memory_stats
        self.prof = None
        self.timing = None
        self.kept: List[dict] = []   # span events kept across resets
        open(self._file("born"), "w").close()
        with self.lock:
            w = _window(path)
            if w is not None:
                self.born_in_window = True
                self._enter(w)

    def _file(self, what: str) -> str:
        return os.path.join(self.path, "%d.%s" % (self.pid, what))

    # ---- entering the window ----
    def _enter(self, w: dict) -> None:
        self.state = "in"
        self.trace = bool(w.get("trace"))
        if self.card is not None:
            # alive before the window: its peak starts at the window
            self.peak = 0
            self.reset_peak(self.card)
        if self.ready_ns is not None:
            self._record()
        open(self._file("open"), "w").close()

    def _record(self) -> None:
        """Switch on the traced run's recorders."""
        if not self.trace:
            return
        if "grom_tpu_torch" in sys.modules:
            import importlib
            timing = importlib.import_module(TIMING)
            reset = timing.reset

            def keeping_reset():
                self.kept.extend(timing.events())
                reset()
            timing.reset = keeping_reset
            timing.timing_enable(True)
            reset()
            self.timing = (timing, reset)
        if self.card is not None:
            from_torch = sys.modules["torch"].profiler
            self.prof = from_torch.profile(
                activities=[from_torch.ProfilerActivity.CUDA])
            self.prof.__enter__()

    def after_init(self) -> None:
        """Run on the worker's main thread once the pool's initializer has
        set its card: take the card, fold the program's peak resets, and
        start the recorders if the window is open."""
        torch = sys.modules.get("torch")
        with self.lock:
            self.ready_ns = time.time_ns()
            if torch is not None and torch.cuda.is_initialized():
                self.card = torch.cuda.current_device()
                self.reset_peak = torch.cuda.reset_peak_memory_stats
                torch.cuda.reset_peak_memory_stats = self._folding_reset
            if self.state == "in":
                self._record()

    def _folding_reset(self, device=None) -> None:
        with self.lock:
            if self.state == "in":
                self.peak = max(self.peak, sys.modules[
                    "torch"].cuda.max_memory_allocated(self.card))
        self.reset_peak(device)

    # ---- leaving it ----
    def flush(self, why: str) -> None:
        """Write the record of the worker's part of the window (once)."""
        with self.lock:
            if self.state != "in":
                self.state = "done"
                return
            self.state = "done"
            rec = dict(pid=self.pid, card=self.card, why=why,
                       born_in_window=self.born_in_window,
                       born_ns=self.born_ns, ready_ns=self.ready_ns,
                       end_ns=time.time_ns(), card_peak=None,
                       trace=None, events=None,
                       torch_loaded="torch" in sys.modules)
            if self.prof is not None:
                self.prof.__exit__(None, None, None)
                rec["trace"] = self._file("trace.json")
                self.prof.export_chrome_trace(rec["trace"])
            if self.card is not None:
                rec["card_peak"] = max(self.peak, sys.modules[
                    "torch"].cuda.max_memory_allocated(self.card))
            if self.timing is not None:
                timing, reset = self.timing
                rec["events"] = self.kept + timing.events()
                timing.timing_enable(False)
                timing.reset = reset
            rec["forbidden"] = forbidden_modules()
            _write_json(self._file("json"), rec)

    def watch(self) -> None:
        """The probe's thread: enter the window when it opens (a worker
        alive before it), write the record when it closes."""
        while True:
            time.sleep(PERIOD)
            with self.lock:
                if self.state == "done":
                    return
                if self.state == "before":
                    w = _window(self.path)
                    if w is not None:
                        self._enter(w)
                    continue
            if os.path.exists(os.path.join(self.path, CLOSED)):
                self.flush("close")


def _wrap_pool_worker(probe: Probe) -> None:
    """Have a ``ProcessPoolExecutor`` worker call ``probe.after_init``
    right after the pool's initializer, and write its record when it
    leaves its loop. The worker unpickles its target after this module
    has run, so it finds the wrapper."""
    from concurrent.futures import process
    inner = process._process_worker

    def _process_worker(call_queue, result_queue, initializer, initargs,
                        *rest, **kw):
        def init(*args):
            if initializer is not None:
                initializer(*args)
            probe.after_init()
        try:
            return inner(call_queue, result_queue, init, initargs, *rest,
                         **kw)
        finally:
            probe.flush("exit")
    process._process_worker = _process_worker


def install() -> Optional[Probe]:
    """Start the probe in a worker that ``multiprocessing`` spawned (its
    interpreter's command line ends in ``--multiprocessing-fork``) from a
    parent that named a control directory; None anywhere else."""
    path = os.environ.get(ENV)
    if not path or SPAWNED not in sys.orig_argv:
        return None
    probe = Probe(path)
    _wrap_pool_worker(probe)
    atexit.register(probe.flush, "exit")
    threading.Thread(target=probe.watch, daemon=True,
                     name="bench-probe").start()
    return probe


# ---- the harness's side ----
class Window:
    """The window as the probes see it, opened and closed through files in
    ``path``. ``live()`` gives the pids of the harness's live
    descendants."""

    def __init__(self, path: str, live: Callable[[], Set[int]]):
        self.path = path
        self.live = live

    def _marked(self, what: str) -> Set[int]:
        tail = "." + what
        return {int(n[:-len(tail)]) for n in os.listdir(self.path)
                if n.endswith(tail) and n[:-len(tail)].isdigit()}

    def open(self, trace: bool, timeout: float = 30.0) -> None:
        """Open the window, forget the probed workers that have ended, and
        wait until every one alive is in the window (its peak reset, its
        recorders on)."""
        _write_json(os.path.join(self.path, OPENED), {"trace": int(trace)})
        born = self._marked("born")
        wait = born & self.live()
        for pid in born - wait:
            os.remove(os.path.join(self.path, "%d.born" % pid))
        t_end = time.monotonic() + timeout
        while wait and time.monotonic() < t_end:
            wait -= self._marked("open")
            wait &= self.live()
            if wait:
                time.sleep(0.01)

    def close(self, timeout: float = 120.0
              ) -> Tuple[List[dict], List[int]]:
        """Close the window and collect the record of every worker that
        lived in it (alive when it opened, or born since): (records, pids
        whose record never came). A worker that has ended without one, or
        is still without one after ``timeout`` seconds, is missing."""
        open(os.path.join(self.path, CLOSED), "w").close()
        want = self._marked("born")
        got: Dict[int, dict] = {}
        missing: List[int] = []
        t_end = time.monotonic() + timeout
        while want:
            have = self._marked("json") & want
            for pid in have:
                with open(os.path.join(self.path, "%d.json" % pid)) as f:
                    got[pid] = json.load(f)
            want -= have
            gone = want - self.live()
            if gone:
                # a record written just before the worker ended counts
                gone -= self._marked("json")
                missing += sorted(gone)
                want -= gone
            if want and time.monotonic() >= t_end:
                missing += sorted(want)
                break
            if want:
                time.sleep(0.01)
        return [got[p] for p in sorted(got)], sorted(missing)
