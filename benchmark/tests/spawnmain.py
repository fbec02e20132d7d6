"""A main script for the probe's tests: a worker that ``multiprocessing``
spawns imports the parent's main script again, and with this one
``harness``, which installs the probe (``workerprobe.py``) there.

    python3 spawnmain.py pool <in|before|drop|jax> <dir> <trace 0|1>

runs a fake pass of fake workers (a fake ``torch`` whose card peak is set
by each job, the port's span recorder) under a window opened and closed
through ``dir``, and prints {"records", "missing", "faults"} as its last
line. ``in``: the pool is spawned inside the window; ``before``: it is
alive before the window opens (each worker's peak 900 then) and after it
closes; ``drop``: the workers write no record; ``jax``: a job loads a
module named ``jax``.

    python3 spawnmain.py harness <drop|jax|sound> <seed> <trace 0|1>

runs ``harness.main`` on the CPU with the host engine and ``-P 2`` on two
0.5 Mb contigs (``drop`` and ``jax`` as above, in the port's workers).
"""

import json
import multiprocessing
import os
import sys
import time
import types
from concurrent.futures import ProcessPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import harness  # noqa: E402
import workerprobe  # noqa: E402

MODE = sys.argv[2] if len(sys.argv) > 2 else ""
if workerprobe.SPAWNED in sys.orig_argv:
    # this module is the worker's copy of the parent's main script
    if MODE == "drop":
        workerprobe._write_json = lambda path, obj: None
    elif MODE == "jax" and sys.argv[1] == "harness":
        sys.modules["jax"] = types.ModuleType("jax")


class FakeCuda:
    """The card counters of ``torch.cuda`` the probe reads."""

    def __init__(self, card):
        self.card, self.allocated, self.peak = card, 0, 0

    def is_initialized(self):
        return True

    def current_device(self):
        return self.card

    def max_memory_allocated(self, device=None):
        return self.peak

    def reset_peak_memory_stats(self, device=None):
        self.peak = self.allocated

    def memory_stats_as_nested_dict(self):
        return {"allocated_bytes": {"all": {"current": self.allocated,
                                            "peak": self.peak}}}


class FakeProfile:
    def __init__(self, activities):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"baseTimeNanoseconds": time.time_ns(),
                       "traceEvents": []}, f)


def init(counter):
    with counter.get_lock():
        k = counter.value
        counter.value += 1
    fake = types.ModuleType("torch")
    fake.cuda = FakeCuda(k % 2)
    fake.profiler = types.SimpleNamespace(
        profile=FakeProfile, ProfilerActivity=types.SimpleNamespace(CUDA=1))
    sys.modules["torch"] = fake
    import grom_tpu_torch.utils.timing  # noqa: F401  (the span recorder)


def job(size):
    """One job as the port's pool runs it: reset the span recorder and the
    card's peak, then hold ``size`` bytes at most."""
    from grom_tpu_torch.utils import timing
    cuda = sys.modules["torch"].cuda
    timing.reset()
    cuda.reset_peak_memory_stats(cuda.card)
    with timing.phase("job", size=size):
        cuda.peak = max(cuda.peak, size)
        time.sleep(0.2)
    if MODE == "jax" and size == 300:
        sys.modules["jax"] = types.ModuleType("jax")
    return os.getpid()


def pool_run(path, trace):
    os.environ[workerprobe.ENV] = path
    ctx = multiprocessing.get_context("spawn")
    window = workerprobe.Window(path, lambda: harness.descendants(
        os.getpid()))

    def pool():
        return ProcessPoolExecutor(2, mp_context=ctx, initializer=init,
                                   initargs=(ctx.Value("i", 0),))
    if MODE == "before":
        with pool() as p:
            list(p.map(job, [900, 900]))
            window.open(trace)
            list(p.map(job, [300, 200, 100]))
            records, missing = window.close()
    else:
        window.open(trace)
        with pool() as p:
            list(p.map(job, [300, 200, 100]))
        records, missing = window.close()
    print(json.dumps(dict(records=records, missing=missing,
                          faults=harness.window_faults(records, missing,
                                                       []))))


def harness_run(seed, trace):
    cell = harness.load_cell("human30x.chrom16")
    contigs = [dict(name="chrp%d" % i, length=500_000,
                    hotspots=[[150_000, 190_000, 60.0]],
                    depressions=[[300_000, 350_000, 0.0]],
                    repeats=[[420_000, 423_000, "AT"]]) for i in (1, 2)]
    cell["config"] = dict(cell["config"], contig_length=500_000,
                          engine="host")
    cell["traffic"] = dict(cell["traffic"], contigs=contigs,
                           flags=["-P", "2"])
    return harness.main(["--workload", "human30x.P2cpu", "--seed", seed,
                         "--seconds", "0.01", "--trace", trace],
                        require_cuda=False, device="cpu", cell=cell)


if __name__ == "__main__":
    if sys.argv[1] == "pool":
        pool_run(sys.argv[3], bool(int(sys.argv[4])))
    else:
        sys.exit(harness_run(sys.argv[3], sys.argv[4]))
