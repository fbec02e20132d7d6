"""The port's span recorder (``grom_tpu_torch/utils/timing.py``).

* Each span's event: its parent (the innermost span open on its thread,
  or the span under which ``carry`` started the thread), its contig (the
  innermost ``contig`` span around it, across carried threads), its
  times, from which a span's self time follows.
* ``report()``'s totals are the sums of the events; the card's memory is
  read at span ends only where CUDA is initialized, never reset.
* Off, ``phase`` reads no clock, records nothing and imports nothing.
* The events' clock is the torch.profiler chrome trace's.
* A traced streamed torch-engine run (plain kernels on the CPU) on
  cnvrich: one ``contig`` a chromosome, the ingest wait on the main
  thread, the producer's reads under the same contig, a ``run`` with its
  anonymous bytes, and the same VCF as the untraced run. A traced
  host-engine run loads no torch.
* On the card: a span around a tile-kernel launch and synchronize holds
  the kernel's profiler interval.
"""

import json
import os
import threading
import time

import pytest
import torch

from grom_tpu_torch.utils import timing
from test_torch_slice import DATA, DATE, _cli

torch.set_num_threads(1)
MS = 1_000_000


@pytest.fixture
def traced(monkeypatch):
    """Timing on, from an empty record; off again after the test."""
    monkeypatch.setattr(timing, "_enabled", True)
    timing.reset()
    yield timing
    timing.reset()


@pytest.fixture
def clock(monkeypatch):
    """A clock the test sets by hand (``clock[0]``, nanoseconds)."""
    now = [0]
    monkeypatch.setattr(timing, "_clock", lambda: now[0])
    return now


def _by_label(evs):
    out = {}
    for e in evs:
        out.setdefault(e["label"], []).append(e)
    return out


def _in_thread(fn, carried):
    t = threading.Thread(target=timing.carry(fn) if carried else fn,
                         name="side")
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()


@pytest.mark.parametrize("where", ["nested", "carried thread",
                                   "thread not carried", "outside contig"])
def test_parent_and_contig(traced, where):
    """A span's parent is the innermost span open on its thread; a carried
    thread's outermost spans take the span open where it was carried, and
    its contig; a thread started without ``carry`` has neither."""
    with timing.phase("run"):
        if where == "outside contig":
            with timing.phase("ingest.fasta_index"):
                pass
        else:
            with timing.phase("contig", name="chr1", length=5):
                with timing.phase("scan.device"):
                    if where == "nested":
                        with timing.phase("scan.device.launch"):
                            pass
                    else:
                        def work():
                            with timing.phase("ingest.read_bam"):
                                with timing.phase("inner"):
                                    pass
                        _in_thread(work, where == "carried thread")
    ev = _by_label(timing.events())
    (run,) = ev["run"]
    assert run["parent"] is None and run["contig"] is None
    if where == "outside contig":
        (fi,) = ev["ingest.fasta_index"]
        assert fi["parent"] == run["id"] and fi["contig"] is None
        return
    (contig,) = ev["contig"]
    assert contig["parent"] == run["id"] and contig["contig"] == contig["id"]
    assert contig["attrs"] == {"name": "chr1", "length": 5}
    (dev,) = ev["scan.device"]
    assert dev["parent"] == contig["id"] and dev["contig"] == contig["id"]
    if where == "nested":
        (launch,) = ev["scan.device.launch"]
        assert launch["parent"] == dev["id"]
        assert launch["contig"] == contig["id"]
        assert launch["thread"] == dev["thread"] == "MainThread"
        return
    (read,), (inner,) = ev["ingest.read_bam"], ev["inner"]
    assert read["thread"] == inner["thread"] == "side"
    assert inner["parent"] == read["id"]
    if where == "carried thread":
        assert read["parent"] == dev["id"]
        assert read["contig"] == inner["contig"] == contig["id"]
    else:
        assert read["parent"] is None
        assert read["contig"] is None and inner["contig"] is None


def test_self_time_from_events(traced, clock):
    """A span's self time is its duration less its children's, all read
    from the events: 100 ns less 30 and 20."""
    with timing.phase("a"):
        clock[0] = 10
        with timing.phase("b"):
            clock[0] = 40
        clock[0] = 50
        with timing.phase("c"):
            clock[0] = 55
            with timing.phase("d"):
                clock[0] = 60
            clock[0] = 70
        clock[0] = 100
    evs = timing.events()
    dur = {e["id"]: e["end_ns"] - e["start_ns"] for e in evs}
    kids = {}
    for e in evs:
        kids[e["parent"]] = kids.get(e["parent"], 0) + dur[e["id"]]
    self_ns = {e["label"]: dur[e["id"]] - kids.get(e["id"], 0) for e in evs}
    assert self_ns == {"a": 50, "b": 30, "c": 15, "d": 5}


def test_report_totals_equal_event_sums(traced):
    """Each label's wall total and call count in ``report()`` are the sums
    over its events, on every thread."""
    def work():
        for _ in range(3):
            with timing.phase("ingest.read_bam"):
                time.sleep(0.001)
    with timing.phase("contig"):
        for _ in range(4):
            with timing.phase("scan.deposits"):
                time.sleep(0.001)
        _in_thread(work, True)
    snap = timing.report()
    ev = _by_label(timing.events())
    assert set(snap) == set(ev) == {"contig", "scan.deposits",
                                    "ingest.read_bam"}
    for label, evs in ev.items():
        assert snap[label].calls == len(evs)
        assert snap[label].wall == pytest.approx(
            sum(e["end_ns"] - e["start_ns"] for e in evs) * 1e-9, abs=1e-9)
        assert snap[label].wall == snap[label][0]


def test_card_memory_read_at_ends_never_reset(traced, monkeypatch):
    """Where CUDA is initialized every span ends with the card's allocated
    bytes and running peak (``phase_card_bytes``: the peak at each label's
    last end), read without a synchronize or a reset; where it is not,
    none is read."""
    from grom_tpu_torch.driver import phase_card_bytes
    with timing.phase("before"):
        pass
    stats = {"current": 100, "peak": 300}

    def refused(*a, **k):
        raise AssertionError("the recorder reset or synchronized the card")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict",
                        lambda: {"allocated_bytes": {"all": dict(stats)}})
    for name in ("reset_peak_memory_stats", "reset_max_memory_allocated",
                 "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refused)
    with timing.phase("scan.device"):
        pass
    stats.update(current=50, peak=700)
    with timing.phase("call.cnv"):
        pass
    ev = _by_label(timing.events())
    assert ev["before"][0]["attrs"] == {}
    assert ev["scan.device"][0]["attrs"] == {"card_allocated": 100,
                                             "card_peak": 300}
    assert ev["call.cnv"][0]["attrs"] == {"card_allocated": 50,
                                          "card_peak": 700}
    assert phase_card_bytes(timing.report()) == {"scan.device": 300,
                                                 "call.cnv": 700}


@pytest.mark.parametrize("use", ["label", "attributes", "set", "carry"])
def test_off_reads_no_clock_and_records_nothing(monkeypatch, use):
    """Off, every form of a span is the one shared do-nothing context: no
    clock, thread time or memory is read, and nothing is recorded."""
    def boom(*a, **k):
        raise AssertionError("read while timing is off")
    monkeypatch.setattr(timing, "_enabled", False)
    for name in ("_clock", "_thread_times", "_pool_live_max",
                 "_card_memory"):
        monkeypatch.setattr(timing, name, boom)
    timing._events.clear()
    timing._totals.clear()
    if use == "carry":
        fn = object()
        assert timing.carry(fn) is fn
    else:
        span = timing.phase("a", n=1) if use == "attributes" \
            else timing.phase("a")
        assert span is timing._OFF
        with span as s:
            if use == "set":
                s.set(anon_bytes=1)
    assert timing.events() == [] and timing.report() == {}


def test_off_imports_nothing():
    """In a fresh process with GROM_TPU_TIMING unset, spans, ``carry`` and
    the readers load no module beyond the recorder's own imports."""
    code = (
        "import sys\n"
        "from grom_tpu_torch.utils import timing\n"
        "mods = set(sys.modules)\n"
        "with timing.phase('run') as s, timing.phase('contig', name='c'):\n"
        "    s.set(anon_bytes=1)\n"
        "timing.carry(print)\n"
        "assert timing.events() == [] and timing.report() == {}\n"
        "assert set(sys.modules) == mods, sorted(set(sys.modules) - mods)\n"
        "assert 'torch' not in sys.modules\n")
    r = _cli(["-c", code], {"GROM_TPU_TIMING": ""})
    assert r.returncode == 0, r.stderr[-3000:]


def test_events_share_the_profiler_clock(traced, tmp_path):
    """A span around a ``record_function`` under a CPU-activity profile:
    its start and end agree with the profiler's interval, on the chrome
    trace's clock (``baseTimeNanoseconds + ts * 1000``), within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timing.phase("marked"):
            with record_function("marked"):
                time.sleep(0.02)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    (mark,) = [e for e in trace["traceEvents"]
               if e.get("name") == "marked" and e.get("ph") == "X"]
    start = trace["baseTimeNanoseconds"] + int(mark["ts"] * 1000)
    end = start + int(mark["dur"] * 1000)
    (span,) = timing.events()
    assert abs(span["start_ns"] - start) < MS
    assert abs(span["end_ns"] - end) < MS
    assert abs(span["start_ns"] - time.time_ns()) < 60_000 * MS


def _cnvrich_run(out, traced_run, monkeypatch):
    """The streamed torch engine (plain kernels on the CPU) through
    ``cli.main`` on cnvrich, at 600,000 / 300,000 bases a chunk."""
    from grom_tpu_torch import cli, driver
    monkeypatch.setenv("GROM_TPU_CHUNK_BASES", "600000")
    monkeypatch.setenv("GROM_TPU_DETECT_BASES", "300000")
    monkeypatch.setenv("GROM_TPU_TORCH_ENGINE", "torch")
    monkeypatch.setenv("GROM_TPU_SYNC_INGEST", "0")
    monkeypatch.setattr(timing, "_enabled", traced_run)
    timing.reset()
    with monkeypatch.context() as mp:
        orig = driver.run
        mp.setattr(driver, "run", lambda cfg: orig(
            cfg, file_date=DATE, device="cpu"))
        d = os.path.join(DATA, "cnvrich")
        assert cli.main(["-i", os.path.join(d, "ds.bam"), "-r",
                         os.path.join(d, "ds.fa"), "-o", out,
                         "-V", "0.0001"]) == 0
    return timing.events()


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_traced_streamed_torch_run(tmp_path, monkeypatch):
    """One ``contig`` a chromosome; the main thread's ``ingest.wait`` and
    the producer's ``ingest.read_bam`` under the same contig, the
    producer's outermost spans its children; a ``run`` around it all with
    its anonymous bytes; the same files as the untraced run."""
    plain = _cnvrich_run(str(tmp_path / "plain.vcf"), False, monkeypatch)
    assert plain == []
    evs = _cnvrich_run(str(tmp_path / "traced.vcf"), True, monkeypatch)
    timing.reset()
    for suffix in (".vcf", ".ctx.vcf"):
        assert _read(str(tmp_path / "traced") + suffix) == \
            _read(str(tmp_path / "plain") + suffix), suffix
    ev = _by_label(evs)
    (run,) = ev["run"]
    assert run["attrs"]["anon_bytes"] > 0 and run["parent"] is None
    (contig,) = ev["contig"]
    assert contig["parent"] == run["id"]
    assert contig["attrs"]["length"] == 1_200_000
    waits = ev["ingest.wait"]
    assert len(waits) == 2 and all(
        w["thread"] == "MainThread" and w["contig"] == contig["id"]
        for w in waits)
    reads = [e for e in ev["ingest.read_bam"]
             if e["thread"] == "grom-chunk-ingest"]
    assert reads and all(e["contig"] == contig["id"]
                         and e["parent"] == contig["id"] for e in reads)
    assert [e["parent"] for e in ev["ingest.producer_wait"]] == \
        [contig["id"]]
    setups = ev["contig.setup"]
    assert len(setups) == 2 and all(e["parent"] == contig["id"]
                                    for e in setups)
    for e in evs:
        assert run["start_ns"] <= e["start_ns"] <= e["end_ns"] \
            <= run["end_ns"], e["label"]


def test_traced_host_engine_loads_no_torch():
    """Under GROM_TPU_TIMING=1 the host-engine CLI records its spans (a
    ``run`` with its anonymous bytes, a ``contig`` a chromosome) and
    loads no torch."""
    d = os.path.join(DATA, "ds200k")
    code = (
        "import sys, tempfile, os\n"
        "from grom_tpu_torch import cli\n"
        "from grom_tpu_torch.utils import timing\n"
        "out = os.path.join(tempfile.mkdtemp(), 'o.vcf')\n"
        "assert cli.main(['-i', %r, '-r', %r, '-o', out]) == 0\n"
        "ev = timing.events()\n"
        "(run,) = [e for e in ev if e['label'] == 'run']\n"
        "assert run['attrs']['anon_bytes'] > 0, run\n"
        "assert 'card_allocated' not in run['attrs']\n"
        "assert len([e for e in ev if e['label'] == 'contig']) == 1\n"
        "assert 'torch' not in sys.modules, 'torch was loaded'\n"
        % (os.path.join(d, "ds.bam"), os.path.join(d, "ds.fa")))
    r = _cli(["-c", code], {"GROM_TPU_TIMING": "1",
                            "GROM_TPU_TORCH_ENGINE": "host",
                            "GROM_TPU_DEVICE_SV": "",
                            "GROM_TPU_DEVICE_CNV": ""})
    assert r.returncode == 0, r.stderr[-3000:]


@pytest.mark.cuda
def test_span_holds_tile_kernel_on_card(traced, tmp_path):
    """On the card: a span around a tile-kernel launch and a synchronize
    holds the kernel's profiler interval, within 0.5 ms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from grom_tpu_torch.ops import accumulate as tacc
    from grom_tpu_torch.ops.state import tile_from_args
    from test_torch_tile_kernel import _spike_args
    tile, params = tile_from_args(*_spike_args(True), "cuda")
    tacc.tile_launch(tile, **params)
    torch.cuda.synchronize()
    timing.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with timing.phase("tile"):
            tacc.tile_launch(tile, **params)
            torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base = trace["baseTimeNanoseconds"]
    kernels = [e for e in trace["traceEvents"] if e.get("ph") == "X"
               and e.get("cat") == "kernel" and "tile_window" in e["name"]]
    assert kernels
    (span,) = timing.events()
    for k in kernels:
        start = base + int(k["ts"] * 1000)
        end = start + int(k["dur"] * 1000)
        assert span["start_ns"] - MS // 2 <= start
        assert end <= span["end_ns"] + MS // 2
