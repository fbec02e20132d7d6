"""The readers of the port's span events (``spantree.py`` and the metrics
``ingest_wait.s_per_mb``, ``fixed.s_per_contig``,
``run_growth.mib_per_run``, which read them from the readers' ``ctx``) on
synthetic events, on a program without the recorder, and in a traced
harness run on the CPU; the idle gaps named by the main thread's spans."""

import functools
import json

import pytest

import devtrace
import harness
import spantree
from test_bench_run_cpu import SEED, tiny_cell

S = 1_000_000_000   # nanoseconds a second


def ev(id, label, start, end, parent=None, thread="MainThread", **attrs):
    return dict(id=id, parent=parent, label=label, start_ns=start,
                end_ns=end, thread=thread, contig=None, attrs=attrs)


def window(runs=3, anon=(100, 110, 120)):
    """``runs`` passes of one contig each: a run of 10 s holding a contig
    from 2 to 9 s, whose set-up takes 1 s, with two ingest waits of 0.25 s
    on the main thread and a read of the producer's."""
    out = []
    for r in range(runs):
        t, i = r * 10 * S, r * 10
        out += [
            ev(i + 1, "run", t, t + 10 * S, anon_bytes=anon[r] << 20),
            ev(i + 2, "contig", t + 2 * S, t + 9 * S, i + 1, name="c"),
            ev(i + 3, "contig.setup", t + 2 * S, t + 3 * S, i + 2),
            ev(i + 4, "ingest.wait", t + 3 * S, t + 3 * S + S // 4, i + 2),
            ev(i + 5, "ingest.wait", t + 5 * S, t + 5 * S + S // 4, i + 2),
            ev(i + 6, "ingest.read_bam", t + 3 * S, t + 4 * S, i + 2,
               thread="grom-chunk-ingest"),
        ]
    return out


def read(name, evs, mb=16.0):
    return harness.metric_reader(name)(dict(mb=mb, events=evs))


def test_ingest_wait_per_mb():
    assert read("ingest_wait.s_per_mb", window(), mb=48.0) \
        == pytest.approx(1.5 / 48.0)


def test_fixed_per_contig():
    # 3 s of each run outside its contig, plus its 1 s of set-up
    assert read("fixed.s_per_contig", window()) \
        == pytest.approx(4.0)


@pytest.mark.parametrize("anon,slope", [((100, 110, 120), 10.0),
                                        ((100, 100, 100), 0.0),
                                        ((130, 100, 130), 0.0),
                                        ((100, 90, 70), -15.0)])
def test_run_growth_slope(anon, slope):
    assert read("run_growth.mib_per_run", window(anon=anon)) \
        == pytest.approx(slope)


NAMES = ("ingest_wait.s_per_mb", "fixed.s_per_contig",
         "run_growth.mib_per_run")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("evs", [None, [], window(runs=2)],
                         ids=["no recorder", "no events", "two runs"])
def test_no_reading(name, evs):
    """None where the program keeps no events, records none, or (the
    growth) ran under three passes."""
    got = read(name, evs)
    if evs and name != "run_growth.mib_per_run":
        assert got is not None
    else:
        assert got is None


def test_program_without_recorder(monkeypatch):
    """A program whose timing module has no ``events`` (the port before
    its span recorder) gives no event list and no reading."""
    import sys
    import types
    monkeypatch.setitem(sys.modules, "grom_tpu_torch.utils.timing",
                        types.SimpleNamespace(report=lambda **k: {}))
    assert spantree.events() is None
    for name in NAMES:
        assert read(name, spantree.events(), mb=1.0) is None


def test_self_seconds_and_split():
    evs = [ev(1, "run", 0, 10 * S), ev(2, "contig", 2 * S, 9 * S, 1),
           ev(3, "ingest.wait", 3 * S, 4 * S, 2),
           ev(4, "ingest.read_bam", 0, 9 * S, None, thread="other")]
    assert spantree.self_seconds(evs) == pytest.approx(
        {"run": 3.0, "contig": 6.0, "ingest.wait": 1.0})
    # on the trace's clock (us after a base of 1 s): run -1e6..9e6, contig
    # 1e6..8e6, the wait 2e6..3e6
    inner = spantree.Innermost(evs, base_ns=S)
    assert inner.at(2.5e6) == "ingest.wait"
    assert inner.at(-0.5e6) == "run" and inner.at(20e6) == ""
    assert inner.split(0.5e6, 12e6) == pytest.approx(
        {"run": 1.5, "contig": 6.0, "ingest.wait": 1.0, "": 3.0})


def test_idle_intervals():
    iv = [(10.0, 20.0, "a", "kernel"), (15.0, 30.0, "b", "kernel"),
          (40.0, 50.0, "c", "gpu_memcpy")]
    assert spantree.idle_intervals(iv, 0.0, 60.0) == [
        (0.0, 10.0), (30.0, 40.0), (50.0, 60.0)]
    assert spantree.idle_intervals(iv, 12.0, 45.0) == [(30.0, 40.0)]


def test_named_gaps_lead_with_the_span():
    """Every gap devtrace finds, with its seconds and in its order, named
    first by the innermost main-thread span open at its midpoint."""
    base = 5 * S
    iv = [(0.0, 100.0, "Memcpy_HtoD", "gpu_memcpy"),
          (300.0, 400.0, "tile_window(int)", "kernel"),
          (350.0, 380.0, "zs_table", "kernel"),
          (1400.0, 1500.0, "Memcpy_DtoH", "gpu_memcpy"),
          (1600.0, 1700.0, "null_accum", "kernel")]
    us = lambda t: base + int(t * 1000)
    evs = [ev(1, "run", us(-10), us(2000)),
           ev(2, "cnv.winscan_dev", us(390), us(1450), 1),
           ev(3, "scan.deposits", us(120), us(290), 1)]
    want = devtrace.idle_gaps(iv)
    got = spantree.named_gaps(iv, evs, base)
    assert [g[1] for g in got] == [g[1] for g in want]
    assert [g[0] for g in got] == ["%s | %s" % (s, g[0]) for s, g in zip(
        ["cnv.winscan_dev", "scan.deposits", "run"], want)]


def test_traced_run_reports_span_metrics(capsys, monkeypatch):
    """A traced harness run on the CPU (the torch engine's plain kernels)
    reports the three metrics from the port's spans."""
    from grom_tpu_torch import driver
    monkeypatch.setattr(driver, "run",
                        functools.partial(driver.run, device="cpu"))
    rc = harness.main(["--workload", "human30x.chrom16", "--seed", str(SEED),
                       "--seconds", "0.01", "--trace", "1"],
                      require_cuda=False, device="cpu", cell=tiny_cell())
    assert rc == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["correct"] is True
    m = res["metrics"]
    assert m["ingest_wait.s_per_mb"]["value"] >= 0.0
    assert m["fixed.s_per_contig"]["value"] > 0.0
    assert m["fixed.s_per_contig"]["unit"] == "s/contig"
    # one pass in the window: no slope
    assert "run_growth.mib_per_run" not in m
