"""Cells whose pass spawns worker processes: the sampler sums the memory of
the process tree, the probe in each worker (``workerprobe.py``) reports
its card peak, trace and spans, a missing record or a forbidden module
gives no result, and traces of several processes on several cards go onto
one clock. The fake pools and the harness runs here start from
``spawnmain.py``, a main script that the workers import again."""

import json
import os
import subprocess
import sys

import pytest

import devtrace
import harness

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN = os.path.join(HERE, "spawnmain.py")
MIB = 1 << 20
SEED = "3000000019"


def old_anon():
    """The sampler's reading before it summed the descendants."""
    with open("/proc/self/statm") as f:
        v = f.read().split()
    return (int(v[1]) - int(v[2])) * os.sysconf("SC_PAGE_SIZE")


def test_sampler_without_children_reads_this_process():
    assert not harness.has_children()
    s = harness.AnonSampler()
    s.sample()
    assert s.peak == s.own_peak
    assert s.peak == pytest.approx(old_anon(), rel=0.01)
    assert s.seen == {}


def test_sampler_adds_a_child():
    code = ("import sys; b = bytearray(512 << 20)\n"
            "for i in range(0, len(b), 4096): b[i] = 1\n"
            "print('ready', flush=True); sys.stdin.read()")
    s = harness.AnonSampler()
    s.sample()
    before = s.peak
    child = subprocess.Popen([sys.executable, "-c", code],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE)
    try:
        assert child.stdout.readline().strip() == b"ready"
        s.start()
        s.stop()
    finally:
        child.communicate(timeout=60)
    assert s.peak - before >= 512 * MIB
    assert child.pid in s.seen and s.spawned() == set()
    assert s.own_peak < before + 64 * MIB


def pool(mode, tmp_path, trace=1):
    r = subprocess.run([sys.executable, MAIN, "pool", mode, str(tmp_path),
                        str(trace)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["in", "before"])
def test_pool_writes_one_record_per_worker(tmp_path, mode):
    """Two workers, spawned inside the window or alive before it opens
    (each at a card peak of 900 then), run jobs of 300, 200 and 100 bytes,
    each resetting the card's peak at its start as the port's jobs do:
    each worker's record holds the largest job it ran in the window, and
    its spans of every job, across the program's resets."""
    got = pool(mode, tmp_path)
    assert got["missing"] == [] and got["faults"] == []
    recs = got["records"]
    assert len(recs) == 2
    assert sorted(r["card"] for r in recs) == [0, 1]
    assert all(r["born_in_window"] == (mode == "in") for r in recs)
    assert all(r["why"] == ("exit" if mode == "in" else "close")
               for r in recs)
    assert all(r["born_ns"] < r["ready_ns"] < r["end_ns"] for r in recs)
    sizes = []
    for r in recs:
        jobs = [e["attrs"]["size"] for e in r["events"]
                if e["label"] == "job"]
        sizes += jobs
        assert r["card_peak"] == max(jobs, default=0)
        assert os.path.exists(r["trace"])
        assert r["forbidden"] == []
    assert sorted(sizes) == [100, 200, 300]


def test_untraced_pool_records_no_trace_nor_spans(tmp_path):
    recs = pool("in", tmp_path, trace=0)["records"]
    assert len(recs) == 2
    assert all(r["trace"] is None and r["events"] is None for r in recs)
    assert max(r["card_peak"] for r in recs) == 300


def test_missing_record_is_a_fault(tmp_path):
    got = pool("drop", tmp_path)
    assert got["records"] == [] and len(got["missing"]) == 2
    assert got["faults"] and "no record" in got["faults"][0]


def test_forbidden_module_in_a_worker_is_a_fault(tmp_path):
    got = pool("jax", tmp_path)
    assert [r["forbidden"] for r in got["records"]
            if r["forbidden"]] == [["jax"]]
    assert got["faults"] == ["modules jax were loaded"]


def test_spawned_worker_without_probe_is_a_fault():
    assert harness.window_faults([], [], [41]) == [
        "worker(s) [41] ran without the probe"]
    rec = dict(pid=41, forbidden=[])
    assert harness.window_faults([rec], [], [41]) == []


def test_fullest_card_sums_processes_alive_together():
    """(card, born, ended, peak): workers spawned for each pass one after
    another on a card count one at a time; workers alive together add."""
    assert harness.fullest_card([(0, 0, 10, 5), (0, 10, 20, 7),
                                 (0, 20, 30, 6)]) == 7
    assert harness.fullest_card([(0, 0, 10, 5), (0, 1, 9, 7),
                                 (0, 2, 8, 4), (0, 12, 20, 3)]) == 16
    assert harness.fullest_card([(0, 0, 10, 5), (0, 1, 9, 7),
                                 (1, 2, 8, 20)]) == 20
    assert harness.fullest_card([]) == 0


def run_cell(mode, trace):
    r = subprocess.run([sys.executable, MAIN, "harness", mode, SEED,
                        str(trace)], capture_output=True, text=True,
                       timeout=900)
    return r.returncode, r.stdout, r.stderr


@pytest.mark.parametrize("mode,why", [("drop", "no record from worker"),
                                      ("jax", "modules jax were loaded")])
def test_faulty_workers_give_no_result(mode, why):
    rc, out, err = run_cell(mode, 0)
    assert rc != 0
    assert out.strip() == ""
    assert "no result" in err and why in err


def test_cell_of_workers_counts_their_memory():
    """The host engine's -P 2 on two contigs: the peak is the tree's,
    above this process's alone, and the workers loaded no torch."""
    rc, out, err = run_cell("sound", 0)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    line = err.split("setup: ")[1].splitlines()[0]
    own = float(line.split(" GiB this process's peak")[0].split(", ")[-1])
    recs = json.loads(line.split("[pid, card, card peak, torch loaded] ")[1]
                      .split("; check")[0])
    assert len(recs) == 2
    assert all(r[1] is None and r[3] is False for r in recs)
    assert res["metrics"]["peak_host_anon_gib"]["value"] > own + 0.05


def test_traced_cell_of_workers_reads_their_spans():
    """The workers' span events reach the readers: the parent of a -P
    pass runs no CNV stage, its workers do."""
    rc, out, err = run_cell("sound", 1)
    assert rc == 0, err[-3000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["metrics"]["cnv.s_per_mb"]["value"] > 0.0


def trace_file(path, base_ns, events):
    with open(path, "w") as f:
        json.dump({"baseTimeNanoseconds": base_ns, "traceEvents": [
            dict(ph="X", cat=cat, name=name, ts=ts, dur=dur,
                 args={"device": dev}) for cat, name, ts, dur, dev in events]
            + [dict(ph="X", cat="cpu_op", name="aten::add", ts=0, dur=9)]},
                  f)
    return str(path)


BASE = 1_700_000_000_000_000_000
A = [("kernel", "tile_window(Tile)", 0.0, 100.0, 0),
     ("kernel", "zs_table(ZIn)", 200.0, 100.0, 0),
     ("gpu_memcpy", "Memcpy DtoH", 250.0, 150.0, 0)]
B = [("kernel", "tile_window(Tile)", 0.0, 100.0, 1),
     ("kernel", "null_accum(NIn)", 500.0, 50.0, 1)]


def test_two_traces_on_two_cards(tmp_path):
    """Process 2's trace starts 50 us after process 1's: on one clock,
    card 0 is busy 300 us, card 1 150 us, and their mean is the cell's."""
    a = devtrace.read_trace(trace_file(tmp_path / "a.json", BASE, A), 0, 1)
    b = devtrace.read_trace(trace_file(tmp_path / "b.json", BASE + 50_000,
                                       B), 1, 2)
    base, rows = devtrace.merge([b, a])
    assert base == BASE
    assert rows[0] == (0.0, 100.0, "tile_window(Tile)", "kernel", 0, 1)
    assert (50.0, 150.0, "tile_window(Tile)", "kernel", 1, 2) in rows
    assert (550.0, 600.0, "null_accum(NIn)", "kernel", 1, 2) in rows
    cards = devtrace.by_card(rows, range(2))
    assert devtrace.busy_seconds(cards[0]) == pytest.approx(300e-6)
    assert devtrace.busy_seconds(cards[1]) == pytest.approx(150e-6)
    assert devtrace.mean_busy_seconds(cards) == pytest.approx(225e-6)
    iv = [r[:4] for r in rows]
    ctx = dict(intervals=iv, cards=cards, window_s=1e-3)
    assert harness.metric_reader("device.idle_share")(ctx) == \
        pytest.approx(100.0 * (1 - 225e-6 / 1e-3))
    # a card of the cell that ran nothing counts as idle
    four = devtrace.by_card(rows, range(4))
    assert devtrace.mean_busy_seconds(four) == pytest.approx(450e-6 / 4)
    # the gaps in which no card ran anything, led by the span of the
    # process whose activity the gap follows
    evs = [dict(id=1, parent=None, label="cnv.prep", start_ns=400_000,
                end_ns=560_000, thread="MainThread", pid=1),
           dict(id=1, parent=None, label="scan.deposits", start_ns=0,
                end_ns=600_000, thread="MainThread", pid=2)]
    gaps = devtrace.idle_gaps(rows, events=evs)
    assert [g[1] for g in gaps] == pytest.approx([150e-6, 50e-6])
    assert gaps[0][0] == "cnv.prep | Memcpy DtoH -> null_accum"
    assert gaps[1][0] == "scan.deposits | tile_window -> zs_table"


def test_one_trace_reads_as_before(tmp_path):
    """One process on one card: every value is devtrace's answer from the
    trace alone."""
    path = trace_file(tmp_path / "a.json", BASE, A)
    iv = devtrace.device_intervals(path)
    base, rows = devtrace.merge([devtrace.read_trace(path, 0, 7)])
    assert base == BASE and [r[:4] for r in rows] == iv
    cards = devtrace.by_card(rows, range(1))
    assert devtrace.mean_busy_seconds(cards) == devtrace.busy_seconds(iv)
    assert devtrace.top_ops([r[:4] for r in rows]) == devtrace.top_ops(iv)
    assert devtrace.idle_gaps(rows) == devtrace.idle_gaps(iv)
