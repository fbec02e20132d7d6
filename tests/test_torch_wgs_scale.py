"""The port at a human chromosome's size: the counterpart of
test_wgs_scale.py for grom_tpu_torch.

* Chunk-geometry independence: the torch engine on the CPU (the plain
  versions of the kernels) on cnvrich, which has CNV rows, at three
  (ingest chunk, detect sub-chunk) geometries: C = 4 D (the 16 Mi / 4 Mi
  ratio a chromosome of 134,217,728 bases or more gets, scaled down),
  C = 2 D, and one chunk holding the whole chromosome; each byte-identical
  to the port's host engine at its default geometry.
* Runs in one process hold no more of the buffer pool than the first.
* The peak-memory reader (utils/peakmem.py): VmHWM where the status text
  has it, else the sampler, labelled ``sampled``; the sampled peak of a
  process that allocates 256 MB and frees it; no card peak on the CPU;
  the driver's ``launches`` and ``peak_memory`` lines under
  GROM_TPU_TIMING=1, and the ``-P`` job reports.
* The real-size test (``slow``, ``cuda``, and GROM_TPU_RUN_WGS=1, as
  grom_tpu's): tools/torch_scale.py's host, torch, mesh, torch_4m1m and
  torch_P8 runs on the 250 Mb chromosome, byte-identical, each device
  run's peak host RSS (the ``-P 8`` worker's) at or below the host run's:
  the counterpart of grom_tpu's memory gate.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from test_torch_slice import DATA, REPO, _cli

torch.set_num_threads(1)

CNVRICH = os.path.join(DATA, "cnvrich")
ARGS = ["-i", os.path.join(CNVRICH, "ds.bam"), "-r",
        os.path.join(CNVRICH, "ds.fa"), "-V", "0.0001"]
# (ingest chunk, detect sub-chunk) bases; cnvrich is 1.2 Mb long
GEOMETRIES = {"c4d": (1 << 20, 1 << 18), "c2d": (1 << 19, 1 << 18),
              "whole": (2 << 20, 1 << 19)}


def _body(path):
    with open(path, "rb") as f:
        return b"".join(ln for ln in f if not ln.startswith(b"##fileDate"))


def _run(out, engine, monkeypatch, geometry=None):
    from grom_tpu_torch.cli import parse_args
    from grom_tpu_torch.driver import run
    monkeypatch.delenv("GROM_TPU_CHUNK_BASES", raising=False)
    monkeypatch.delenv("GROM_TPU_DETECT_BASES", raising=False)
    if geometry is not None:
        monkeypatch.setenv("GROM_TPU_CHUNK_BASES", str(geometry[0]))
        monkeypatch.setenv("GROM_TPU_DETECT_BASES", str(geometry[1]))
    run(parse_args(ARGS + ["-o", str(out)]), engine=engine, device="cpu")
    return out


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        return _run(tmp_path_factory.mktemp("host") / "host.vcf", "host", mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_chunk_geometry_matches_host(geometry, host_run, tmp_path,
                                     monkeypatch):
    out = _run(tmp_path / "torch.vcf", "torch", monkeypatch,
               GEOMETRIES[geometry])
    with open(out) as f:
        rows = [ln for ln in f if not ln.startswith("#")]
    assert any("SD:Z:CN" in r for r in rows), "no CNV row"
    assert _body(out) == _body(host_run)
    assert _body(str(out)[:-4] + ".ctx.vcf") == \
        _body(str(host_run)[:-4] + ".ctx.vcf")


def test_runs_in_one_process_hold_no_more_pooled_memory(tmp_path,
                                                        monkeypatch):
    """Three runs of the driver in one process on cnvrich (indexed, under
    GROM_TPU_SRC_MMAP_MIN): the buffer pool holds no more after the third
    than after the first. Each run's header read used to leave a copy of
    the whole BAM there, which nothing returned."""
    from grom_tpu_torch.utils.bufpool import POOL
    held = []
    for i in range(3):
        _run(tmp_path / ("%d.vcf" % i), "host", monkeypatch)
        held.append(sum(b.nbytes for b in POOL._used))
    assert held[2] == held[0], held


def _batch(fx="cnvrich"):
    """(batch, eligible, L) of a fixture's first chromosome, as the
    streamed driver builds them."""
    from grom_tpu_torch.config import GromConfig
    from grom_tpu_torch.ingest import bam as bam_mod
    from grom_tpu_torch.ingest.batches import build_batch
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    header, reads = bam_mod.read_bam(os.path.join(DATA, fx, "ds.bam"))
    batch = build_batch(reads, 0, cfg.min_mapq, cfg.add_factor, cfg.rmdup)
    eligible = batch.keep & (batch.pos >= 700)
    return batch, eligible, int(header.ref_lengths[0]), cfg


@pytest.mark.parametrize("chunk", [1 << 16, 300_007, 1 << 20, 4 << 20])
def test_rd_window_matches_rd_lists(chunk):
    """The torch engine's depth lists chunk by chunk
    (``driver._accumulate_rd_window``, O(chunk)) equal
    ``scan._accumulate_rd_lists`` over the same chunks (O(L) each) and over
    the whole chromosome at once."""
    import numpy as np

    from grom_tpu_torch.call import scan as scan_mod
    from grom_tpu_torch.driver import _RdView, _accumulate_rd_window
    batch, eligible, L, cfg = _batch()
    got = [np.zeros(L, np.int32) for _ in range(3)]
    per_chunk = [np.zeros(L, np.int32) for _ in range(3)]
    for t0 in range(0, L, chunk):
        t1 = min(t0 + chunk, L)
        _accumulate_rd_window(*got, L, batch, eligible, cfg, t0, t1)
        scan_mod._accumulate_rd_lists(_RdView(*per_chunk, L), batch,
                                      eligible, cfg, lo=t0, hi=t1)
    whole = [np.zeros(L, np.int32) for _ in range(3)]
    scan_mod._accumulate_rd_lists(_RdView(*whole, L), batch, eligible, cfg)
    for a, b, c in zip(got, per_chunk, whole):
        assert np.array_equal(a, b) and np.array_equal(a, c)
    assert got[1].max() > 0 and got[0].sum() > got[1].sum()


def _walk_inputs(L, seed=8):
    """Seeded per-base inputs of the window walk over L bases, with gated
    stretches at the start (no gated-definite base before 7,000)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    depth = rng.integers(0, 60, L).astype(np.int32)
    depth[:5000] = 0
    mq = rng.integers(0, 60, L).astype(np.int16)
    mq[:3000] = 0
    gc = rng.integers(0, 101, L).astype(np.int64)
    low_acgt = (rng.random(L) < 0.5).astype(np.int8)
    low_acgt[:7000] = 1
    stdev = rng.standard_normal(L)
    thr = rng.random((2, 101)) * 60
    return depth, mq, gc, low_acgt, stdev, thr


@pytest.mark.parametrize("side", [1, -1])
@pytest.mark.parametrize("block", [1 << 12, 99_991, 1 << 24])
def test_seed_inputs_in_blocks(side, block, monkeypatch):
    """``cnv_device.seed_inputs`` built block by block equals the whole-array
    formulation (numpy below), gated stretches at the start (gcls_idx -1)
    included: ``pack_flags``' bits, the base's own class bits and the int32
    gcls_idx; ``device_seed_inputs`` carries the same flags and the
    side-signed z."""
    import numpy as np

    from grom_tpu_torch.config import GromConfig
    from grom_tpu_torch.ops import cnv_device
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    L = 300_001
    depth, mq, gc, low_acgt, stdev, thr = _walk_inputs(L)
    win_std = np.linspace(1.0, 2.0, 10_001)
    monkeypatch.setattr(cnv_device, "SEED_INPUT_BLOCK", block)
    flags, gidx = cnv_device.seed_inputs(depth, mq, gc, low_acgt, thr, cfg,
                                         L, side)
    defc = np.where(mq >= cfg.min_mapq, np.int8(0),
                    np.where(depth > 0, np.int8(1), np.int8(-1)))
    idx = np.arange(L, dtype=np.int64)
    lowa = low_acgt == 0
    gcls_idx = np.maximum.accumulate(np.where(lowa & (defc >= 0), idx, -1))
    gcls_val = defc[np.maximum(gcls_idx, 0)]
    op = np.less_equal if side > 0 else np.greater_equal
    sok0, sok1 = op(depth, thr[0, gc]), op(depth, thr[1, gc])
    want = (cnv_device.pack_flags(lowa, sok0, sok1, gcls_idx, gcls_val)
            | np.where(defc >= 0, np.uint8(cnv_device.F_DEF), np.uint8(0))
            | np.where(defc == 1, np.uint8(cnv_device.F_CLS1), np.uint8(0)))
    assert flags.dtype == np.uint8 and np.array_equal(flags, want)
    assert gidx.dtype == np.int32 and np.array_equal(gidx, gcls_idx)
    assert (gcls_idx[:7000] == -1).all() and (flags & cnv_device.F_GDEF).any()
    si = cnv_device.device_seed_inputs(flags, stdev, win_std, side, "cpu")
    assert np.array_equal(si.flags.numpy(), want)
    assert np.array_equal(si.svals.numpy().view(np.uint64),
                          (side * stdev).view(np.uint64))
    assert np.array_equal(si.win_std.numpy(), win_std)


def test_walk_host_state_bytes_a_base():
    """The window walk's host state on a seeded 1 Mb case, each side (the
    second side's made after the first's is dropped): what ``seed_inputs``
    returns is at most 6 bytes a base; the candidates are int32; the
    side-signed z is made on the device, and the stage's z list is left
    as it was."""
    import numpy as np

    from grom_tpu_torch.config import GromConfig
    from grom_tpu_torch.ops import cnv_device
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    L = 1_000_000
    depth, mq, gc, low_acgt, stdev, thr = _walk_inputs(L, seed=9)
    z = stdev.copy()
    for side in (1, -1):
        state = cnv_device.seed_inputs(depth, mq, gc, low_acgt, thr, cfg, L,
                                       side)
        assert sum(a.nbytes for a in state) <= 6 * L
        cand = cnv_device.walk_candidates(state[0], 0, L)
        assert cand.dtype == np.int32 and 0 < len(cand) < L
        si = cnv_device.device_seed_inputs(state[0], stdev,
                                           np.ones(11), side, "cpu")
        assert si.svals.numpy()[123] == side * stdev[123]
        del state, cand, si
    assert np.array_equal(stdev, z)


@pytest.mark.parametrize("block", [1 << 12, 65_537, 1 << 22])
def test_z_upload_in_blocks(block, monkeypatch):
    """``state.z_inputs`` through its staging buffer, ``Z_UPLOAD_BLOCK``
    positions at a time, equals the one-shot upload it replaces
    (``pack_arrays`` of the whole range) bitwise, field by field and in
    the buffer's layout; 65,537 divides neither the range nor a power of
    two, and 2^22 is more than the range."""
    import numpy as np

    from grom_tpu_torch.ops import state
    from grom_tpu_torch.ops.accumulate import pack_arrays
    from grom_tpu_torch.ops.cnv_device import ZIN_DTYPES
    L = 300_001
    depth, mq, gc, low_acgt, _, _ = _walk_inputs(L, seed=10)
    lo, hi = 1_234, L - 77
    monkeypatch.setattr(state, "Z_UPLOAD_BLOCK", block)
    got = state.z_inputs(depth, mq, gc, low_acgt, lo, hi, "cpu")
    want = pack_arrays(dict(depth=depth[lo:hi], mq=mq[lo:hi], gc=gc[lo:hi],
                            low_acgt=low_acgt[lo:hi]), ZIN_DTYPES, "cpu")
    base = got.depth.untyped_storage().data_ptr()
    for name, dt in ZIN_DTYPES.items():
        g, w = getattr(got, name), want[name]
        assert g.dtype == w.dtype == dt and g.shape == (hi - lo,)
        assert g.numpy().tobytes() == w.numpy().tobytes()
        assert g.untyped_storage().data_ptr() == base
        assert (g.data_ptr() - base
                == w.data_ptr() - w.untyped_storage().data_ptr())


# --------------------------------------------------------------------------
# utils/peakmem.py
# --------------------------------------------------------------------------

STATUS = "Name:\tpython\nVmPeak:\t 900 kB\nVmHWM:\t  123456 kB\nVmRSS:\t 1 kB\n"
NO_HWM = "Name:\tpython\nVmPeak:\t 900 kB\nVmRSS:\t 1 kB\n"


def test_peakmem_reads_vmhwm():
    from grom_tpu_torch.utils import peakmem
    assert peakmem.vmhwm_kib(STATUS) == 123456
    assert peakmem.vmhwm_kib(NO_HWM) is None
    assert peakmem.start(status=STATUS) == "vmhwm"
    assert peakmem.host_peak(status=STATUS) == (123456, "vmhwm")


def test_peakmem_samples_without_vmhwm():
    from grom_tpu_torch.utils import peakmem
    try:
        assert peakmem.start(status=NO_HWM) == "sampled"
        kib, label = peakmem.host_peak(status=NO_HWM)
        assert label == "sampled" and kib >= peakmem.rss_kib() > 0
    finally:
        peakmem.stop()
    assert peakmem.host_peak(status=NO_HWM) == (None, None)


def test_peakmem_sampled_peak_of_a_freed_allocation():
    """A fresh process starts the sampler, allocates 256 MB, holds it for
    a few sampling periods and frees it: the sampled peak stays at least
    200 MB above the resident size before the allocation. (The port's
    malloc tuning, ``grom_tpu_torch._tune_malloc``, may keep the freed
    pages resident, so the resident size after the free is not held.)"""
    code = textwrap.dedent("""
        import json, sys, time
        import numpy as np
        sys.path.insert(0, %r)
        from grom_tpu_torch.utils import peakmem
        assert peakmem.start(status="") == "sampled"
        base = peakmem.rss_kib()
        a = np.ones(256 << 20, np.uint8)
        time.sleep(10 * peakmem.SAMPLE_S)
        del a
        time.sleep(5 * peakmem.SAMPLE_S)
        kib, label = peakmem.host_peak(status="")
        print(json.dumps([base, kib, label, peakmem.rss_kib()]))
    """ % REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    base, peak, label, after = json.loads(r.stdout.splitlines()[-1])
    assert label == "sampled"
    assert peak - base >= 200 << 10, (base, peak)
    assert peak >= after


def test_peakmem_card_is_none_on_the_cpu():
    from grom_tpu_torch.utils import peakmem
    assert peakmem.card_peak(["cpu", torch.device("cpu")]) is None
    rep = peakmem.report(["cpu"])
    assert rep["card"] is None and set(rep) == {"rss_peak_kib",
                                                "rss_source", "card"}


def _stats(stderr):
    """The JSON lines a run printed on stderr, by their first word."""
    out = {}
    for ln in stderr.splitlines():
        key, _, rest = ln.partition(" ")
        if rest.startswith("{"):
            out.setdefault(key, []).append(json.loads(rest))
    return out


def test_driver_prints_peak_memory_and_launches(tmp_path):
    d = os.path.join(DATA, "ds200k")
    r = _cli(["-m", "grom_tpu_torch", "-i", os.path.join(d, "ds.bam"),
              "-r", os.path.join(d, "ds.fa"), "-o", str(tmp_path / "o.vcf")],
             {"GROM_TPU_TORCH_ENGINE": "host", "GROM_TPU_TIMING": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    st = _stats(r.stderr)
    (mem,), (launches,) = st["peak_memory"], st["launches"]
    assert mem["rss_source"] in ("vmhwm", "sampled")
    assert mem["rss_peak_kib"] > 0 and mem["card"] is None
    assert set(launches) >= {"tile_accumulate", "zscores", "rd_scatter"}
    assert not any(launches.values())
    # without GROM_TPU_TIMING nothing of it is printed
    r = _cli(["-m", "grom_tpu_torch", "-i", os.path.join(d, "ds.bam"),
              "-r", os.path.join(d, "ds.fa"), "-o", str(tmp_path / "p.vcf")],
             {"GROM_TPU_TORCH_ENGINE": "host"})
    assert r.returncode == 0 and "peak_memory" not in r.stderr


def _livemax_mib(stderr):
    """The ``livemax`` column (MiB) of the timing table, by phase."""
    out, on = {}, False
    for ln in stderr.splitlines():
        if ln.startswith("== grom_tpu timing =="):
            on = True
            continue
        t = ln.split()
        if on and len(t) == 7 and t[1].endswith("s") and t[5].endswith("M"):
            out[t[0]] = int(t[5][:-1])
    return out


def test_livemax_reads_peak_rss_per_phase(tmp_path):
    """A GROM_TPU_TIMING=1 run of the torch engine (plain kernels) on
    ds200k in a fresh process: every phase's ``livemax`` is the peak RSS at
    its end, non-zero and at most the run's peak; the largest equals the
    ``peak_memory`` line's host peak up to what the process grew after its
    last phase ended; the line's ``phase_rss_kib`` is the same reading in
    KiB."""
    d = os.path.join(DATA, "ds200k")
    code = textwrap.dedent("""
        import sys
        sys.path.insert(0, %r)
        import torch
        torch.set_num_threads(1)
        from grom_tpu_torch.cli import parse_args
        from grom_tpu_torch.driver import run
        run(parse_args(sys.argv[1:]), engine="torch", device="cpu")
    """ % REPO)
    r = _cli(["-c", code, "-i", os.path.join(d, "ds.bam"), "-r",
              os.path.join(d, "ds.fa"), "-o", str(tmp_path / "o.vcf")],
             {"GROM_TPU_TIMING": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    (mem,) = _stats(r.stderr)["peak_memory"]
    livemax = _livemax_mib(r.stderr)
    phases = mem["phase_rss_kib"]
    assert set(livemax) == set(phases) >= {"scan.device", "call.cnv",
                                           "cnv.winscan_dev"}
    peak = mem["rss_peak_kib"]
    # the kernel sums its RSS counters per CPU, so two readings of VmHWM
    # may be out of order by up to a batch of pages per CPU
    slack = 32 << 10
    assert min(livemax.values()) > 0
    for k, v in phases.items():
        assert 0 < v <= peak + slack and livemax[k] == v >> 10
    # after the last phase end only the table and these lines are printed
    assert abs(peak - max(phases.values())) <= slack, (peak, phases)


def test_parallel_reports_peak_memory(tmp_path):
    d = os.path.join(DATA, "ctx2x60k")
    r = _cli(["-m", "grom_tpu_torch", "-i", os.path.join(d, "ds.bam"),
              "-r", os.path.join(d, "ds.fa"), "-P", "2", "-o",
              str(tmp_path / "o.vcf")],
             {"GROM_TPU_TORCH_ENGINE": "host", "GROM_TPU_TIMING": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    st = _stats(r.stderr)
    jobs = st["parallel_job"]
    assert sorted(j["job"][0] for j in jobs) == [0, 1]
    for j in jobs:
        assert j["rss_source"] in ("vmhwm", "sampled")
        assert j["max_rss_kib"] > 0 and j["pid"] != os.getpid()
        assert j["max_memory_allocated"] is None
        assert j["max_memory_reserved"] is None
        assert j["memory_share"] is None
        assert j["phases"]["call.cnv"] > 0
        assert set(j["phase_rss_kib"]) == set(j["phases"])
        assert 0 < j["phase_rss_kib"]["call.cnv"] <= j["max_rss_kib"] + (
            32 << 10)
    assert st["peak_memory"][0]["rss_peak_kib"] > 0
    assert st["launches"][0]["tile_accumulate"] == 0


# --------------------------------------------------------------------------
# the 250 Mb chromosome on the card
# --------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.cuda
@pytest.mark.skipif(os.environ.get("GROM_TPU_RUN_WGS") != "1",
                    reason="~45 min + ~7 GB disk; set GROM_TPU_RUN_WGS=1")
def test_torch_250mb_matches_host():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import torch_scale
    fa, bam = torch_scale.dataset(torch_scale.DATASET["length"])
    ref = torch_scale.run_one("host", fa, bam)
    assert ref["rc"] == 0, ref.get("stderr_tail")
    for name in ("torch", "mesh", "torch_4m1m", "torch_P8"):
        rec = torch_scale.run_one(name, fa, bam)
        assert rec["rc"] == 0, rec.get("stderr_tail")
        assert torch_scale.check_run(rec, ref) == []
        assert rec["rows"] == ref["rows"]
        assert 0 < rec["rss_peak_kib"] <= ref["rss_peak_kib"]
