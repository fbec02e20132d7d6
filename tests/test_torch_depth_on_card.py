"""The device engines keep a chromosome's depth lists on their device
through the scan stage (``ops/state.py DepthLists``), and hand them to the
stages after it as the host arrays the host engine builds.

* ``DepthLists.add_window`` chunk by chunk, then ``to_host``, equals
  ``driver._accumulate_rd_window`` into numpy lists bit for bit, at chunk
  sizes that divide L, divide nothing, or hold the whole chromosome, with
  download blocks smaller than L, equal to it and dividing nothing; one
  window against the f64 ``bincount`` form on seeded spans that end on
  the window's edges.
* ``MeshAccumulator.run(..., rd_out=DepthLists)`` equals ``rd_out=(three
  numpy arrays)`` on a 1x1 and a 2x2 grid, range by range as the streamed
  driver calls it.
* Streamed torch and mesh runs (plain kernels on the CPU) on cnvrich and
  cnvmany at 1 Mi ingest chunks and 256 Ki detect sub-chunks, under the
  default policy and GROM_TPU_DEVICE_CNV=0, write files byte-identical to
  the host engine's, and say where their lists lived.
* A device engine's scan holds no numpy block of 4·L bytes or more (one
  int32 list of the chromosome) at any drained sub-chunk or when it ends
  (tracemalloc, numpy's domain); the host engine's does.
* ``tools/rss_baseline.py``'s smaps parsing on a fixed sample, and the
  tools this memory work added import no module of jax or grom_tpu.
"""

import ast
import json
import os
import sys
import tracemalloc

import numpy as np
import pytest
import torch

from grom_tpu_torch.config import GromConfig
from grom_tpu_torch.ops import state
from grom_tpu_torch.ops.state import DepthLists
from grom_tpu_torch.parallel.mesh import make_mesh
from grom_tpu_torch.parallel.pipeline import MeshAccumulator
from test_torch_slice import DATA, REPO

torch.set_num_threads(1)

NUMPY_DOMAIN = 389047
DATE = "2026725"
# (ingest chunk, detect sub-chunk) of the streamed runs
GEOMETRY = (1 << 20, 1 << 18)


def _batch(fx="cnvrich"):
    """(batch, eligible, L, cfg) of a fixture's first chromosome, as the
    streamed driver builds them."""
    from grom_tpu_torch.ingest import bam as bam_mod
    from grom_tpu_torch.ingest.batches import build_batch
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    header, reads = bam_mod.read_bam(os.path.join(DATA, fx, "ds.bam"))
    batch = build_batch(reads, 0, cfg.min_mapq, cfg.add_factor, cfg.rmdup)
    eligible = batch.keep & (batch.pos >= 700)
    return batch, eligible, int(header.ref_lengths[0]), cfg


@pytest.fixture(scope="module")
def cnvrich_batch():
    return _batch()


@pytest.mark.parametrize("block", ["smaller", "equal", "indivisible"])
@pytest.mark.parametrize("chunk", ["divides", "indivisible", "one"])
def test_depth_lists_match_rd_window(cnvrich_batch, chunk, block,
                                     monkeypatch):
    from grom_tpu_torch.driver import (_accumulate_rd_window,
                                       _rd_window_spans)
    batch, eligible, L, cfg = cnvrich_batch
    C = {"divides": L // 5, "indivisible": 300_007, "one": L}[chunk]
    B = {"smaller": L // 4, "equal": L, "indivisible": 99_991}[block]
    assert (L % C == 0) == (chunk != "indivisible")
    assert (L % B == 0) == (block != "indivisible") and B <= L
    monkeypatch.setattr(state, "RD_DOWNLOAD_BLOCK", B)
    want = [np.zeros(L, np.int32) for _ in range(3)]
    lists = DepthLists(L, "cpu")
    crossing = 0
    for t0 in range(0, L, C):
        t1 = min(t0 + C, L)
        _accumulate_rd_window(*want, L, batch, eligible, cfg, t0, t1)
        lists.add_window(t0, t1, *_rd_window_spans(L, batch, eligible, t0,
                                                   t1), cfg.min_mapq)
        if t1 < L:
            end = batch.span_ref + batch.span_len
            crossing += int(((batch.span_ref < t1) & (end > t1)).sum())
    got = lists.to_host()
    for g, w in zip(got, want):
        assert g.dtype == np.int32 and g.shape == (L,)
        assert np.array_equal(g, w)
    assert want[1].max() > 0 and want[2].max() > 0
    assert chunk == "one" or crossing > 0


@pytest.mark.parametrize("case", ["mixed", "low_mapq", "edges", "empty"])
def test_depth_window_matches_bincount(case):
    """One window of seeded spans: ``add_window`` (int64 endpoint counts
    on the device) against the f64 ``bincount`` form of
    ``_accumulate_rd_window``, into lists that already hold counts."""
    rng = np.random.default_rng(["mixed", "low_mapq", "edges",
                                 "empty"].index(case))
    L, lo, hi, min_mapq = 50_000, 10_000, 43_217, 20
    n = hi - lo
    m = 0 if case == "empty" else 5_000
    starts = rng.integers(0, n, m)
    ends = np.minimum(starts + rng.integers(1, 400, m), n)
    if case == "edges":
        starts[:50], ends[50:100] = 0, n
    mapq = rng.integers(0, 61, m).astype(np.int32)
    if case == "low_mapq":
        mapq %= min_mapq
    base = [rng.integers(0, 1000, L).astype(np.int32) for _ in range(3)]
    want = [b.copy() for b in base]
    for out, w in zip(want, (mapq.astype(np.float64), mapq >= min_mapq,
                             mapq < min_mapq)):
        d = np.bincount(starts, w.astype(np.float64), minlength=n + 1)
        d -= np.bincount(ends, w.astype(np.float64), minlength=n + 1)
        np.cumsum(d, out=d)
        np.add(out[lo:hi], d[:n], out=out[lo:hi], casting="unsafe")
    lists = DepthLists(L, "cpu")
    lists.rows.copy_(torch.from_numpy(np.stack(base)))
    lists.add_window(lo, hi, starts, ends, mapq, min_mapq)
    for g, w in zip(lists.to_host(), want):
        assert np.array_equal(g, w)
    assert lists.nbytes == 12 * L


@pytest.fixture(scope="module")
def ds200k():
    from grom_tpu_torch.testing.fixtures import chrom_inputs
    return chrom_inputs(os.path.join(DATA, "ds200k"))


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_mesh_rd_out_depth_lists(ds200k, shape):
    """The mesh engine's depth, range by range with chunk-local gate and
    base_tot arrays as the streamed driver calls it, copied into card
    lists equals the copy into host arrays; the lists come back in the
    place of the arrays."""
    ci = ds200k
    L = len(ci.chrom)
    acc = MeshAccumulator(mesh=make_mesh(*shape, devices=["cpu"] * (
        shape[0] * shape[1])), seg_l=1 << 14)
    arrays = tuple(np.zeros(L, np.int32) for _ in range(3))
    lists = DepthLists(L, "cpu")
    for lo in range(0, L, 70_001):
        hi = min(lo + 70_001, L)
        res = []
        for rd in (arrays, lists):
            bt = np.zeros(hi - lo, np.int64)
            res.append(acc.run(ci.chrom, ci.batch, ci.eligible, ci.cfg,
                               ci.gate[lo:hi], lo=lo, hi=hi,
                               base_tot_out=bt, rd_out=rd, gate_base=lo,
                               base_tot_base=lo))
            got = res[-1][2]
            assert got is rd if rd is lists else all(
                a is b for a, b in zip(got, rd))
        assert np.array_equal(res[0][0], res[1][0])
        assert np.array_equal(res[0][3], res[1][3])
        assert res[0][1]["n"] == res[1][1]["n"]
    for g, w in zip(lists.to_host(), arrays):
        assert np.array_equal(g, w)
    assert arrays[1].max() > 0


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(fasta, bam) of cnvrich and of cnvmany (generated)."""
    from grom_tpu_torch.testing import cnvmany
    d = os.path.join(DATA, "cnvrich")
    many = cnvmany.build(str(tmp_path_factory.mktemp("cnvmany") / "ds"))
    return {"cnvrich": (os.path.join(d, "ds.fa"), os.path.join(d, "ds.bam")),
            "cnvmany": many}


def _run(datasets, fixture, out, engine, mp, policy):
    """The driver on a CNV fixture at ``GEOMETRY`` (-V 0.0001, as the
    fixtures' oracles) under ``policy`` (GROM_TPU_DEVICE_CNV's value, or
    None for unset)."""
    from grom_tpu_torch.driver import run
    mp.setenv("GROM_TPU_CHUNK_BASES", str(GEOMETRY[0]))
    mp.setenv("GROM_TPU_DETECT_BASES", str(GEOMETRY[1]))
    mp.delenv("GROM_TPU_DEVICE_SV", raising=False)
    if policy is None:
        mp.delenv("GROM_TPU_DEVICE_CNV", raising=False)
    else:
        mp.setenv("GROM_TPU_DEVICE_CNV", policy)
    fa, bam = datasets[fixture]
    run(GromConfig(bam=bam, ref_fasta=fa, out_vcf=out,
                   rd_pval_threshold=1e-4),
        file_date=DATE, engine=engine, device="cpu")
    return out


@pytest.fixture(scope="module")
def host_files(datasets, tmp_path_factory):
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for fx in datasets:
            path = str(tmp_path_factory.mktemp("host") / "host.vcf")
            out[fx] = _run(datasets, fx, path, "host", mp, None)
    return out


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("policy", [None, "0"])
@pytest.mark.parametrize("engine", ["torch", "mesh"])
@pytest.mark.parametrize("fixture", ["cnvrich", "cnvmany"])
def test_streamed_lists_on_device_match_host(datasets, host_files, fixture,
                                             engine, policy, tmp_path,
                                             monkeypatch):
    from grom_tpu_torch import driver
    before = len(driver.DEPTH_LISTS)
    out = _run(datasets, fixture, str(tmp_path / "o.vcf"), engine,
               monkeypatch, policy)
    for suffix in (".vcf", ".ctx.vcf"):
        assert _read(out[:-4] + suffix) == \
            _read(host_files[fixture][:-4] + suffix), suffix
    with open(out) as f:
        assert any("SD:Z:CN" in ln for ln in f), "no CNV row"
    recs = driver.DEPTH_LISTS[before:]
    assert [r["where"] for r in recs] == ["cpu"]
    L = recs[0]["card_bytes"] // 12
    assert L > 1_000_000
    rep = driver.depth_lists_report()
    assert "cpu" in rep["scan"] and rep["card_bytes"] >= 12 * L


@pytest.mark.parametrize("engine", ["torch", "mesh", "host"])
def test_peak_memory_line_reports_depth_lists(engine, tmp_path, monkeypatch,
                                              capfd):
    """Under GROM_TPU_TIMING=1 the ``peak_memory`` line says where the
    depth lists lived through the scan and the device bytes they took;
    ``pinned`` is null off the card."""
    from grom_tpu_torch import driver
    from grom_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "_enabled", True)
    monkeypatch.setattr(driver, "DEPTH_LISTS", [])
    d = os.path.join(DATA, "ds200k")
    driver.run(GromConfig(bam=os.path.join(d, "ds.bam"),
                          ref_fasta=os.path.join(d, "ds.fa"),
                          out_vcf=str(tmp_path / "o.vcf")),
               file_date=DATE, engine=engine, device="cpu")
    lines = [json.loads(ln.split(" ", 1)[1])
             for ln in capfd.readouterr().err.splitlines()
             if ln.startswith("peak_memory {")]
    assert len(lines) == 1
    mem = lines[0]
    assert mem["pinned"] is None and mem["card"] is None
    # no CUDA context: no phase ended with a card reading
    assert mem["phase_card_bytes"] == {}
    L = 200_000
    if engine == "host":
        assert mem["depth_lists"] == {"scan": ["host"], "card_bytes": 0,
                                      "card_peak_scan": None}
    else:
        assert mem["depth_lists"] == {"scan": ["cpu"], "card_bytes": 12 * L,
                                      "card_peak_scan": None}


@pytest.fixture(scope="module")
def thin_chromosome(tmp_path_factory):
    """(fasta, bam) of a 3 Mb chromosome at 3x: its ingest chunks' reads
    and buffers stay well under one 12 MB depth list. One host-engine run
    writes the FASTA-index and insert-size caches beside it, so the
    traced runs decode no insert-size sample (an 18 MB buffer the ingest
    keeps in its pool)."""
    from grom_tpu_torch.driver import run
    from grom_tpu_torch.testing.bulk_sim import bulk_dataset
    fa, bam = bulk_dataset(str(tmp_path_factory.mktemp("thin") / "ds"),
                           3_000_000, coverage=3.0, seed=5)
    run(GromConfig(bam=bam, ref_fasta=fa, out_vcf=bam[:-4] + ".warm.vcf"),
        file_date=DATE, engine="host")
    return fa, bam


@pytest.mark.parametrize("engine", ["torch", "mesh", "host"])
def test_scan_holds_no_host_depth_list(thin_chromosome, engine,
                                       monkeypatch):
    """tracemalloc's record of numpy's data blocks at every drained detect
    sub-chunk and as the scan ends (``_finish_chromosome`` entered): on a
    device engine no block of 4·L bytes or more is alive, so no
    whole-chromosome int32 list is on the host during the scan; on the
    host engine the three lists are."""
    from grom_tpu_torch import driver
    fa, bam = thin_chromosome
    L = 3_000_000
    big = []

    def look(where):
        snap = tracemalloc.take_snapshot().filter_traces(
            [tracemalloc.DomainFilter(True, NUMPY_DOMAIN)])
        big.extend((where, t.size, str(t.traceback[0]))
                   for t in snap.traces if t.size >= 4 * L)

    process = driver._ChunkDetect.process
    monkeypatch.setattr(driver._ChunkDetect, "process",
                        lambda self, *a: look("drain") or process(self, *a))
    monkeypatch.setattr(DepthLists, "to_host", lambda self, _f=(
        DepthLists.to_host): look("scan end") or _f(self))
    finish = driver._finish_chromosome
    monkeypatch.setattr(driver, "_finish_chromosome", lambda *a, **k: (
        look("finish") if engine == "host" else None) or finish(*a, **k))
    monkeypatch.setenv("GROM_TPU_CHUNK_BASES", str(1 << 19))
    monkeypatch.setenv("GROM_TPU_DETECT_BASES", str(1 << 17))
    monkeypatch.setenv("GROM_TPU_DEVICE_CNV", "0")
    tracemalloc.start(1)
    try:
        driver.run(GromConfig(bam=bam, ref_fasta=fa,
                              out_vcf=str(os.path.dirname(bam)) + "/%s.vcf"
                              % engine), file_date=DATE, engine=engine,
                   device="cpu")
    finally:
        tracemalloc.stop()
    if engine == "host":
        lists = [b for b in big if b[0] == "finish" and b[1] == 4 * L]
        assert len(lists) >= 3, big
    else:
        assert not big, big


SMAPS = """\
00400000-00452000 r-xp 00000000 08:02 173521      /usr/lib/libtorch_cuda.so
Size:                328 kB
Rss:                 300 kB
Private_Dirty:         0 kB
00652000-00653000 rw-p 00052000 08:02 173521      /usr/lib/libtorch_cuda.so
Size:                  4 kB
Rss:                   4 kB
Private_Dirty:         4 kB
00e03000-00e24000 rw-p 00000000 00:00 0           [heap]
Size:                132 kB
Rss:                 120 kB
Private_Dirty:       120 kB
7f0000000000-7f0000100000 rw-p 00000000 00:00 0
Size:               1024 kB
Rss:                1000 kB
Private_Dirty:      1000 kB
7f1000000000-7f1000010000 r--p 00000000 08:02 99 /usr/lib/libcublas.so.12
Size:                 64 kB
Rss:                  64 kB
Private_Dirty:         0 kB
VmFlags: rd mr mw me sd
7f2000000000-7f2000001000 rw-s 00000000 00:05 12345  /dev/shm/pool (deleted)
Size:                  4 kB
Rss:                   4 kB
Private_Dirty:         0 kB
"""


def test_rss_baseline_smaps_by_file():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import rss_baseline
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    by = rss_baseline.smaps_by_file(SMAPS)
    assert by["anon_kib"] == 1120
    assert by["file"] == {"/usr/lib/libtorch_cuda.so": [304, 4],
                          "/usr/lib/libcublas.so.12": [64, 0],
                          "/dev/shm/pool (deleted)": [4, 0]}
    assert rss_baseline.top_files(by["file"], 2) == [
        ["/usr/lib/libtorch_cuda.so", 304, 4],
        ["/usr/lib/libcublas.so.12", 64, 0]]
    grown = rss_baseline.grown_files(
        {"_files": {"/usr/lib/libcublas.so.12": [60, 0]}}, {"_files": by[
            "file"]})
    assert grown == [["/usr/lib/libtorch_cuda.so", 304],
                     ["/dev/shm/pool (deleted)", 4],
                     ["/usr/lib/libcublas.so.12", 4]]


@pytest.mark.parametrize("path", ["tools/peak_probe.py",
                                  "tools/rss_baseline.py",
                                  "tools/torch_scale.py"])
def test_memory_tools_import_no_jax(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "grom_tpu")]


@pytest.mark.cuda
def test_depth_lists_on_card(cnvrich_batch, monkeypatch):
    """On the card: the chunk windows and the download through the pinned
    staging buffer equal the CPU lists, and the staging buffer is the
    only pinned block the download takes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grom_tpu_torch.driver import _rd_window_spans
    batch, eligible, L, cfg = cnvrich_batch
    monkeypatch.setattr(state, "RD_DOWNLOAD_BLOCK", 99_991)
    out = []
    for dev in ("cpu", "cuda"):
        lists = DepthLists(L, dev)
        for t0 in range(0, L, 300_007):
            t1 = min(t0 + 300_007, L)
            lists.add_window(t0, t1, *_rd_window_spans(L, batch, eligible,
                                                       t0, t1), cfg.min_mapq)
        before = torch.cuda.host_memory_stats().get("allocated_bytes.current",
                                                     0)
        out.append(lists.to_host())
        grown = torch.cuda.host_memory_stats().get("allocated_bytes.current",
                                                   0) - before
        assert grown <= 2 * 12 * 99_991
    for g, w in zip(*out):
        assert np.array_equal(g, w)
