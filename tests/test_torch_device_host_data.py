"""The host data of the device engines' streamed scan: a detect
sub-chunk's device job is prepared when the sub-chunk is fed (its inputs
on the device, from one span index of its ingest chunk) and launched under
the sub-chunk's gate when it drains, so a queued job holds no host read
and an ingest chunk's reads are freed once its last sub-chunk is fed.

* Streamed torch and mesh runs (plain kernels on the CPU) on cnvrich and
  cnvmany, under the default policy and GROM_TPU_DEVICE_CNV=0, at a
  geometry whose sub-chunk divides neither the chunk nor the chromosome
  (reads cross every chunk edge), and cnvrich also at 1 Mi ingest chunks
  and 256 Ki detect sub-chunks, write files byte-identical to the host
  engine's, each sub-chunk through one prepared job (cnvmany at 1 Mi /
  256 Ki: ``test_torch_depth_on_card.py``'s streamed runs).
* On a 3 Mb chromosome at 3x, under tracemalloc: no array of an ingest
  chunk's decoded reads (weak references to each array ``fetch``
  returned; tracemalloc's record of numpy's domain says what else is
  alive) outlives its chunk into the next one's scan, on any engine.
* A queued job (``TorchJob``, ``MeshJob``) holds tensors on its device
  and no numpy array; the ``peak_memory`` line reports the device bytes
  the queued jobs held at most (``queued_jobs``), 0 on the host engine.
* The tile kernel's wrapper with the gate passed apart (``tile_gate``)
  equals the packing that held the gate among the tile's arrays, bit for
  bit, on seeded tiles.
* On the card, the mesh engine's span upload (``state.span_inputs``: in
  blocks through two pinned staging buffers on a copy stream) equals the
  CPU's packing bit for bit with blocks cut small.
"""

import json
import os
import tracemalloc
import weakref

import numpy as np
import pytest
import torch

from grom_tpu_torch.config import GromConfig
from grom_tpu_torch.ops import accumulate as tacc
from test_torch_slice import DATA

torch.set_num_threads(1)

NUMPY_DOMAIN = 389047
DATE = "2026725"
# (ingest chunk, detect sub-chunk): the depth tests' geometry, and one
# whose sub-chunk divides neither the chunk nor the chromosome
GEOMETRIES = {"1m256k": (1 << 20, 1 << 18), "odd": (700_001, 199_999)}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(fasta, bam) of cnvrich and of cnvmany (generated)."""
    from grom_tpu_torch.testing import cnvmany
    d = os.path.join(DATA, "cnvrich")
    many = cnvmany.build(str(tmp_path_factory.mktemp("cnvmany") / "ds"))
    return {"cnvrich": (os.path.join(d, "ds.fa"), os.path.join(d, "ds.bam")),
            "cnvmany": many}


def _run(datasets, fixture, out, engine, mp, policy, geometry):
    """The driver on a CNV fixture (-V 0.0001, as the fixtures' oracles)
    at ``geometry`` under ``policy`` (GROM_TPU_DEVICE_CNV's value, or None
    for unset)."""
    from grom_tpu_torch.driver import run
    C, D = GEOMETRIES[geometry]
    mp.setenv("GROM_TPU_CHUNK_BASES", str(C))
    mp.setenv("GROM_TPU_DETECT_BASES", str(D))
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


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# (fixture, geometry) of the byte-identity runs
CASES = [("cnvrich", "1m256k"), ("cnvrich", "odd"), ("cnvmany", "odd")]


@pytest.fixture(scope="module")
def host_files(datasets, tmp_path_factory):
    """The host engine's files of each case."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for fx, geo in CASES:
            path = str(tmp_path_factory.mktemp("host") / "host.vcf")
            out[fx, geo] = _run(datasets, fx, path, "host", mp, None, geo)
    return out


@pytest.mark.parametrize("policy", [None, "0"])
@pytest.mark.parametrize("engine", ["torch", "mesh"])
@pytest.mark.parametrize("fixture,geometry", CASES)
def test_prepared_jobs_match_host(datasets, host_files, fixture, engine,
                                  policy, geometry, tmp_path, monkeypatch):
    from grom_tpu_torch import driver
    from grom_tpu_torch.ops.accumulate import TorchAccumulator
    from grom_tpu_torch.parallel.pipeline import MeshAccumulator
    L = {"cnvrich": 1_200_000, "cnvmany": 3_000_000}[fixture]
    C, D = GEOMETRIES[geometry]
    if geometry == "odd":
        assert C % D and L % C and L % D
    launched = []
    owner = TorchAccumulator if engine == "torch" else MeshAccumulator
    launch = owner.launch
    monkeypatch.setattr(owner, "launch", lambda self, job, *a, **k: (
        launched.append((job.lo, job.hi)) or launch(self, job, *a, **k)))
    out = _run(datasets, fixture, str(tmp_path / "o.vcf"), engine,
               monkeypatch, policy, geometry)
    host = host_files[fixture, geometry]
    for suffix in (".vcf", ".ctx.vcf"):
        assert _read(out[:-4] + suffix) == _read(host[:-4] + suffix), suffix
    with open(out) as f:
        assert any("SD:Z:CN" in ln for ln in f), "no CNV row"
    # every sub-chunk of every chunk went through one prepared job
    want = [(d0, min(d0 + D, t0 + C, L)) for t0 in range(0, L, C)
            for d0 in range(t0, min(t0 + C, L), D)]
    assert launched == want


@pytest.fixture(scope="module")
def thin_chromosome(tmp_path_factory):
    """(fasta, bam) of a 3 Mb chromosome at 3x, with its FASTA-index and
    insert-size caches written by one host-engine run."""
    from grom_tpu_torch.driver import run
    from grom_tpu_torch.testing.bulk_sim import bulk_dataset
    fa, bam = bulk_dataset(str(tmp_path_factory.mktemp("thin") / "ds"),
                           3_000_000, coverage=3.0, seed=5)
    run(GromConfig(bam=bam, ref_fasta=fa, out_vcf=bam[:-4] + ".warm.vcf"),
        file_date=DATE, engine="host")
    return fa, bam


def _arrays(reads):
    """The numpy arrays of a ``RawReads`` (its name buffer too)."""
    out = [v for v in vars(reads).values() if isinstance(v, np.ndarray)]
    buf = getattr(reads.names, "buf", None)
    if isinstance(buf, np.ndarray):
        out.append(buf)
    return out


@pytest.mark.parametrize("engine", ["torch", "mesh", "host"])
def test_chunk_reads_die_with_their_chunk(thin_chromosome, engine,
                                          monkeypatch):
    """Each ingest chunk's decoded reads (weak references to every array
    ``fetch`` returned) are freed before any sub-chunk is drained while
    the next chunk is being scanned (``build_batch`` of the next chunk
    has run): a queued device job holds its inputs on the device, not a
    view of its chunk's reads. At each such drain tracemalloc's record of
    numpy's domain is taken, and an array still alive is reported with
    the numpy blocks alive then."""
    from grom_tpu_torch import driver
    fa, bam = thin_chromosome
    chunks = []          # per fetched chunk: its range and weak refs
    taken = []           # the chunks build_batch has started, in order
    alive = []

    streamed = driver.call_chromosome_streamed

    def probed_streamed(chrom, refid, out_name, cfg, drv, mq, hez, fetch,
                        *a, **kw):
        def probed_fetch(t0, t1):
            reads = fetch(t0, t1)
            chunks.append(((t0, t1), [weakref.ref(x)
                                      for x in _arrays(reads)],
                           id(reads)))
            return reads
        return streamed(chrom, refid, out_name, cfg, drv, mq, hez,
                        probed_fetch, *a, **kw)

    build = driver.build_batch

    def probed_build(reads, *a, **kw):
        taken.append(id(reads))
        return build(reads, *a, **kw)

    add = driver._ChunkDetect.add_window

    def probed_add(det, d0, d1, *a, **kw):
        # the chunks before the one build_batch last started (the latest
        # with its id: a later chunk may reuse a freed chunk's id)
        now = max(i for i, c in enumerate(chunks) if c[2] == taken[-1])
        live = [(rng, sum(r().nbytes for r in refs if r() is not None))
                for rng, refs, _ in chunks[:now]
                if any(r() is not None for r in refs)]
        if live:
            snap = tracemalloc.take_snapshot().filter_traces(
                [tracemalloc.DomainFilter(True, NUMPY_DOMAIN)])
            alive.append(((d0, d1), live, [
                str(s) for s in snap.statistics("lineno")[:5]]))
        return add(det, d0, d1, *a, **kw)

    monkeypatch.setattr(driver, "call_chromosome_streamed", probed_streamed)
    monkeypatch.setattr(driver, "build_batch", probed_build)
    monkeypatch.setattr(driver._ChunkDetect, "add_window", probed_add)
    monkeypatch.setenv("GROM_TPU_CHUNK_BASES", str(1 << 19))
    monkeypatch.setenv("GROM_TPU_DETECT_BASES", str(1 << 17))
    monkeypatch.setenv("GROM_TPU_DEVICE_CNV", "0")
    tracemalloc.start(1)
    try:
        driver.run(GromConfig(bam=bam, ref_fasta=fa,
                              out_vcf=os.path.join(os.path.dirname(bam),
                                                   "%s.vcf" % engine)),
                   file_date=DATE, engine=engine, device="cpu")
    finally:
        tracemalloc.stop()
    assert len(chunks) == -(-3_000_000 // (1 << 19)) == len(taken)
    assert not alive, alive


def _walk(x):
    """Every leaf object reachable through the tuples, lists and dicts of
    ``x``."""
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _walk(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _walk(v)
    else:
        yield x


@pytest.mark.parametrize("engine", ["torch", "mesh"])
def test_queued_job_holds_device_tensors_only(engine):
    """A prepared job of ds200k holds its inputs as tensors on the
    accumulator's device and no numpy array; its ``nbytes`` is the bytes of
    its tile buffers."""
    from grom_tpu_torch import driver
    from grom_tpu_torch.testing.fixtures import chrom_inputs
    ci = chrom_inputs(os.path.join(DATA, "ds200k"))
    acc = driver._accumulator(engine, "cpu")[0]
    L = len(ci.chrom)
    chunk = acc.chunk(ci.batch, ci.eligible, 0, L)
    job = acc.prepare(ci.chrom, chunk, ci.cfg, 50_000, 150_000)
    del chunk
    leaves = list(_walk(tuple(job)))
    assert not [x for x in leaves if isinstance(x, np.ndarray)]
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    assert tensors and all(t.device.type == "cpu" for t in tensors)
    tiles = ([t for _, _, t in job.tiles] if engine == "torch" else
             [t for launch in job.tiles for t in launch if t is not None])
    assert tiles
    # the tiles' buffers: their fields, each padded to 16 bytes
    fields = sum(getattr(t, k).numel() * getattr(t, k).element_size()
                 for t in tiles for k in tacc._DTYPES)
    assert fields <= job.nbytes <= fields + 16 * len(tacc._DTYPES) * len(
        tiles)


@pytest.mark.parametrize("engine", ["torch", "mesh", "host"])
def test_peak_memory_reports_queued_jobs(engine, tmp_path, monkeypatch,
                                         capfd):
    """Under GROM_TPU_TIMING=1 the ``peak_memory`` line gives the device
    bytes the queued jobs' inputs held at most; 0 on the host engine."""
    from grom_tpu_torch import driver
    from grom_tpu_torch.utils import timing
    monkeypatch.setattr(timing, "_enabled", True)
    monkeypatch.setattr(driver, "DEPTH_LISTS", [])
    d = os.path.join(DATA, "ds200k")
    monkeypatch.setenv("GROM_TPU_CHUNK_BASES", str(1 << 16))
    monkeypatch.setenv("GROM_TPU_DETECT_BASES", str(1 << 14))
    driver.run(GromConfig(bam=os.path.join(d, "ds.bam"),
                          ref_fasta=os.path.join(d, "ds.fa"),
                          out_vcf=str(tmp_path / "o.vcf")),
               file_date=DATE, engine=engine, device="cpu")
    lines = [json.loads(ln.split(" ", 1)[1])
             for ln in capfd.readouterr().err.splitlines()
             if ln.startswith("peak_memory {")]
    assert len(lines) == 1
    queued = lines[0]["queued_jobs"]
    assert set(queued) == {"peak_bytes"}
    if engine == "host":
        assert queued["peak_bytes"] == 0
    else:
        # at most two jobs queued: one sub-chunk's tiles is well under 1 MB
        # a thousand bases at ds200k's depth
        assert 0 < queued["peak_bytes"] < 2 * 1000 * (1 << 14)


def _old_packing(arrays, device):
    """The tile packing that held the gate among the tile's arrays: one
    buffer, the gate last, as ``TileInputs`` once carried it; returns
    (the tile's fields, the gate) as views of it."""
    views = tacc.pack_arrays(arrays, dict(tacc._DTYPES, gate=torch.uint8),
                             device)
    gate = views.pop("gate")
    return views, gate


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_gate_apart_equals_gate_packed(seed):
    """Seeded tiles (``testing/tiles.py spike_tile``, with and without
    mismatches): the fields ``pack_tile`` uploads equal those of the
    packing with the gate inside, byte for byte; ``tile_gate`` equals its
    gate; and the plain tile kernel under the gate passed apart returns
    the packed result of the gate read from that one buffer, bit for
    bit."""
    from grom_tpu_torch.testing.tiles import PARAMS, spike_tile
    arrays, _ = spike_tile(seed, seed % 2 == 0)
    rng = np.random.default_rng(seed)
    arrays["gate"] = (rng.random(len(arrays["chrom_up"])) < 0.7).astype(
        np.uint8)
    p = dict(thr=tacc.screen_threshold(PARAMS["min_ratio"]),
             min_mapq=PARAMS["min_mapq"], min_bq=PARAMS["min_bq"],
             min_snv=PARAMS["min_snv"], name_len_cap=PARAMS["name_len_cap"])
    t = tacc.pack_tile(arrays, "cpu")
    gate = tacc.tile_gate(arrays["gate"], "cpu")
    old, old_gate = _old_packing(arrays, "cpu")
    for name in tacc._DTYPES:
        assert torch.equal(getattr(t, name), old[name]), name
    assert gate.dtype == torch.uint8 and torch.equal(gate, old_gate)
    old_t = tacc.TileInputs(**old, n_events=t.n_events,
                            max_span=t.max_span)
    got = tacc.tile_launch(t, gate, **p)
    want = tacc.tile_launch(old_t, old_gate, **p)
    assert torch.equal(got, want)
    assert tacc.read_header(got[:tacc.HDR])[1] > 0 or seed % 2


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_gate_apart_on_card(seed):
    """On the card: the CUDA tile kernel under the gate passed apart
    returns the packed result of the gate read from the one buffer that
    held it among the tile's arrays, and the plain version's, bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grom_tpu_torch.testing.tiles import PARAMS, spike_tile
    arrays, _ = spike_tile(seed, True)
    p = dict(thr=tacc.screen_threshold(PARAMS["min_ratio"]),
             min_mapq=PARAMS["min_mapq"], min_bq=PARAMS["min_bq"],
             min_snv=PARAMS["min_snv"], name_len_cap=PARAMS["name_len_cap"])
    t = tacc.pack_tile(arrays, "cuda")
    got = tacc.tile_launch(t, tacc.tile_gate(arrays["gate"], "cuda"), **p)
    old, old_gate = _old_packing(arrays, "cuda")
    want = tacc.tile_launch(tacc.TileInputs(**old, n_events=t.n_events,
                                            max_span=t.max_span),
                            old_gate, **p)
    plain = tacc.tile_launch(tacc.pack_tile(arrays, "cpu"),
                             tacc.tile_gate(arrays["gate"], "cpu"), **p)
    L = len(arrays["chrom_up"])
    got, want, plain = (_result_fields(r, L) for r in (got, want, plain))
    for a, b in ((got, want), (got, plain)):
        assert a[0] == b[0]
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def _result_fields(res, L):
    """What a packed tile result defines, on the host: ((n_mm, K),
    base_tot, the K candidate rows). The CUDA kernel writes only the
    header entries ``read_header`` reads, and its buffer holds room for
    more rows than it found."""
    res = res.cpu()
    K = tacc.read_header(res)[1]
    return (tacc.read_header(res), tacc.result_base_tot(res, L),
            tacc.result_rows(res, L, K))


@pytest.mark.parametrize("L,env,host_c,device_c", [
    (250_000_000, None, 16 << 20, 8 << 20),
    (135_000_000, None, 16 << 20, 8 << 20),
    (24_000_000, None, 3_000_000, 3_000_000),
    (250_000_000, str(4 << 20), 4 << 20, 4 << 20),
])
def test_device_ingest_chunk(L, env, host_c, device_c, monkeypatch):
    """A device engine's ingest chunk is the host engine's capped at
    ``DEVICE_CHUNK_BASES`` (8 Mi); GROM_TPU_CHUNK_BASES sets both."""
    from grom_tpu_torch import driver
    if env is None:
        monkeypatch.delenv("GROM_TPU_CHUNK_BASES", raising=False)
    else:
        monkeypatch.setenv("GROM_TPU_CHUNK_BASES", env)
    assert driver._chunk_bases(L, False) == driver._auto_chunk_bases(L)
    assert driver._chunk_bases(L, False)[0] == host_c
    assert driver._chunk_bases(L, True) == (device_c, driver._chunk_bases(
        L, False)[1])


@pytest.mark.parametrize("engine", ["torch", "mesh"])
def test_capped_device_chunk_matches_host(datasets, engine, tmp_path,
                                          monkeypatch):
    """With the device chunk capped below the host engine's (cnvrich's 1 Mi
    chunk, the cap at 256 Ki, sub-chunks of 128 Ki): the device engine
    fetches its own chunks, takes no prefetched host-engine chunk (none is
    started for it), and writes the host engine's files byte for byte."""
    from grom_tpu_torch import driver
    monkeypatch.setattr(driver, "DEVICE_CHUNK_BASES", 1 << 18)
    monkeypatch.delenv("GROM_TPU_CHUNK_BASES", raising=False)
    monkeypatch.setenv("GROM_TPU_DETECT_BASES", str(1 << 17))
    monkeypatch.setenv("GROM_TPU_DEVICE_CNV", "0")
    fa, bam = datasets["cnvrich"]
    prefetched = []
    start = driver._start_first_chunk_prefetch
    monkeypatch.setattr(driver, "_start_first_chunk_prefetch",
                        lambda *a: prefetched.append(1) or start(*a))
    ranges = []
    streamed = driver.call_chromosome_streamed

    def probed(chrom, refid, out_name, cfg, drv, mq, hez, fetch, *a, **kw):
        def f(t0, t1):
            ranges.append((t0, t1))
            return fetch(t0, t1)
        return streamed(chrom, refid, out_name, cfg, drv, mq, hez, f, *a,
                        **kw)
    monkeypatch.setattr(driver, "call_chromosome_streamed", probed)
    out = {}
    for eng in ("host", engine):
        path = str(tmp_path / ("%s.vcf" % eng))
        driver.run(GromConfig(bam=bam, ref_fasta=fa, out_vcf=path,
                              rd_pval_threshold=1e-4),
                   file_date=DATE, engine=eng, device="cpu")
        out[eng] = path
    L = 1_200_000
    host_c = driver._auto_chunk_bases(L)[0]
    want = ([(t0, min(t0 + host_c, L)) for t0 in range(0, L, host_c)]
            + [(t0, min(t0 + (1 << 18), L)) for t0 in range(0, L, 1 << 18)])
    assert ranges == want and prefetched == [1]
    for suffix in (".vcf", ".ctx.vcf"):
        assert _read(out[engine][:-4] + suffix) == _read(
            out["host"][:-4] + suffix), suffix


@pytest.mark.cuda
@pytest.mark.parametrize("block", [4096, 4 << 20])
def test_span_inputs_cuda_blocks_match_cpu(block, monkeypatch):
    """On the card: 300,001 seeded spans uploaded in blocks of ``block``
    bytes (at 4 KiB every column takes many blocks, the last one partial;
    at the default one or two) equal the CPU's packing, bit for bit, when
    read on the current stream right after the upload."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from grom_tpu_torch.ops import state
    from grom_tpu_torch.testing.spans import random_spans
    monkeypatch.setattr(state, "SPAN_UPLOAD_BLOCK", block)
    batch, eligible = random_spans(300_001, 120_007, 3_000_000, seed=13)
    want = state.span_inputs(batch, eligible, "cpu")
    got = state.span_inputs(batch, eligible, "cuda")
    for name in want._fields:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
