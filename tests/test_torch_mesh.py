"""The port's mesh engine (grom_tpu_torch/parallel/) on the CPU.

* ``MeshAccumulator`` on 2x2 and 1x1 grids of CPU cells against grom_tpu's
  ``MeshAccumulator`` on CPU jax meshes of the same shapes, on the same
  inputs: base_tot, the candidates, rd_mq/rd_hi/rd_lo and the histogram
  exactly equal; also with its depth-list groups cut small, and with the
  grid's cells on two devices (``cpu`` and ``cpu:0`` are two device keys).
* On the card (``cuda``-marked): a run makes no host sync outside its
  launches' gathers and its histogram read, on one card and with the
  grid's cells on two cards.
* ``run(engine="mesh", device="cpu")`` (the plain versions of every kernel)
  against grom_tpu's host engine, byte for byte: the streamed path whole and
  chunked, the whole-batch path and ``-c``, on the fixtures with SVs and
  CNVs; and once against grom_tpu's own mesh engine.
* A job prepared from an ingest chunk's one span index and launched
  under a range-local gate (as the streamed driver queues a detect
  sub-chunk's) gives the torch and mesh accumulators' results of a run
  over its range alone."""

import os

import numpy as np
import pytest
import torch

from grom_tpu_torch.config import GromConfig
from grom_tpu_torch.parallel.mesh import make_mesh
from grom_tpu_torch.parallel import pipeline
from grom_tpu_torch.parallel.pipeline import MeshAccumulator
from grom_tpu_torch.testing.spans import edge_batch as synthetic_batch
from test_torch_slice import (DATA, DATE, HostConfig, _cfg, _read,
                              grom_tpu_native)

# one intra-op thread: the suite runs in several worker processes at once,
# and torch's default of one thread per core would oversubscribe the host
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ds200k():
    from grom_tpu_torch.testing.fixtures import chrom_inputs
    return chrom_inputs(os.path.join(DATA, "ds200k"))


def _same_result(got, want):
    base_g, cand_g, rd_g, hist_g = got
    base_w, cand_w, rd_w, hist_w = want
    assert np.array_equal(base_g, base_w)
    for g, w in zip(rd_g, rd_w):
        assert g.dtype == np.int32 and np.array_equal(g, w)
    assert hist_g.dtype == np.int64 and np.array_equal(hist_g, hist_w)
    assert cand_g["n"] == cand_w["n"]
    for k, v in cand_w.items():
        if k != "n":
            assert np.array_equal(cand_g[k], v), k


def _jax_result(inputs, shape, seg_l):
    import jax

    from grom_tpu.parallel.mesh import make_mesh as jax_mesh
    from grom_tpu.parallel.pipeline import MeshAccumulator as JaxMesh
    acc = JaxMesh(mesh=jax_mesh(*shape, devices=jax.devices("cpu")),
                  seg_l=seg_l)
    res = acc.run(*inputs)
    assert res is not None
    return res


@pytest.mark.parametrize("shape,seg_l", [((2, 2), 1 << 14), ((1, 1), None)])
def test_mesh_accumulator_matches_jax(ds200k, shape, seg_l):
    ci = ds200k
    inputs = (ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate)
    acc = MeshAccumulator(mesh=make_mesh(*shape, devices=["cpu"] * 4),
                          seg_l=seg_l)
    got = acc.run(*inputs)
    _same_result(got, _jax_result(inputs, shape, seg_l))
    assert got[1]["n"] > 0


def test_mesh_accumulator_chunked_matches_jax(ds200k):
    """A position range [lo, hi) with chunk-local gate and base_tot arrays,
    as the streamed path calls it."""
    import jax

    from grom_tpu.parallel.mesh import make_mesh as jax_mesh
    from grom_tpu.parallel.pipeline import MeshAccumulator as JaxMesh
    ci = ds200k
    lo, hi = 61_000, 133_000
    outs = []
    for acc in (MeshAccumulator(mesh=make_mesh(2, 2, devices=["cpu"] * 4),
                                seg_l=1 << 14),
                JaxMesh(mesh=jax_mesh(2, 2, devices=jax.devices("cpu")),
                        seg_l=1 << 14)):
        bt = np.zeros(hi - lo, np.int64)
        rd = tuple(np.zeros(len(ci.chrom), np.int32) for _ in range(3))
        res = acc.run(ci.chrom, ci.batch, ci.eligible, ci.cfg,
                      ci.gate[lo:hi], lo=lo, hi=hi, base_tot_out=bt,
                      rd_out=rd, gate_base=lo, base_tot_base=lo)
        assert res[0] is bt and all(a is b for a, b in zip(res[2], rd))
        outs.append(res)
    _same_result(*outs)
    assert not outs[0][2][1][:lo].any() and not outs[0][2][1][hi:].any()


def test_mesh_accumulator_cell_without_spans():
    """A launch whose cells own end deltas but no spans, and a short last
    launch (5 cells on a 2x2 grid), against grom_tpu's mesh."""
    chrom, batch, eligible, gate = synthetic_batch()
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    inputs = (chrom, batch, eligible, cfg, gate)
    acc = MeshAccumulator(mesh=make_mesh(2, 2, devices=["cpu"] * 4),
                          seg_l=1024)
    _same_result(acc.run(*inputs), _jax_result(inputs, (2, 2), 1024))


@pytest.mark.parametrize("shape", [(2, 2), (1, 1)])
def test_mesh_accumulator_groups_match_jax(ds200k, monkeypatch, shape):
    """Depth-list groups of at most two 2^14-base cells a device: K5 runs
    once per launch (2x2) or once per two launches (1x1), so the carry
    crosses group edges."""
    ci = ds200k
    monkeypatch.setattr(pipeline, "GROUP_POSITIONS", 2 << 14)
    calls = []
    scatter = pipeline.rd_depth.rd_scatter
    monkeypatch.setattr(pipeline.rd_depth, "rd_scatter",
                        lambda *a: calls.append(a[7]) or scatter(*a))
    inputs = (ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate)
    n = shape[0] * shape[1]
    acc = MeshAccumulator(mesh=make_mesh(*shape, devices=["cpu"] * n),
                          seg_l=1 << 14)
    _same_result(acc.run(*inputs), _jax_result(inputs, shape, 1 << 14))
    launches = -(-(-(-len(ci.chrom) // (1 << 14))) // n)
    per_group = 1 if n == 4 else 2
    assert calls == list(range(0, launches, per_group))


def test_mesh_accumulator_two_devices_match_jax(ds200k):
    """A 2x2 grid whose cells alternate between two devices: each device's
    K5 skips the other's cells, the launch's totals are gathered from both,
    and the depth is copied to the collective device."""
    ci = ds200k
    inputs = (ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate)
    acc = MeshAccumulator(mesh=make_mesh(2, 2, devices=["cpu", "cpu:0"] * 2),
                          seg_l=1 << 14)
    assert len(acc.lanes) == 2
    assert [lane.ks for lane in acc.lanes] == [[0, 2], [1, 3]]
    _same_result(acc.run(*inputs), _jax_result(inputs, (2, 2), 1 << 14))


def _run_without_sync(ci, monkeypatch, shape, devices):
    """A run of ``ci`` on a grid over ``devices`` with torch's sync debug
    mode raising outside each launch's gathers and the run's histogram
    read (after a first run that builds the kernels); both runs equal to
    the CPU run."""
    inputs = (ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate)
    n = shape[0] * shape[1]
    want = MeshAccumulator(mesh=make_mesh(*shape, devices=["cpu"] * n),
                           seg_l=1 << 14).run(*inputs)
    acc = MeshAccumulator(mesh=make_mesh(*shape, devices=devices),
                          seg_l=1 << 14)
    _same_result(acc.run(*inputs), want)         # builds the kernels
    torch.cuda.synchronize()
    waits = []

    def may_sync(name):
        fn = getattr(MeshAccumulator, name)

        def f(self, *a):
            waits.append(name)
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(self, *a)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        monkeypatch.setattr(MeshAccumulator, name, f)
    may_sync("_gathers")
    may_sync("_hist")
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = acc.run(*inputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    _same_result(got, want)
    launches = -(-(-(-len(ci.chrom) // (1 << 14))) // n)
    assert waits == ["_gathers"] * launches + ["_hist"]
    return acc


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
def test_mesh_run_cuda_no_sync_between_cells(ds200k, monkeypatch, shape):
    """On the card, with torch's sync debug mode raising: a run of ds200k
    in 2^14-base cells (13 launches on a 1x1 grid, 4 launches of four cells
    on a 2x2 grid on one card) makes no host sync outside each launch's
    gathers and the run's histogram read, and equals the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _run_without_sync(ds200k, monkeypatch, shape,
                      ["cuda:0"] * (shape[0] * shape[1]))


@pytest.mark.cuda
def test_mesh_run_two_cards_no_sync_between_cells(ds200k, monkeypatch):
    """A 2x2 grid whose cells alternate between two cards: each card's K5
    skips the other's cells, the launch's totals cross between the cards
    and cuda:1's depth is copied to cuda:0, all without a host wait; the
    run equals the CPU run, with no host sync outside each launch's
    gathers and the histogram read."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    acc = _run_without_sync(ds200k, monkeypatch, (2, 2),
                            ["cuda:0", "cuda:1"] * 2)
    assert [lane.ks for lane in acc.lanes] == [[0, 2], [1, 3]]


def test_mesh_needs_names():
    chrom, batch, eligible, gate = synthetic_batch()
    batch.reads.name_id = None
    cfg = GromConfig(bam="", ref_fasta="", out_vcf="")
    acc = MeshAccumulator(mesh=make_mesh(1, 1, devices=["cpu"]))
    with pytest.raises(ValueError, match="read-name ids"):
        acc.run(chrom, batch, eligible, cfg, gate)


def test_mesh_grid_layout():
    m = make_mesh(2, 2, devices=["cpu"] * 5)
    assert m.shape == (2, 2) and m.n_local == 4 and m.first_cell == 0
    assert len(m.devices) == 4 and m.group is None
    with pytest.raises(ValueError, match="not enough devices"):
        make_mesh(2, 2, devices=["cpu"] * 3)
    # the default grid: n_sp = 2 for an even cell count above 1
    assert MeshAccumulator(devices=["cpu"] * 4).mesh.shape == (2, 2)
    assert MeshAccumulator(devices=["cpu"] * 3).mesh.shape == (3, 1)
    assert MeshAccumulator(devices=["cpu"]).mesh.shape == (1, 1)


def test_visible_cuda_devices_are_every_card(monkeypatch):
    """The default grid spans every card the process sees; a launcher's
    LOCAL_RANK / LOCAL_WORLD_SIZE do not split them."""
    from grom_tpu_torch.parallel.mesh import visible_cuda_devices
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert visible_cuda_devices() == [torch.device("cuda", i)
                                      for i in range(3)]


@pytest.mark.cuda
def test_mesh_engine_on_every_card(tmp_path, monkeypatch):
    """The mesh engine's default grid over every visible card (cells on
    cards other than the current one), at 60 kb ingest chunks, byte for
    byte against the host engine."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    from grom_tpu_torch.driver import run
    from grom_tpu_torch.parallel.pipeline import get_mesh_accumulator
    monkeypatch.setenv("GROM_TPU_CHUNK_BASES", "60000")
    acc = get_mesh_accumulator("cuda")
    assert len({d.index for d in acc.mesh.devices}) == torch.cuda.device_count()
    host = str(tmp_path / "host.vcf")
    port = str(tmp_path / "mesh.vcf")
    run(_cfg("ds200k", host), file_date=DATE, engine="host")
    run(_cfg("ds200k", port), file_date=DATE, engine="mesh", device="cuda")
    assert _read(port) == _read(host)
    assert _read(str(tmp_path / "mesh.ctx.vcf")) == _read(
        str(tmp_path / "host.ctx.vcf"))


def _host_and_mesh(tmp_path, fixture, kw, mesh=None):
    from grom_tpu.driver import run as run_host
    from grom_tpu_torch.driver import run
    host = str(tmp_path / "host.vcf")
    port = str(tmp_path / "mesh.vcf")
    run_host(_cfg(fixture, host, HostConfig, **kw), file_date=DATE,
             engine="host")
    run(_cfg(fixture, port, **kw), file_date=DATE, engine="mesh",
        device="cpu", mesh=mesh)
    assert _read(port) == _read(host)
    assert _read(str(tmp_path / "mesh.ctx.vcf")) == _read(
        str(tmp_path / "host.ctx.vcf"))
    return port


@pytest.mark.parametrize("fixture,kw,chunk", [
    ("ds200k", {}, None),
    ("ds200k", {}, 60_000),
    ("dup60k", {"rmdup": True}, None),
    ("sv400k", {}, None),
    ("cnvrich", {"rd_pval_threshold": 1e-4}, None),
])
def test_mesh_engine_matches_host(tmp_path, monkeypatch, fixture, kw, chunk):
    """The streamed path on a 2x2 grid of CPU cells; at 60 kb ingest
    chunks the cells and the carry cross many chunk edges."""
    from test_full_parity import _rows
    if chunk:
        monkeypatch.setenv("GROM_TPU_CHUNK_BASES", str(chunk))
    out = _host_and_mesh(tmp_path, fixture, kw,
                         make_mesh(2, 2, devices=["cpu"] * 4))
    rows = _rows(out)
    assert len(rows) == len(_rows(os.path.join(DATA, fixture, "oracle.vcf")))
    if fixture == "cnvrich":
        assert sum(1 for r in rows if "<DEL>" in r or "<DUP>" in r) >= 5


def test_mesh_engine_default_grid(tmp_path):
    """No ``mesh``: the engine builds its grid itself (one CPU cell)."""
    _host_and_mesh(tmp_path, "ds200k", {})


def test_mesh_engine_whole_batch_and_child_region(tmp_path, monkeypatch):
    """The whole-batch path (GROM_TPU_STREAM_BASES above the chromosome
    length) and ``-c`` on the mesh engine, against the oracles."""
    from grom_tpu_torch.driver import run
    from test_full_parity import _rows
    mesh = make_mesh(2, 2, devices=["cpu"] * 4)
    monkeypatch.setenv("GROM_TPU_STREAM_BASES", str(1 << 40))
    out = str(tmp_path / "o.vcf")
    run(_cfg("ds200k", out), file_date=DATE, engine="mesh", device="cpu",
        mesh=mesh)
    assert _rows(out) == _rows(os.path.join(DATA, "ds200k", "oracle.vcf"))
    monkeypatch.delenv("GROM_TPU_STREAM_BASES")
    oracle = os.path.join(DATA, "ds200k", "oracle.region-0-0-110000")
    res = run(_cfg("ds200k", out, one_chromosome="0,0,0,110000"),
              engine="mesh", device="cpu", mesh=mesh)
    assert _read(res.vcf_path) == _read(oracle)
    assert _read(res.ctx_path) == _read(oracle + ".ctx")


def test_mesh_engine_matches_grom_tpu_mesh(tmp_path, monkeypatch):
    """grom_tpu's own mesh engine (2x2 CPU jax mesh, strict: no fallback to
    its host engine) and the port's, byte for byte on ds200k."""
    import jax

    from grom_tpu.driver import run as run_jax
    from grom_tpu.parallel.mesh import make_mesh as jax_mesh
    from grom_tpu_torch.driver import run
    grom_tpu_native()          # grom_tpu's mesh needs read-name ids
    monkeypatch.setenv("GROM_TPU_STRICT", "1")
    ref = str(tmp_path / "jax.vcf")
    port = str(tmp_path / "port.vcf")
    run_jax(_cfg("ds200k", ref, HostConfig), file_date=DATE, engine="mesh",
            mesh=jax_mesh(2, 2, devices=jax.devices("cpu")))
    run(_cfg("ds200k", port), file_date=DATE, engine="mesh", device="cpu",
        mesh=make_mesh(2, 2, devices=["cpu"] * 4))
    assert _read(port) == _read(ref)
    assert _read(str(tmp_path / "port.ctx.vcf")) == _read(
        str(tmp_path / "jax.ctx.vcf"))


@pytest.mark.parametrize("lo,hi", [(0, 50_000), (61_000, 133_000),
                                   (150_000, 199_000)])
def test_chunk_index_keeps_device_results(ds200k, lo, hi):
    """A job the streamed driver prepares from its ingest chunk's one span
    index (``chunk`` over a wider range, then ``prepare`` of [lo, hi)) and
    launches under a range-local gate gives the torch and mesh
    accumulators' results of a run over [lo, hi) alone."""
    from grom_tpu_torch.ops.accumulate import TorchAccumulator
    ci = ds200k
    L = len(ci.chrom)
    kw = dict(lo=lo, hi=hi)
    gate = ci.gate[lo:hi]
    acc = TorchAccumulator("cpu")
    job = acc.prepare(ci.chrom, acc.chunk(ci.batch, ci.eligible, 0, L),
                      ci.cfg, lo, hi)
    assert job.tiles and job.nbytes > 0
    bt = np.zeros(hi - lo, np.int64)
    cut = acc.launch(job, gate, base_tot_out=bt, gate_base=lo,
                     base_tot_base=lo)
    whole = TorchAccumulator("cpu").run(ci.chrom, ci.batch, ci.eligible,
                                        ci.cfg, ci.gate, **kw)
    assert cut[0] is bt and cut[1]["n"] > 0
    assert np.array_equal(cut[0], whole[0][lo:hi])
    for k, v in whole[1].items():
        assert np.array_equal(cut[1][k], v), k
    mesh = MeshAccumulator(mesh=make_mesh(1, 1, devices=["cpu"]),
                           seg_l=1 << 14)
    job = mesh.prepare(ci.chrom, mesh.chunk(ci.batch, ci.eligible, 0, L),
                       ci.cfg, lo, hi)
    _same_result(mesh.launch(job, gate, gate_base=lo),
                 mesh.run(ci.chrom, ci.batch, ci.eligible, ci.cfg, ci.gate,
                          **kw))