"""The mesh engine: the per-base accumulate + SNV screen and the caf_rd_*
depth lists of one position range, sharded over a ``(dp, sp)`` grid of
genome cells (the counterpart of grom_tpu/parallel/pipeline.py).

A range is cut into cells of ``seg_l`` positions; each launch processes
``n_dp * n_sp`` consecutive cells, one per grid cell (parallel/mesh.py).
Each device of the grid is a lane: the cells of each launch it holds. A
run keeps its buffers on each lane in a ``_LaneRun`` of its own, so runs
share no buffer. A run is ``prepare`` then ``launch`` (``run`` does both):
``chunk`` indexes a batch's spans once (``ops/accumulate.py ChunkReads``)
and each lane takes them and their reads in one upload (``ops/state.py
span_inputs``), shared by every range prepared from it; ``prepare``
uploads each cell's tile inputs to the cell's device (a ``MeshJob``, which
holds device tensors only); ``launch`` uploads the range's gate once a
lane and runs the kernels. The streamed driver makes one chunk an ingest
chunk, prepares a detect sub-chunk's job when it feeds the sub-chunk and
launches it when the sub-chunk drains. Per group of launches
(all of a run's launches, unless their delta rows would pass
``GROUP_POSITIONS`` positions a lane), each lane runs K5 ``rd_scatter``
once: the endpoint deltas, cell totals and chunk sums of every cell it
holds in the group. Then per launch, per cell, on the cell's device:

* the tile kernel (``ops/accumulate.py tile_launch``) over the cell's spans,
  clipped at the cell edges, enqueued without a wait: its base_tot, its
  candidate count and its rows stay on the card until the launch's
  gathers;
* after the launch's cell totals are exchanged (copied from each lane's
  K5 totals to the collective device, ``all_gather_into_tensor`` there
  within a process group, and copied back to each other lane), K6 ``rd_scan``: the cell's depth lists from the carry of earlier
  launches, the earlier cells' totals and its own rows, written into the
  launch's output; its histogram of clip(rd_hi, 0, 255) is added into the
  lane's histogram of the run, and the lane's last cell of the launch
  stores the next launch's carry on the card.

Between the cells of a launch nothing is uploaded, allocated or waited for
on the host; the launch's outputs are all-gathered (so every process
returns the whole result) and read once. The histogram is summed over
lanes and ``all_reduce``d once per run.

Chunked calls (``lo``/``hi``) carry nothing between them: spans are clipped
to [lo, hi), so each call rebuilds the absolute depth of its range from
zero. Tile outputs are bounded by the cell's width, so there is no overflow
and no ``None`` return. ``endpoint_deltas`` (and ``ops/state.py
cell_deltas``) build the same deltas on the host, sorted: the reference the
tests hold K5 to.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from grom_tpu_torch.ops import accumulate, rd_depth
from grom_tpu_torch.ops.accumulate import (ChunkReads, merge_cands,
                                            read_header, ref_bases,
                                            result_base_tot, result_header,
                                            result_rows, screen_threshold,
                                            tile_bytes, tile_gate,
                                            tile_inputs, unpack_rows)
from grom_tpu_torch.ops.state import DepthLists, span_inputs
from grom_tpu_torch.parallel.mesh import (Mesh, current_group, make_mesh,
                                          visible_cuda_devices)
from grom_tpu_torch.utils.timing import phase

HIST_BINS = rd_depth.HIST_BINS
# delta-row positions a lane holds in one K5 group: three int32 rows each,
# 192 MB (64 cells of 2^18 positions)
GROUP_POSITIONS = 64 << 18


def _pow2(n: int, floor: int = 8) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


def _copy(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst.copy_(src)``, not waited for between CUDA devices."""
    return dst.copy_(src, non_blocking=dst.is_cuda and src.is_cuda)


def endpoint_deltas(batch, eligible: np.ndarray, min_mapq: int, L: int,
                    lo: int, hi: int):
    """The rd endpoint deltas of [lo, hi), stably sorted by position:
    (pos int64, w_mq int32, w_hi int8, w_lo int8). A span is kept on the
    whole-span rule ref >= 0 & ref + len < L (call/scan.py), then clipped to
    [lo, hi); its end delta at ``hi`` is dropped by the cell slicing."""
    sel = eligible[batch.span_read]
    ref = batch.span_ref[sel].astype(np.int64)
    ln = batch.span_len[sel].astype(np.int64)
    rid = batch.span_read[sel]
    oks = (ref >= 0) & (ref + ln < L)
    ref, ln, rid = ref[oks], ln[oks], rid[oks]
    s_cl = np.maximum(ref, lo)
    e_cl = np.minimum(ref + ln, hi)
    keep = e_cl > s_cl
    s_cl, e_cl, rid = s_cl[keep], e_cl[keep], rid[keep]
    mq_w = batch.mapq[rid].astype(np.int32)
    hi_w = (mq_w >= min_mapq).astype(np.int8)
    lo_w = (1 - hi_w).astype(np.int8)
    d_pos = np.concatenate([s_cl, e_cl])
    order = np.argsort(d_pos, kind="stable")
    return (d_pos[order], np.concatenate([mq_w, -mq_w])[order],
            np.concatenate([hi_w, -hi_w])[order],
            np.concatenate([lo_w, -lo_w])[order])


class _Lane:
    """One device of the grid: the local cells of each launch it holds
    (``ks``, in order) and K5's slot map on it."""

    def __init__(self, dev: torch.device, ks: List[int], slot_of):
        self.dev = dev
        self.ks = ks
        self.rank = {k: i for i, k in enumerate(ks)}
        self.slot_of = slot_of


class _LaneRun:
    """One run's buffers on a lane's device: the run's spans (its chunk's
    upload), K5's outputs for ``cells`` slots, the carry before each
    launch, the run's histogram, and the staging the lane needs when it is
    not the collective device. ``launch`` holds them, so runs on one
    accumulator share no buffer."""

    def __init__(self, lane: _Lane, spans, cells: int, seg_l: int,
                 n_launches: int, n_launch: int, coll):
        i32 = torch.int32
        dev = lane.dev
        self.lane = lane
        self.spans = spans
        self.rows, self.tot, self.csum = rd_depth.scatter_outputs(
            cells, seg_l, dev)
        self.carry = torch.zeros((n_launches + 1, 3), dtype=i32, device=dev)
        self.hist = torch.zeros(HIST_BINS, dtype=i32, device=dev)
        self.launch_tot = None
        if dev != coll:
            self.tot_buf = torch.empty((n_launch, 3), dtype=i32, device=dev)
            self.rd_buf = torch.empty((3, seg_l), dtype=i32, device=dev)

    def outputs(self, ng: int):
        """K5's outputs for a group of ``ng`` launches."""
        c = ng * len(self.lane.ks)
        return self.rows[:c], self.tot[:c], self.csum[:c]


class MeshJob(NamedTuple):
    """A prepared range [lo, hi) of a chromosome of L bases: its cells of
    ``seg_l`` positions, its launches, the launches of a K5 group; per
    launch the ``TileInputs`` (or None: no span reaches the cell) of each
    of this process's cells, on the cell's device; each lane's upload of
    the chunk's spans; the screen's threshold and the run's config."""
    lo: int
    hi: int
    L: int
    seg_l: int
    cells: list
    n_launches: int
    per_group: int
    tiles: list
    spans: list
    thr: float
    cfg: object

    @property
    def nbytes(self) -> int:
        """Device bytes of the job's tile inputs (the chunk's span uploads,
        shared with the chunk's other jobs, apart)."""
        return sum(tile_bytes(t) for launch in self.tiles for t in launch
                   if t is not None)


class MeshAccumulator:
    """Runs the per-base accumulate + SNV screen and the caf_rd_* depth
    lists of one chromosome range over a grid of cells. ``run`` returns
    (base_tot, cand, (rd_mq, rd_hi, rd_lo), hist) as grom_tpu's
    ``MeshAccumulator.run`` does."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 seg_l: Optional[int] = None, devices=None):
        if mesh is None:
            devices = (list(devices) if devices is not None
                       else visible_cuda_devices())
            if not devices:
                raise RuntimeError("the mesh engine needs a CUDA device, and "
                                   "none is visible")
            group = current_group()
            n = len(devices) * (dist.get_world_size(group) if group else 1)
            n_sp = 2 if n % 2 == 0 and n > 1 else 1
            mesh = make_mesh(n // n_sp, n_sp, devices=devices, group=group)
        self.mesh = mesh
        self.n_dp, self.n_sp = mesh.shape
        self.n_cells_launch = mesh.n_cells
        self.seg_l = seg_l
        # the device the collectives and the gathered outputs use: NCCL
        # needs CUDA tensors, gloo CPU tensors
        self.coll = mesh.devices[0]
        if mesh.group is not None:
            if dist.get_backend(mesh.group) != "nccl":
                self.coll = torch.device("cpu")
        self.lanes: List[_Lane] = []
        # local cell -> index of its lane
        self.lane_of: List[int] = []
        for dev in mesh.devices:
            li = next((i for i, x in enumerate(self.lanes) if x.dev == dev),
                      None)
            if li is None:
                ks = [i for i, d in enumerate(mesh.devices) if d == dev]
                slot_of = np.full(mesh.n_cells, -1, np.int32)
                slot_of[mesh.first_cell + np.array(ks)] = np.arange(len(ks))
                li = len(self.lanes)
                self.lanes.append(
                    _Lane(dev, ks, torch.from_numpy(slot_of).to(dev)))
            self.lane_of.append(li)

    def _seg_l_for(self, L: int) -> int:
        if self.seg_l:
            return self.seg_l
        # about two launches of work, in cells of at most one full tile
        target = max(1 << 14, L // (2 * self.n_cells_launch) + 1)
        return min(_pow2(target), accumulate.TILE_L)

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """[n_local, ...] per-process rows -> [n_cells, ...] on every
        process."""
        if self.mesh.group is None:
            return x
        out = torch.empty((self.mesh.world * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous(), group=self.mesh.group)
        return out

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh.group is not None:
            dist.all_reduce(x, group=self.mesh.group)
        return x

    def chunk(self, batch, eligible: np.ndarray, lo: int = 0,
              hi: int = 0) -> ChunkReads:
        """The host index ``prepare`` reads (the spans of ``batch`` over
        [lo, hi), all unless ``hi > lo``), with each lane's upload of the
        batch's spans and reads (K5's input) in ``spans``."""
        with phase("mesh.prep"):
            ch = ChunkReads(batch, eligible, "mesh", lo, hi)
        with phase("mesh.spans"):
            ch.spans = [span_inputs(batch, eligible, lane.dev)
                        for lane in self.lanes]
        return ch

    def prepare(self, chrom: np.ndarray, chunk: ChunkReads, cfg,
                lo: int = 0, hi: int = 0) -> MeshJob:
        """The job of [lo, hi) (within ``chunk``'s range): each of this
        process's cells' tile inputs on the cell's device, one upload a
        cell, not waited for. The job holds no host array of the reads."""
        m = self.mesh
        L = len(chrom)
        hi = hi if hi > 0 else L
        seg_l = self._seg_l_for(hi - lo)
        n_cells = -(-(hi - lo) // seg_l)
        cells = [(t0, min(t0 + seg_l, hi)) for t0 in range(lo, hi, seg_l)]
        n = self.n_cells_launch
        n_launches = -(-n_cells // n)
        # launches per K5 group
        per_group = min(n_launches, max(1, GROUP_POSITIONS // (
            seg_l * max(len(x.ks) for x in self.lanes))))
        with phase("mesh.prep"):
            up, is_n = ref_bases(chrom, lo, hi)
        tiles = []
        k0 = m.first_cell
        for r in range(n_launches):
            # pad cells have no entry
            mine = cells[r * n:(r + 1) * n][k0:k0 + m.n_local]
            with phase("mesh.tile_inputs"):
                tiles.append([tile_inputs(
                    chunk.sindex, chunk.reads, chunk.elig_u8, t0, t1,
                    up[t0 - lo:t1 - lo], is_n[t0 - lo:t1 - lo],
                    m.devices[k]) for k, (t0, t1) in enumerate(mine)])
        return MeshJob(lo, hi, L, seg_l, cells, n_launches, per_group, tiles,
                       chunk.spans, screen_threshold(cfg.min_snv_ratio), cfg)

    def run(self, chrom: np.ndarray, batch, eligible: np.ndarray, cfg,
            gate: np.ndarray, lo: int = 0, hi: int = 0,
            base_tot_out: Optional[np.ndarray] = None,
            rd_out=None, gate_base: int = 0, base_tot_base: int = 0):
        """``lo``/``hi`` restrict processing to a position range;
        ``base_tot_out``/``rd_out`` receive base_tot and the depth lists in
        place (``launch``). ``gate``/``base_tot_out`` may be chunk-local
        arrays whose index 0 is ``gate_base``/``base_tot_base``:
        ``prepare`` then ``launch``."""
        hi = hi if hi > 0 else len(chrom)
        job = self.prepare(chrom, self.chunk(batch, eligible, lo, hi), cfg,
                           lo, hi)
        return self.launch(job, gate, base_tot_out, rd_out, gate_base,
                           base_tot_base)

    def launch(self, job: MeshJob, gate: np.ndarray,
               base_tot_out: Optional[np.ndarray] = None, rd_out=None,
               gate_base: int = 0, base_tot_base: int = 0):
        """Run a prepared job under ``gate`` (uploaded once a lane). Returns
        (base_tot, cand, depth lists, hist). ``rd_out`` is three host arrays
        (rd_mq, rd_hi, rd_lo), or ``ops/state.py DepthLists``, whose rows on
        the card each launch's depth is copied into there, with no copy to
        the host (returned in the place of the three arrays).
        ``gate``/``base_tot_out`` may be range-local arrays whose index 0 is
        ``gate_base``/``base_tot_base``."""
        m = self.mesh
        i32 = torch.int32
        cfg = job.cfg
        lo, hi, L, seg_l = job.lo, job.hi, job.L, job.seg_l
        cells, n_launches, per_group = job.cells, job.n_launches, \
            job.per_group
        n = self.n_cells_launch
        with phase("mesh.prep"):
            g = gate[lo - gate_base:hi - gate_base]
            gates = {lane.dev: tile_gate(g, lane.dev) for lane in self.lanes}
        runs = [_LaneRun(lane, spans, per_group * len(lane.ks), seg_l,
                         n_launches, n, self.coll)
                for lane, spans in zip(self.lanes, job.spans)]
        coll = self.coll
        outs = dict(
            bt=torch.zeros((m.n_local, seg_l), dtype=i32, device=coll),
            rd=torch.zeros((m.n_local, 3, seg_l), dtype=i32, device=coll),
            head=torch.zeros((m.n_local, accumulate.HDR), dtype=i32,
                             device=coll),
            tot_local=torch.zeros((m.n_local, 3), dtype=i32, device=coll),
            tot_all=torch.zeros((n, 3), dtype=i32, device=coll))

        base_tot = (base_tot_out if base_tot_out is not None
                    else np.zeros(L, np.int64))
        lists = rd_out if isinstance(rd_out, DepthLists) else None
        if lists is not None:
            rd_mq = rd_hi = rd_lo = None
        elif rd_out is not None:
            rd_mq, rd_hi, rd_lo = rd_out
        else:
            rd_mq = np.zeros(L, np.int32)
            rd_hi = np.zeros(L, np.int32)
            rd_lo = np.zeros(L, np.int32)
        cand_parts: List[dict] = []

        for g0 in range(0, n_launches, per_group):
            ng = min(per_group, n_launches - g0)
            with phase("mesh.rd_scatter"):
                for lr in runs:
                    rd_depth.rd_scatter(lr.spans, lr.lane.slot_of, lo, hi, L,
                                        cfg.min_mapq, seg_l, g0, ng,
                                        *lr.outputs(ng))
            for r in range(g0, g0 + ng):
                launch = cells[r * n:(r + 1) * n]
                bt, rd, cands = self._launch(r, r - g0, launch, job, gates,
                                             outs, runs, lists is None)
                with phase("mesh.copy_out"):
                    # the launch's cells are consecutive, and all but the
                    # range's last are seg_l wide: its depth is one block
                    a, b = launch[0][0], launch[-1][1]
                    block = rd[:len(launch)].transpose(0, 1).reshape(
                        3, -1)[:, :b - a]
                    if lists is not None:
                        lists.rows[:, a:b].copy_(block)
                    else:
                        rd_mq[a:b], rd_hi[a:b], rd_lo[a:b] = block.numpy()
                    for i, (t0, t1) in enumerate(launch):
                        base_tot[t0 - base_tot_base:
                                 t1 - base_tot_base] = bt[i, :t1 - t0]
                        if cands[i] is not None:
                            cand_parts.append(cands[i])
        with phase("mesh.hist"):
            hist = self._hist(runs)
        return base_tot, merge_cands(cand_parts), \
            lists if lists is not None else (rd_mq, rd_hi, rd_lo), hist

    def _launch_totals(self, rr: int, outs: dict, runs) -> None:
        """Sets each lane run's ``launch_tot`` to the totals [n_cells_launch,
        3] of every cell of the group's launch ``rr``, on the lane's
        device."""
        m = self.mesh
        local = outs["tot_local"]
        for k, li in enumerate(self.lane_of):
            lr = runs[li]
            _copy(local[k], lr.tot[rr * len(lr.lane.ks) + lr.lane.rank[k]])
        tot_all = local
        if m.group is not None:
            tot_all = outs["tot_all"]
            dist.all_gather_into_tensor(tot_all, local, group=m.group)
        for lr in runs:
            lr.launch_tot = (tot_all if lr.lane.dev == self.coll
                             else _copy(lr.tot_buf, tot_all))

    def _launch(self, r: int, rr: int, launch, job: MeshJob, gates: dict,
                outs: dict, runs, rd_host: bool):
        """Launch ``r`` (``rr`` within its K5 group) of up to
        ``n_cells_launch`` cells. Returns (base_tot int32 [n, seg_l], rd
        int32 [n, 3, seg_l], per-cell candidate dicts or None), gathered on
        every process; rd on the host with ``rd_host``, else on the
        collective device."""
        m = self.mesh
        k0 = m.first_cell
        mine = launch[k0:k0 + m.n_local]     # pad cells have no entry
        cfg = job.cfg
        lo = job.lo

        results = []
        for k, (t0, t1) in enumerate(mine):
            tile = job.tiles[r][k]
            with phase("mesh.tile"):
                # a cell with no spans may still own end deltas
                results.append(None if tile is None
                               else accumulate.tile_launch(
                                   tile, gates[m.devices[k]][t0 - lo:t1 - lo],
                                   job.thr, cfg.min_mapq, cfg.min_base_qual,
                                   cfg.min_snv))

        # ---- cross-cell carry and depth ---------------------------------
        with phase("mesh.carry"):
            self._launch_totals(rr, outs, runs)
            outs["bt"].zero_()
            outs["head"].zero_()
        for k, (t0, t1) in enumerate(mine):
            lr = runs[self.lane_of[k]]
            ks = lr.lane.ks
            i = lr.lane.rank[k]
            slot = rr * len(ks) + i
            # the lane's last cell of the launch stores the next carry
            last = i + 1 == len(ks) or ks[i + 1] >= len(mine)
            on_coll = lr.lane.dev == self.coll
            with phase("mesh.rd_scan"):
                rd_depth.rd_scan(
                    lr.rows[slot], lr.csum[slot], lr.launch_tot, k0 + k,
                    lr.carry[r], t1 - t0,
                    outs["rd"][k] if on_coll else lr.rd_buf, lr.hist,
                    lr.carry[r + 1] if last else None)
            with phase("mesh.cell_outputs"):
                if not on_coll:
                    _copy(outs["rd"][k], lr.rd_buf)
                if results[k] is not None:
                    _copy(outs["bt"][k, :t1 - t0],
                          result_base_tot(results[k], t1 - t0))
                    _copy(outs["head"][k], result_header(results[k]))
        with phase("mesh.gathers"):
            return self._gathers(launch, mine, results, outs, rd_host)

    def _gathers(self, launch, mine, results, outs, rd_host: bool):
        """The launch's outputs gathered on every process, as ``_launch``
        returns them: the launch's host reads are all here."""
        m = self.mesh
        coll = self.coll
        i32 = torch.int32
        k0 = m.first_cell
        bt_all = self._gather(outs["bt"]).cpu().numpy()
        rd_all = self._gather(outs["rd"])
        if rd_host:
            rd_all = rd_all.cpu()

        # ---- candidates: counts, then rows padded to the largest -------
        counts = [read_header(h)[1]
                  for h in self._gather(outs["head"]).cpu().numpy()]
        K = max(counts, default=0)
        out: List[Optional[dict]] = [None] * len(launch)
        if K:
            packed = torch.zeros((m.n_local, K, accumulate.REC), dtype=i32,
                                 device=coll)
            for k, res in enumerate(results):
                n = counts[k0 + k]
                if n:
                    _copy(packed[k, :n],
                          result_rows(res, mine[k][1] - mine[k][0], n))
            packed = self._gather(packed).cpu().numpy()
            for i, (t0, _) in enumerate(launch):
                if counts[i]:
                    out[i] = unpack_rows(packed[i, :counts[i]], t0)
        return bt_all, rd_all, out

    def _hist(self, runs) -> np.ndarray:
        """The run's histogram, summed over lanes and processes."""
        hist = torch.zeros(HIST_BINS, dtype=torch.int32, device=self.coll)
        for lr in runs:
            hist += lr.hist.to(self.coll)
        return self._all_reduce(hist).cpu().numpy().astype(np.int64)


_MESH_ACC: dict = {}


def get_mesh_accumulator(device="cuda") -> MeshAccumulator:
    """This process's mesh accumulator: over its visible CUDA devices for a
    CUDA ``device``, over one CPU cell for "cpu" (the plain versions).
    Rebuilt when the default process group changes."""
    dev = torch.device(device)
    group = current_group()
    key = (dev.type, group)
    acc = _MESH_ACC.get(key)
    if acc is None:
        devices = visible_cuda_devices() if dev.type == "cuda" else [dev]
        acc = MeshAccumulator(devices=devices)
        _MESH_ACC.clear()
        _MESH_ACC[key] = acc
    return acc
