"""The mesh engine: the per-base accumulate + SNV screen and the caf_rd_*
depth lists of one position range, sharded over a ``(dp, sp)`` grid of
genome cells (the counterpart of grom_tpu/parallel/pipeline.py).

A range is cut into cells of ``seg_l`` positions; each launch processes
``n_dp * n_sp`` consecutive cells, one per grid cell (parallel/mesh.py).
Per cell, on the cell's device:

* the tile kernel (``ops/accumulate.py tile_launch``) over the cell's spans,
  clipped at the cell edges, enqueued without a wait: its base_tot, its
  candidate count and its rows stay on the card until the launch's
  gathers;
* K5 ``rd_scatter`` over the endpoint deltas the cell owns (+w at a span's
  clipped start, -w at its clipped end, owned by the cell holding the
  position), returning the cell's delta totals.

Then the carry: the totals of all cells of the launch are exchanged
(``all_gather_into_tensor`` within a process group, a local stack without
one), their exclusive prefix plus the carry of earlier launches gives each
cell its base, and K6 ``rd_scan`` writes the cell's depth lists and its
histogram of clip(rd_hi, 0, 255). The histogram is summed over cells and
``all_reduce``d; the per-cell outputs are all-gathered, so every process
returns the whole result.

Chunked calls (``lo``/``hi``) carry nothing between them: spans are clipped
to [lo, hi), so each call rebuilds the absolute depth of its range from
zero. Tile outputs are bounded by the cell's width, so there is no overflow
and no ``None`` return.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from grom_tpu_torch.ops import accumulate, rd_depth
from grom_tpu_torch.ops.accumulate import (SpanIndex, merge_cands,
                                            read_header, result_base_tot,
                                            result_header, result_rows,
                                            screen_threshold, tile_inputs,
                                            unpack_rows)
from grom_tpu_torch.ops.state import cell_deltas
from grom_tpu_torch.parallel.mesh import (Mesh, current_group, make_mesh,
                                          visible_cuda_devices)

HIST_BINS = rd_depth.HIST_BINS


def _pow2(n: int, floor: int = 8) -> int:
    v = floor
    while v < n:
        v *= 2
    return v


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

    def run(self, chrom: np.ndarray, batch, eligible: np.ndarray, cfg,
            gate: np.ndarray, lo: int = 0, hi: int = 0,
            base_tot_out: Optional[np.ndarray] = None,
            rd_out: Optional[Tuple[np.ndarray, np.ndarray,
                                   np.ndarray]] = None,
            gate_base: int = 0, base_tot_base: int = 0):
        """``lo``/``hi`` restrict processing to a position range;
        ``base_tot_out``/``rd_out`` receive base_tot and the depth lists in
        place. ``gate``/``base_tot_out`` may be chunk-local arrays whose
        index 0 is ``gate_base``/``base_tot_base``."""
        reads = batch.reads
        if reads.name_id is None or reads.name_len is None:
            raise ValueError("the mesh accumulator needs read-name ids: "
                             "decode the reads with their names")
        L = len(chrom)
        hi = hi if hi > 0 else L
        seg_l = self._seg_l_for(hi - lo)
        n_cells = -(-(hi - lo) // seg_l)
        cells = [(t0, min(t0 + seg_l, hi)) for t0 in range(lo, hi, seg_l)]

        part = chrom[lo:hi]
        up = np.where(part >= 97, part - 32, part).astype(np.uint8)
        prep = dict(
            sindex=SpanIndex(batch), reads=reads,
            elig_u8=eligible.astype(np.uint8), up=up,
            is_n=up == ord("N"), gate_u8=(gate > 0).astype(np.uint8),
            lo=lo, gate_base=gate_base,
            deltas=endpoint_deltas(batch, eligible, cfg.min_mapq, L, lo, hi),
            thr=screen_threshold(cfg.min_snv_ratio), cfg=cfg)

        base_tot = (base_tot_out if base_tot_out is not None
                    else np.zeros(L, np.int64))
        if rd_out is not None:
            rd_mq, rd_hi, rd_lo = rd_out
        else:
            rd_mq = np.zeros(L, np.int32)
            rd_hi = np.zeros(L, np.int32)
            rd_lo = np.zeros(L, np.int32)
        hist = np.zeros(HIST_BINS, np.int64)
        cand_parts: List[dict] = []
        carry = np.zeros(3, np.int32)       # cross-launch rd carry

        n = self.n_cells_launch
        for r0 in range(0, n_cells, n):
            launch = cells[r0:r0 + n]
            bt, rd, h, cands = self._launch(launch, seg_l, carry, prep)
            for i, (t0, t1) in enumerate(launch):
                w = t1 - t0
                base_tot[t0 - base_tot_base:t1 - base_tot_base] = bt[i, :w]
                rd_mq[t0:t1] = rd[i, 0, :w]
                rd_hi[t0:t1] = rd[i, 1, :w]
                rd_lo[t0:t1] = rd[i, 2, :w]
                if cands[i] is not None:
                    cand_parts.append(cands[i])
            # the next launch's carry: the absolute depth at the last
            # position of this launch's last real cell
            w_last = launch[-1][1] - launch[-1][0]
            carry = rd[len(launch) - 1, :, w_last - 1].astype(np.int32)
            hist += h
        return base_tot, merge_cands(cand_parts), \
            (rd_mq, rd_hi, rd_lo), hist

    def _launch(self, launch, seg_l: int, carry: np.ndarray, prep: dict):
        """One launch of up to ``n_cells_launch`` cells. Returns (base_tot
        int32 [n, seg_l], rd int32 [n, 3, seg_l], hist int64 [256], per-cell
        candidate dicts or None), gathered on every process."""
        m = self.mesh
        coll = self.coll
        i32 = torch.int32
        k0 = m.first_cell
        mine = launch[k0:k0 + m.n_local]     # pad cells have no entry
        cfg = prep["cfg"]
        lo = prep["lo"]

        tots, deltas, results = [], [], []
        for k, dev in enumerate(m.devices):
            if k >= len(mine):
                tots.append(torch.zeros(3, dtype=i32, device=coll))
                continue
            t0, t1 = mine[k]
            tile = tile_inputs(
                prep["sindex"], prep["reads"], prep["elig_u8"], t0, t1,
                prep["up"][t0 - lo:t1 - lo], prep["is_n"][t0 - lo:t1 - lo],
                prep["gate_u8"][t0 - prep["gate_base"]:
                                t1 - prep["gate_base"]], dev)
            # a cell with no spans may still own end deltas
            results.append(None if tile is None else accumulate.tile_launch(
                tile, prep["thr"], cfg.min_mapq, cfg.min_base_qual,
                cfg.min_snv))
            delta, tot = rd_depth.rd_scatter(
                *cell_deltas(*prep["deltas"], t0, t1, dev), seg_l)
            tots.append(tot.to(coll))
            deltas.append(delta)

        # ---- cross-cell carry -------------------------------------------
        tot_all = self._gather(torch.stack(tots))               # [n, 3]
        excl = torch.cumsum(tot_all, 0, dtype=i32) - tot_all
        base = excl + torch.from_numpy(carry).to(coll)

        bt_out = torch.zeros((m.n_local, seg_l), dtype=i32, device=coll)
        rd_out = torch.zeros((m.n_local, 3, seg_l), dtype=i32, device=coll)
        hist = torch.zeros(HIST_BINS, dtype=i32, device=coll)
        # each cell's result header, read with the gathers
        head = torch.zeros((m.n_local, accumulate.HDR), dtype=i32,
                           device=coll)
        for k, (t0, t1) in enumerate(mine):
            dev = m.devices[k]
            rd, h = rd_depth.rd_scan(deltas[k], base[k0 + k].to(dev),
                                     t1 - t0)
            rd_out[k] = rd.to(coll)
            hist += h.to(coll)
            if results[k] is not None:
                bt_out[k, :t1 - t0] = result_base_tot(results[k],
                                                      t1 - t0).to(coll)
                head[k] = result_header(results[k]).to(coll)
        hist = self._all_reduce(hist)
        bt_all = self._gather(bt_out).cpu().numpy()
        rd_all = self._gather(rd_out).cpu().numpy()

        # ---- candidates: counts, then rows padded to the largest -------
        counts = [read_header(h)[1] for h in self._gather(head).cpu().numpy()]
        K = max(counts, default=0)
        out: List[Optional[dict]] = [None] * len(launch)
        if K:
            packed = torch.zeros((m.n_local, K, accumulate.REC), dtype=i32,
                                 device=coll)
            for k, res in enumerate(results):
                n = counts[k0 + k]
                if n:
                    packed[k, :n] = result_rows(res, mine[k][1] - mine[k][0],
                                                n).to(coll)
            packed = self._gather(packed).cpu().numpy()
            for i, (t0, _) in enumerate(launch):
                if counts[i]:
                    out[i] = unpack_rows(packed[i, :counts[i]], t0)
        return bt_all, rd_all, hist.cpu().numpy().astype(np.int64), out


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
