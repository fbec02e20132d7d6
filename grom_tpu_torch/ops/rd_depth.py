"""The caf_rd_* depth lists of the mesh engine's genome cells on the device
(the non-tile part of grom_tpu/parallel/pipeline.py's ``build_mesh_step``).

A run cuts [lo, hi) into cells of ``seg_l`` positions, ``n_launch`` cells a
launch; ``slot_of`` [n_launch] maps a launch's cells to this device's slots
(-1 where another device or process owns the cell). Two kernels turn the
run's spans into depth:

* ``rd_scatter`` (K5), once per group of launches [g0, g0 + ng): from the
  spans (``Spans``, uploaded once per run and device) it adds +w at each
  kept span's clipped start and -w at its clipped end (dropped at ``hi``)
  into three int32 delta rows per owned cell (rd_mq weighted by mapq, rd_hi
  and rd_lo by 1), and sums each cell's three totals and each
  ``CHUNK``-position chunk of its rows. The span rules are those of
  ``call/scan.py _accumulate_rd_lists``: an eligible read, the whole-span
  rule ref >= 0 and ref + len < L, clipped to [lo, hi);
* ``rd_scan`` (K6), once per cell: the depth is the carry before the
  launch, plus the totals of the launch's earlier cells, plus the inclusive
  prefix of the cell's rows; it adds the histogram of clip(rd_hi, 0, 255)
  over the first ``npos`` positions into the run's histogram and, for the
  launch's last cell on a device, stores the next launch's carry.

Both write into outputs the caller allocates once per run or group. Each
wrapper dispatches on the device of its inputs: CUDA tensors go to
``csrc/rd_depth.cu``, CPU tensors to the plain torch version beside it.
Everything is int32, as in grom_tpu's step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from grom_tpu_torch import _build

HIST_BINS = 256
CHUNK = 1024        # positions per chunk sum of rd_scatter, per block of rd_scan


class Spans(NamedTuple):
    """A run's M-spans and reads on one device (views of one upload)."""
    ref: torch.Tensor       # int32 [S] reference start
    len: torch.Tensor       # int32 [S]
    read: torch.Tensor      # int32 [S] read index
    mapq: torch.Tensor      # uint8 [R]
    elig: torch.Tensor      # uint8 [R] 1: the read adds depth


SPAN_DTYPES = dict(ref=torch.int32, len=torch.int32, read=torch.int32,
                   mapq=torch.uint8, elig=torch.uint8)


def n_chunks(seg_l: int) -> int:
    return -(-seg_l // CHUNK)


def scatter_outputs(cells: int, seg_l: int, device
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Uninitialised ``rd_scatter`` outputs for ``cells`` slots: rows int32
    [cells, 3, seg_l], totals [cells, 3], chunk sums [cells, 3, nchunk]."""
    i32 = torch.int32
    return (torch.empty((cells, 3, seg_l), dtype=i32, device=device),
            torch.empty((cells, 3), dtype=i32, device=device),
            torch.empty((cells, 3, n_chunks(seg_l)), dtype=i32,
                        device=device))


def endpoints_plain(spans: Spans, lo: int, hi: int, L: int, min_mapq: int):
    """The kept endpoints of the spans in plain torch: (pos int64, sign
    int32 +1 start / -1 end, w_mq int32, w_hi int32), the ends at ``hi``
    dropped."""
    rid = spans.read.to(torch.int64)
    ref = spans.ref.to(torch.int64)
    end = ref + spans.len.to(torch.int64)
    s = ref.clamp(min=lo)
    e = end.clamp(max=hi)
    ok = (spans.elig[rid] != 0) & (ref >= 0) & (end < L) & (e > s)
    w = spans.mapq[rid].to(torch.int32)
    wh = (w >= min_mapq).to(torch.int32)
    ke = ok & (e < hi)
    starts, ends = s[ok], e[ke]
    sign = torch.cat([torch.ones_like(starts), -torch.ones_like(ends)])
    return (torch.cat([starts, ends]), sign.to(torch.int32),
            torch.cat([w[ok], w[ke]]), torch.cat([wh[ok], wh[ke]]))


def rd_scatter_plain(spans: Spans, slot_of, lo: int, hi: int, L: int,
                     min_mapq: int, seg_l: int, g0: int, ng: int, rows, tot,
                     csum) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``rd_scatter`` in plain torch: fills ``rows`` [ng * n_dev, 3, seg_l],
    ``tot`` [ng * n_dev, 3] and ``csum`` [ng * n_dev, 3, nchunk] (int32)
    and returns them."""
    i32, i64 = torch.int32, torch.int64
    n_launch = int(slot_of.shape[0])
    n_dev = int(rows.shape[0]) // ng if ng else 0
    nchunk = n_chunks(seg_l)
    pos, sign, w, wh = endpoints_plain(spans, lo, hi, L, min_mapq)
    c = (pos - lo) // seg_l
    r = c // n_launch
    sl = slot_of.to(i64)[c - r * n_launch]
    keep = (r >= g0) & (r < g0 + ng) & (sl >= 0)
    slot = ((r - g0) * n_dev + sl)[keep]
    off = (pos - lo - c * seg_l)[keep]
    sign = sign[keep]
    rows.zero_()
    tot.zero_()
    csum.zero_()
    for ch, wt in enumerate((w[keep], wh[keep], 1 - wh[keep])):
        val = (sign * wt).to(i32)
        rows.view(-1).index_add_(0, (slot * 3 + ch) * seg_l + off, val)
        tot.view(-1).index_add_(0, slot * 3 + ch, val)
        csum.view(-1).index_add_(0, (slot * 3 + ch) * nchunk + off // CHUNK,
                                 val)
    return rows, tot, csum


def rd_scan_plain(rows, csum, tot_all, j: int, carry_in, npos: int, rd, hist,
                  carry_out=None):
    """``rd_scan`` in plain torch: rd [3, n] = carry_in + the totals of
    cells [0, j) of ``tot_all`` + the inclusive prefix of ``rows``; adds
    the bins of clip(rd_hi[:npos], 0, 255) to ``hist``; stores carry_in +
    every total of ``tot_all`` into ``carry_out`` when given. (``csum`` is
    what the kernel reads instead of the prefix of earlier chunks.) Returns
    (rd, hist) or (rd, hist, carry_out)."""
    i32 = torch.int32
    base = carry_in + tot_all[:j].sum(0, dtype=i32)
    rd.copy_(torch.cumsum(rows, 1, dtype=i32) + base[:, None])
    bins = rd[1, :npos].clamp(0, HIST_BINS - 1).to(torch.int64)
    hist += torch.bincount(bins, minlength=HIST_BINS).to(i32)
    if carry_out is None:
        return rd, hist
    carry_out.copy_(carry_in + tot_all.sum(0, dtype=i32))
    return rd, hist, carry_out


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rd_depth")
    P, Lg, I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
    _build.bind(lib, "gt_rd_scatter", [P] * 6 + [Lg] * 4 + [I, Lg, I, I, Lg,
                                                           Lg, P, P, P, P])
    _build.bind(lib, "gt_rd_scan", [P, P, P, I, I, P, P, Lg, Lg, P, P, P])
    return lib


def _require(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if (x.dtype != dtype or x.device != device or not x.is_contiguous()
            or tuple(x.shape) != tuple(shape)):
        raise ValueError("%s must be a contiguous %s %s tensor on %s (got "
                         "%s %s on %s)" % (name, dtype, list(shape), device,
                                           x.dtype, list(x.shape), x.device))


def _dispatch(x: torch.Tensor, name: str) -> str:
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError("%s runs on cuda or cpu tensors, not %s"
                         % (name, kind))
    return kind


def _rd_scatter_cuda(spans, slot_of, lo, hi, L, min_mapq, seg_l, g0, ng,
                     rows, tot, csum):
    dev = spans.ref.device
    S = int(spans.ref.shape[0])
    R = int(spans.mapq.shape[0])
    for name in ("ref", "len", "read"):
        _require(name, getattr(spans, name), torch.int32, (S,), dev)
    for name in ("mapq", "elig"):
        _require(name, getattr(spans, name), torch.uint8, (R,), dev)
    n_launch = int(slot_of.shape[0])
    _require("slot_of", slot_of, torch.int32, (n_launch,), dev)
    cells = int(rows.shape[0])
    if ng < 1 or cells % ng:
        raise ValueError("%d slots do not split into %d launches"
                         % (cells, ng))
    _require("rows", rows, torch.int32, (cells, 3, seg_l), dev)
    _require("tot", tot, torch.int32, (cells, 3), dev)
    _require("csum", csum, torch.int32, (cells, 3, n_chunks(seg_l)), dev)
    if L >= 1 << 31:
        raise ValueError("a chromosome of %d bases is beyond int32" % L)
    lib = _lib()
    _build.check(lib, lib.gt_rd_scatter(
        spans.ref.data_ptr(), spans.len.data_ptr(), spans.read.data_ptr(),
        spans.mapq.data_ptr(), spans.elig.data_ptr(), slot_of.data_ptr(), S,
        lo, hi, L, min_mapq, seg_l, n_launch, cells // ng, g0, ng,
        rows.data_ptr(), tot.data_ptr(), csum.data_ptr(),
        _build.stream_ptr(dev)), "rd_scatter")
    # without spans or slots gt_rd_scatter only clears the outputs
    if S and cells:
        _build.LAUNCHES["rd_scatter"] += 1
    return rows, tot, csum


def rd_scatter(spans: Spans, slot_of, lo: int, hi: int, L: int,
               min_mapq: int, seg_l: int, g0: int, ng: int, rows, tot, csum
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The delta rows, cell totals and chunk sums of this device's cells of
    launches [g0, g0 + ng), written into (and returned as) ``rows``,
    ``tot`` and ``csum`` (``scatter_outputs``): the CUDA kernel for CUDA
    tensors, ``rd_scatter_plain`` for CPU tensors."""
    if _dispatch(spans.ref, "rd_scatter") == "cuda":
        with torch.cuda.device(spans.ref.device):
            return _rd_scatter_cuda(spans, slot_of, lo, hi, L, min_mapq,
                                    seg_l, g0, ng, rows, tot, csum)
    return rd_scatter_plain(spans, slot_of, lo, hi, L, min_mapq, seg_l, g0,
                            ng, rows, tot, csum)


def _rd_scan_cuda(rows, csum, tot_all, j, carry_in, npos, rd, hist,
                  carry_out):
    dev = rows.device
    n = int(rows.shape[1]) if rows.dim() == 2 else -1
    n_launch = int(tot_all.shape[0])
    i32 = torch.int32
    _require("rows", rows, i32, (3, n), dev)
    _require("csum", csum, i32, (3, n_chunks(n)), dev)
    _require("tot_all", tot_all, i32, (n_launch, 3), dev)
    _require("carry_in", carry_in, i32, (3,), dev)
    _require("rd", rd, i32, (3, n), dev)
    _require("hist", hist, i32, (HIST_BINS,), dev)
    if carry_out is not None:
        _require("carry_out", carry_out, i32, (3,), dev)
    if not 0 <= npos <= n or not 0 <= j < n_launch:
        raise ValueError("npos %d outside [0, %d] or cell %d outside [0, %d)"
                         % (npos, n, j, n_launch))
    lib = _lib()
    _build.check(lib, lib.gt_rd_scan(
        rows.data_ptr(), csum.data_ptr(), tot_all.data_ptr(), j, n_launch,
        carry_in.data_ptr(),
        None if carry_out is None else carry_out.data_ptr(), n, npos,
        rd.data_ptr(), hist.data_ptr(), _build.stream_ptr(dev)), "rd_scan")
    if n:           # gt_rd_scan launches nothing for an empty cell
        _build.LAUNCHES["rd_scan"] += 1
    return (rd, hist) if carry_out is None else (rd, hist, carry_out)


def rd_scan(rows, csum, tot_all, j: int, carry_in, npos: int, rd, hist,
            carry_out: Optional[torch.Tensor] = None):
    """Cell ``j``'s depth lists into ``rd`` and its histogram added to
    ``hist``, from its delta rows and chunk sums, the launch's cell totals
    and the carry (and the next carry into ``carry_out`` when given): the
    CUDA kernel for CUDA tensors, ``rd_scan_plain`` for CPU tensors."""
    if _dispatch(rows, "rd_scan") == "cuda":
        with torch.cuda.device(rows.device):
            return _rd_scan_cuda(rows, csum, tot_all, j, carry_in, npos, rd,
                                 hist, carry_out)
    return rd_scan_plain(rows, csum, tot_all, j, carry_in, npos, rd, hist,
                         carry_out)
