"""The caf_rd_* depth lists of one genome cell on the device (the non-tile
part of grom_tpu/parallel/pipeline.py's ``build_mesh_step``).

A cell of ``n`` positions holds the endpoint deltas of every span it owns
(+w at the clipped start, -w at the clipped end). Two kernels turn them into
depth:

* ``rd_scatter`` (K5) adds the deltas into three int32 rows [3, n]
  (rd_mq weighted by mapq, rd_hi and rd_lo by 1) and returns the cell's
  three delta totals, which the mesh exchanges among cells for the carry;
* ``rd_scan`` (K6) turns the rows into depth: an inclusive scan plus the
  cell's carried base, and the 256-bin histogram of clip(rd_hi, 0, 255)
  over the first ``npos`` positions.

Each wrapper dispatches on the device of its inputs: CUDA tensors go to
``csrc/rd_depth.cu``, CPU tensors to the plain torch version beside it.
Everything is int32, as in grom_tpu's step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from grom_tpu_torch import _build

HIST_BINS = 256
_CHUNK = 1024       # positions per scan block of rd_scan


def rd_scatter_plain(pos, w_mq, w_hi, w_lo, n: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(delta int32 [3, n], tot int32 [3]) in plain torch. ``pos`` int32
    [D] cell-relative positions in [0, n), ``w_mq`` int32, ``w_hi`` and
    ``w_lo`` int8 [D]."""
    i32 = torch.int32
    idx = pos.to(torch.int64)
    delta = torch.zeros((3, n), dtype=i32, device=pos.device)
    for c, w in enumerate((w_mq, w_hi, w_lo)):
        delta[c].index_add_(0, idx, w.to(i32))
    return delta, delta.sum(1, dtype=i32)


def rd_scan_plain(delta, base, npos: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rd int32 [3, n], hist int32 [256]) in plain torch: rd is ``base``
    (int32 [3]) plus the inclusive prefix of ``delta``; hist bins
    clip(rd_hi[:npos], 0, 255)."""
    i32 = torch.int32
    rd = torch.cumsum(delta, 1, dtype=i32) + base.to(i32)[:, None]
    bins = rd[1, :npos].clamp(0, HIST_BINS - 1).to(torch.int64)
    hist = torch.bincount(bins, minlength=HIST_BINS).to(i32)
    return rd, hist


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("rd_depth")
    P, Lg = ctypes.c_void_p, ctypes.c_long
    _build.bind(lib, "gt_rd_scatter", [P] * 4 + [Lg, Lg, P, P, P])
    _build.bind(lib, "gt_rd_scan", [P, P, Lg, Lg, P, P, P, P, P])
    return lib


def _require(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if (x.dtype != dtype or x.device != device or not x.is_contiguous()
            or tuple(x.shape) != shape):
        raise ValueError("%s must be a contiguous %s %s tensor on %s (got "
                         "%s %s on %s)" % (name, dtype, list(shape), device,
                                           x.dtype, list(x.shape), x.device))


def _dispatch(x: torch.Tensor, name: str) -> str:
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError("%s runs on cuda or cpu tensors, not %s"
                         % (name, kind))
    return kind


def _rd_scatter_cuda(pos, w_mq, w_hi, w_lo, n: int):
    dev = pos.device
    D = int(pos.shape[0])
    for name, x, dt in (("pos", pos, torch.int32),
                        ("w_mq", w_mq, torch.int32),
                        ("w_hi", w_hi, torch.int8),
                        ("w_lo", w_lo, torch.int8)):
        _require(name, x, dt, (D,), dev)
    lib = _lib()
    delta = torch.empty((3, n), dtype=torch.int32, device=dev)
    tot = torch.empty(3, dtype=torch.int32, device=dev)
    _build.check(lib, lib.gt_rd_scatter(
        pos.data_ptr(), w_mq.data_ptr(), w_hi.data_ptr(), w_lo.data_ptr(), D,
        n, delta.data_ptr(), tot.data_ptr(), _build.stream_ptr(dev)),
        "rd_scatter")
    _build.LAUNCHES["rd_scatter"] += 1
    return delta, tot


def rd_scatter(pos, w_mq, w_hi, w_lo, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell's endpoint deltas into (delta rows, totals): the CUDA kernel
    for CUDA tensors, ``rd_scatter_plain`` for CPU tensors."""
    if _dispatch(pos, "rd_scatter") == "cuda":
        with torch.cuda.device(pos.device):
            return _rd_scatter_cuda(pos, w_mq, w_hi, w_lo, n)
    return rd_scatter_plain(pos, w_mq, w_hi, w_lo, n)


def _rd_scan_cuda(delta, base, npos: int):
    dev = delta.device
    n = int(delta.shape[1]) if delta.dim() == 2 else -1
    _require("delta", delta, torch.int32, (3, n), dev)
    _require("base", base, torch.int32, (3,), dev)
    if not 0 <= npos <= n:
        raise ValueError("npos %d outside [0, %d]" % (npos, n))
    lib = _lib()
    nblk = max((n + _CHUNK - 1) // _CHUNK, 1)
    scratch = torch.empty((2, 3, nblk), dtype=torch.int32, device=dev)
    rd = torch.empty((3, n), dtype=torch.int32, device=dev)
    hist = torch.empty(HIST_BINS, dtype=torch.int32, device=dev)
    _build.check(lib, lib.gt_rd_scan(
        delta.data_ptr(), base.data_ptr(), n, npos, scratch[0].data_ptr(),
        scratch[1].data_ptr(), rd.data_ptr(), hist.data_ptr(),
        _build.stream_ptr(dev)), "rd_scan")
    _build.LAUNCHES["rd_scan"] += 1
    return rd, hist


def rd_scan(delta, base, npos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell's depth lists and histogram from its delta rows and carried
    base: the CUDA kernel for CUDA tensors, ``rd_scan_plain`` for CPU
    tensors."""
    if _dispatch(delta, "rd_scan") == "cuda":
        with torch.cuda.device(delta.device):
            return _rd_scan_cuda(delta, base, npos)
    return rd_scan_plain(delta, base, npos)
