"""The SV evidence-entry scorer on the device (the counterpart of
grom_tpu/ops/sv_device.py).

``sv_score`` scores one detect window's typed-evidence entries: action
kind, the min-disc and insert-geometry gates, the binomial-table gather
(scaled-trials branch when rd > max_trials), the f32 evidence-ratio gate
and the hez gather. It dispatches on the device of its inputs: CUDA
tensors go to the kernel in ``csrc/sv_score.cu``, CPU tensors to
``score_sv_entries_plain``. Both equal numpy's
``call/sv_screen.py score_sv_entries`` bit for bit in every output
and dtype: the H100 has native f64, so the tables stay f64.

``SvScorer`` is a callable for the ``scorer=`` seam of
``sv_screen.screen_window`` (numpy in, numpy out), with its tables
uploaded once. ``maybe_scorer`` is the engine policy: on for the ``torch``
and ``mesh`` engines, off with ``GROM_TPU_DEVICE_SV=0``. A failed build or
launch raises; nothing falls back to the host screen.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from grom_tpu_torch.call.deposits import E_CTX_R
from grom_tpu_torch.call.sv_screen import _ETYPE_KIND
from grom_tpu_torch import _build

ENTRY_KEYS = ("pos", "etype", "count", "rs", "re", "rd", "weak_f", "weak_r",
              "ctx_f_here")


class SvTables(NamedTuple):
    """The scorer's tables on one device: ``mq``/``hez`` f64 [rows, cols]
    (the binomial tables), ``kind``/``rev`` int32 (sv_screen's etype index
    tables)."""
    mq: torch.Tensor
    hez: torch.Tensor
    kind: torch.Tensor
    rev: torch.Tensor


class SvParams(NamedTuple):
    af: int
    mt: int
    md: int
    thr1: float
    mean: int
    lseq: int


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    """numpy's integer ``a // b``: floors, and gives 0 where b == 0."""
    if isinstance(b, int):
        if b == 0:
            return torch.zeros_like(a)
        return a.div(b, rounding_mode="floor")
    zero = b == 0
    q = a.div(torch.where(zero, 1, b), rounding_mode="floor")
    return torch.where(zero, 0, q)


def _ratio_gate(weak: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """(float)weak / (float)strong <= 0.25 in f32; NaN and inf are False."""
    f32 = torch.float32
    return weak.to(f32) / strong.to(f32) <= 0.25


def score_sv_entries_plain(pos, etype, count, rs, re, rd, weak_f, weak_r,
                           ctx_f_here, tables: SvTables, p: SvParams):
    """The scorer in plain torch. Entries int64 [n] (``etype`` int32).
    Returns (kind int32, accept bool, binom f64, hez f64)."""
    af, mt = p.af, p.mt
    et = etype.to(torch.int64)
    kind = tables.kind[et]
    rev = tables.rev[et].to(torch.bool)
    md_ok = _floordiv(count, af) >= p.md
    geom_ok = torch.where(rev, rs + p.lseq - pos < p.mean,
                          pos - re < p.mean)
    weak = torch.where(rev, weak_r, weak_f)
    strong = count

    # binom_pair_vec, shared by the plain and the ctx_r gate variants
    big = rd > mt
    den = af * rd.clamp(min=1)
    row = torch.where(big, mt, rd)
    col = torch.where(big, _floordiv(strong * mt, den).clamp(max=mt),
                      _floordiv(strong, af).clamp(max=mt))
    binom = tables.mq[row, col]
    k2 = _floordiv(strong + weak, af)
    k2_lt = k2 < rd
    k2i = _floordiv((strong + weak) * mt, den).clamp(max=mt)
    hez_col = torch.where(big, torch.where(k2_lt, k2i, mt),
                          torch.where(k2_lt, k2, rd))
    hez_val = tables.hez[row, hez_col]
    gate = _ratio_gate(weak, strong)
    gate_ctx_r = _ratio_gate(torch.where(big, weak, weak_f),
                             torch.where(big, strong, ctx_f_here))
    gate = torch.where(etype == E_CTX_R, gate_ctx_r, gate)
    hez = torch.where(gate, hez_val, 2.0)

    accept = md_ok & geom_ok & (rd > 0) & (binom <= p.thr1)
    return kind, accept, binom, hez


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("sv_score")
    P, I, Lg, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, \
        ctypes.c_double
    _build.bind(lib, "gt_sv_score",
                [P] * 11 + [Lg, Lg, P, P, I, I, Lg, Lg, Lg, Lg, D, Lg, Lg]
                + [P] * 5)
    return lib


def _sv_score_cuda(pos, etype, count, rs, re, rd, weak_f, weak_r, ctx_f_here,
                   tables: SvTables, p: SvParams):
    dev = pos.device
    ins = (pos, etype, count, rs, re, rd, weak_f, weak_r, ctx_f_here)
    n = int(pos.shape[0])
    for name, x in zip(ENTRY_KEYS, ins):
        want = torch.int32 if name == "etype" else torch.int64
        if (x.dtype != want or x.device != dev or not x.is_contiguous()
                or x.shape != (n,)):
            raise ValueError("sv_score input %s must be a contiguous %s [%d] "
                             "tensor on %s (got %s %s on %s)"
                             % (name, want, n, dev, x.dtype, tuple(x.shape),
                                x.device))
    for name, x, want in (("mq", tables.mq, torch.float64),
                          ("hez", tables.hez, torch.float64),
                          ("kind", tables.kind, torch.int32),
                          ("rev", tables.rev, torch.int32)):
        if x.dtype != want or x.device != dev or not x.is_contiguous():
            raise ValueError("sv_score table %s must be a contiguous %s "
                             "tensor on %s" % (name, want, dev))
    if tables.mq.shape != tables.hez.shape:
        raise ValueError("the mq and hez tables differ in shape")
    lib = _lib()
    kind = torch.empty(n, dtype=torch.int32, device=dev)
    accept = torch.empty(n, dtype=torch.bool, device=dev)
    binom = torch.empty(n, dtype=torch.float64, device=dev)
    hez = torch.empty(n, dtype=torch.float64, device=dev)
    rows, cols = (int(s) for s in tables.mq.shape)
    _build.check(lib, lib.gt_sv_score(
        *(x.data_ptr() for x in ins), tables.mq.data_ptr(),
        tables.hez.data_ptr(), rows, cols, tables.kind.data_ptr(),
        tables.rev.data_ptr(), int(tables.kind.shape[0]), E_CTX_R, n,
        p.af, p.mt, p.md, float(p.thr1), p.mean, p.lseq, kind.data_ptr(),
        accept.data_ptr(), binom.data_ptr(), hez.data_ptr(),
        _build.stream_ptr(dev)), "sv_score")
    _build.LAUNCHES["sv_score"] += 1
    return kind, accept, binom, hez


def sv_score(pos, etype, count, rs, re, rd, weak_f, weak_r, ctx_f_here,
             tables: SvTables, p: SvParams):
    """Score one window's entries: the CUDA kernel for CUDA tensors,
    ``score_sv_entries_plain`` for CPU tensors."""
    kind = pos.device.type
    if kind == "cuda":
        with torch.cuda.device(pos.device):
            return _sv_score_cuda(pos, etype, count, rs, re, rd, weak_f,
                                  weak_r, ctx_f_here, tables, p)
    if kind == "cpu":
        return score_sv_entries_plain(pos, etype, count, rs, re, rd, weak_f,
                                      weak_r, ctx_f_here, tables, p)
    raise ValueError("sv_score runs on cuda or cpu tensors, not %s" % kind)


class SvScorer:
    """Callable for ``sv_screen.screen_window``'s ``scorer``: the signature
    and dtypes of numpy's ``score_sv_entries`` partial, scored on
    ``device``. The tables are uploaded once; on a CUDA device the kernel
    library is built here, so a build failure raises at construction."""

    def __init__(self, mq_tab: np.ndarray, hez_tab: np.ndarray, af: int,
                 mt: int, md: int, thr1: float, mean: int, lseq: int,
                 device):
        from grom_tpu_torch.ops.state import sv_tables
        self.device = torch.device(device)
        if self.device.type == "cuda":
            _lib()
        self.tables = sv_tables(mq_tab, hez_tab, self.device)
        self.params = SvParams(int(af), int(mt), int(md), float(thr1),
                               int(mean), int(lseq))

    def __call__(self, pos, etype, count, rs, re, rd, weak_f, weak_r,
                 ctx_f_here):
        n = len(pos)
        if n == 0:
            return (np.empty(0, np.int32), np.empty(0, bool),
                    np.empty(0), np.empty(0))
        n_et = len(_ETYPE_KIND)
        if etype.min() < -n_et or etype.max() >= n_et:
            raise IndexError("etype out of range [%d, %d)" % (-n_et, n_et))
        from grom_tpu_torch.ops.state import sv_entries
        args = sv_entries((pos, etype, count, rs, re, rd, weak_f, weak_r,
                           ctx_f_here), self.device)
        out = sv_score(*args, self.tables, self.params)
        return tuple(o.cpu().numpy() for o in out)


_CACHE: dict = {}


def maybe_scorer(engine: Optional[str], mq_tab: np.ndarray,
                 hez_tab: np.ndarray, cfg, drv, device) -> Optional[SvScorer]:
    """The scorer for the device engines ``torch`` and ``mesh`` (None for
    the host engine, or with GROM_TPU_DEVICE_SV=0). Memoized per parameter
    set and device, so the tables are uploaded once per process."""
    if os.environ.get("GROM_TPU_DEVICE_SV", "") == "0":
        return None
    if engine not in ("torch", "mesh"):
        return None
    dev = torch.device(device)
    key = (cfg.add_factor, cfg.max_trials, cfg.min_disc,
           cfg.pval_threshold1, drv.insert_mean, drv.read_len, str(dev))
    hit = _CACHE.get(key)
    # held table references make the identity check safe against id reuse
    if hit is not None and hit[0] is mq_tab and hit[1] is hez_tab:
        return hit[2]
    sc = SvScorer(mq_tab, hez_tab, cfg.add_factor, cfg.max_trials,
                  cfg.min_disc, cfg.pval_threshold1, drv.insert_mean,
                  drv.read_len, dev)
    _CACHE.clear()
    _CACHE[key] = (mq_tab, hez_tab, sc)
    return sc
