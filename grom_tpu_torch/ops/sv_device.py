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

The entries travel as one int64 [9, n] tensor (``state.sv_entries``:
one pinned upload) and the scores as one packed uint8 buffer
(``unpack_scores``: binom, hez, kind, accept). ``SvScorer`` is a callable
for the ``scorer=`` seam of ``sv_screen.screen_window`` (numpy in, numpy
out), with its tables uploaded once and one copy each way a window.
``maybe_scorer`` is grom_tpu's engine policy: on for the ``torch`` and
``mesh`` engines, on for every engine, the host engine included, with
``GROM_TPU_DEVICE_SV=1``, off everywhere with ``GROM_TPU_DEVICE_SV=0``. The
scorer is always f64, so grom_tpu's x64 gate has no counterpart here. A
failed build or launch raises; nothing falls back to the host screen.

As in grom_tpu, the module imports no torch: each function imports it
where it runs, and ``maybe_scorer`` only past its gate, so a host-engine
run that leaves the scorer off loads no torch.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional

import numpy as np

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
    import torch
    if isinstance(b, int):
        if b == 0:
            return torch.zeros_like(a)
        return a.div(b, rounding_mode="floor")
    zero = b == 0
    q = a.div(torch.where(zero, 1, b), rounding_mode="floor")
    return torch.where(zero, 0, q)


def _ratio_gate(weak: torch.Tensor, strong: torch.Tensor) -> torch.Tensor:
    """(float)weak / (float)strong <= 0.25 in f32; NaN and inf are False."""
    import torch
    f32 = torch.float32
    return weak.to(f32) / strong.to(f32) <= 0.25


def score_bytes(n: int) -> int:
    """Bytes of the packed scores of n entries (``unpack_scores``)."""
    return 21 * n


def pack_scores(kind, accept, binom, hez) -> torch.Tensor:
    """The four score columns as one uint8 buffer: binom f64, hez f64,
    kind int32, accept bool, back to back (the kernel's layout)."""
    import torch
    u8 = torch.uint8
    return torch.cat([binom.view(u8), hez.view(u8), kind.view(u8),
                      accept.view(u8)])


def unpack_scores(buf: torch.Tensor, n: int):
    """(kind int32, accept bool, binom f64, hez f64), each [n], as views of
    a packed score buffer."""
    import torch
    return (buf[16 * n:20 * n].view(torch.int32),
            buf[20 * n:21 * n].view(torch.bool),
            buf[:8 * n].view(torch.float64),
            buf[8 * n:16 * n].view(torch.float64))


def score_sv_entries_plain(entries, tables: SvTables, p: SvParams):
    """The scorer in plain torch. ``entries`` int64 [9, n], one row per
    ``ENTRY_KEYS`` column. Returns the packed scores (``pack_scores``)."""
    import torch
    pos, etype, count, rs, re, rd, weak_f, weak_r, ctx_f_here = entries
    af, mt = p.af, p.mt
    kind = tables.kind[etype]
    rev = tables.rev[etype].to(torch.bool)
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
    return pack_scores(kind, accept, binom, hez)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("sv_score")
    P, I, Lg, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, \
        ctypes.c_double
    _build.bind(lib, "gt_sv_score",
                [P, Lg, P, P, Lg, Lg, P, P, I, I, Lg, Lg, Lg, D, Lg, Lg, P,
                 P])
    return lib


def _sv_score_cuda(entries, tables: SvTables, p: SvParams):
    import torch
    dev = entries.device
    if (entries.dtype != torch.int64 or entries.dim() != 2
            or entries.shape[0] != len(ENTRY_KEYS)
            or not entries.is_contiguous()):
        raise ValueError("sv_score entries must be one contiguous int64 "
                         "[%d, n] tensor (got %s %s)"
                         % (len(ENTRY_KEYS), entries.dtype,
                            tuple(entries.shape)))
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
    n = int(entries.shape[1])
    out = torch.empty(score_bytes(n), dtype=torch.uint8, device=dev)
    rows, cols = (int(s) for s in tables.mq.shape)
    _build.check(lib, lib.gt_sv_score(
        entries.data_ptr(), n, tables.mq.data_ptr(), tables.hez.data_ptr(),
        rows, cols, tables.kind.data_ptr(), tables.rev.data_ptr(),
        int(tables.kind.shape[0]), E_CTX_R, p.af, p.mt, p.md, float(p.thr1),
        p.mean, p.lseq, out.data_ptr(), _build.stream_ptr(dev)), "sv_score")
    _build.LAUNCHES["sv_score"] += 1
    return out


def sv_score(entries, tables: SvTables, p: SvParams):
    """Score one window's entries (int64 [9, n]) into the packed scores:
    the CUDA kernel for CUDA tensors, ``score_sv_entries_plain`` for CPU
    tensors."""
    import torch
    kind = entries.device.type
    if kind == "cuda":
        with torch.cuda.device(entries.device):
            return _sv_score_cuda(entries, tables, p)
    if kind == "cpu":
        return score_sv_entries_plain(entries, tables, p)
    raise ValueError("sv_score runs on cuda or cpu tensors, not %s" % kind)


class SvScorer:
    """Callable for ``sv_screen.screen_window``'s ``scorer``: the signature
    and dtypes of numpy's ``score_sv_entries`` partial, scored on
    ``device``. The tables are uploaded once; on a CUDA device the kernel
    library is built here, so a build failure raises at construction. A
    call packs the nine entry columns into one pinned buffer, uploads it
    in one copy, launches once and copies the packed scores back in one
    copy: one host sync a window."""

    def __init__(self, mq_tab: np.ndarray, hez_tab: np.ndarray, af: int,
                 mt: int, md: int, thr1: float, mean: int, lseq: int,
                 device):
        import torch

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
        entries = sv_entries((pos, etype, count, rs, re, rd, weak_f, weak_r,
                              ctx_f_here), self.device)
        scores = sv_score(entries, self.tables, self.params).cpu()
        return tuple(x.numpy() for x in unpack_scores(scores, n))


_CACHE: dict = {}


def maybe_scorer(engine: Optional[str], mq_tab: np.ndarray,
                 hez_tab: np.ndarray, cfg, drv, device) -> Optional[SvScorer]:
    """The scorer on ``device`` for the device engines ``torch`` and
    ``mesh``, and for any engine with GROM_TPU_DEVICE_SV=1; None for the
    host engine otherwise, and for every engine with GROM_TPU_DEVICE_SV=0.
    Memoized per parameter set and device, so the tables are uploaded once
    per process."""
    dc = os.environ.get("GROM_TPU_DEVICE_SV", "")
    if dc == "0":
        return None
    if dc != "1" and engine not in ("torch", "mesh"):
        return None
    import torch
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
