"""The host engine's numpy state as the port's device tensors.

The port's stages and its tests (which also feed grom_tpu's JAX functions
the same values) go through these converters:

* ``tile_from_args``: a tile's padded argument tuple, as
  ``__graft_entry__.tile_args_from_fixture`` builds it for
  ``tile_kernel_core``, with the pads stripped to runtime sizes and
  packed into one buffer as ``tile_inputs`` packs a tile, its gate
  uploaded apart as ``tile_gate`` uploads a range's;
* ``cnv_tables``: the count tables of the CNV bin rows, ``ave``, ``std``
  and the pval2sd table, checked for the order and range they need, in one
  upload; ``z_inputs``: the z stage's per-base inputs, in blocks through
  one staging buffer;
* ``span_inputs``: a run's M-spans and reads as ``rd_scatter`` inputs, in
  blocks through two staging buffers on a copy stream;
* ``cell_deltas``: one mesh cell's slice of the rd endpoint deltas
  (parallel/pipeline.py ``endpoint_deltas``), cell-relative: the host
  reference that the tests hold ``rd_scatter`` to;
* ``sv_tables`` / ``sv_entries``: the SV scorer's binomial tables and etype
  index tables, and one window's entry arrays in one int64 [9, n] upload,
  for ``sv_score``;
* ``DepthLists``: a chromosome's caf_rd_* depth lists on a device engine's
  device through the scan stage, handed to the host once it ends;
* ``to_device``: any numpy array as a contiguous tensor on a device.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Tuple

import numpy as np
import torch

from grom_tpu_torch.ops.accumulate import (TileInputs, pack_arrays,
                                            pack_offsets, pack_tile,
                                            screen_threshold, tile_gate,
                                            to_device)
from grom_tpu_torch.ops.cnv_device import (COUNT_CAP, TABLE_DTYPES,
                                            ZIN_DTYPES, CnvTables, ZInputs,
                                            count_tables)
from grom_tpu_torch.ops.rd_depth import SPAN_DTYPES, Spans
from grom_tpu_torch.ops.sv_device import ENTRY_KEYS, SvTables


def tile_from_args(args: tuple, statics: dict, device
                   ) -> Tuple[TileInputs, dict]:
    """(TileInputs, kernel params) from a padded ``tile_kernel_core``
    argument tuple and its static kwargs; the params hold the tile's
    ``gate`` (on ``device``) beside the scalars, so
    ``tile_kernel(t, **params)`` runs the tile."""
    (span_read, span_ref, span_off, cum, elig, mapq, flag, lseq, seq_off,
     seq, qual, name_id, name_len, chrom_up, is_n, gate, min_ratio,
     n_span) = args
    S = int(n_span)
    R = int(span_read[:S].max()) + 1 if S else 0
    # the tile width is where the appended 0 byte of chrom_up sits
    L = int(np.argmax(chrom_up == 0))
    Q = int(min(len(seq), (seq_off[:R].astype(np.int64)
                           + lseq[:R].astype(np.int64)).max())) if R else 0
    t = pack_tile(dict(
        span_read=span_read[:S], span_ref=span_ref[:S], span_off=span_off[:S],
        cum=cum[:S + 1], elig=elig[:R], mapq=mapq[:R], flag=flag[:R],
        lseq=lseq[:R], seq_off=seq_off[:R], name_id=name_id[:R],
        name_len=name_len[:R], seq=seq[:Q], qual=qual[:Q],
        chrom_up=chrom_up[:L], is_n=is_n[:L]), device)
    params = dict(gate=tile_gate(gate[:L], device),
                  thr=screen_threshold(float(min_ratio)),
                  min_mapq=statics["min_mapq"], min_bq=statics["min_bq"],
                  min_snv=statics["min_snv"],
                  name_len_cap=statics["name_len_cap"])
    return t, params


def cnv_tables(arrs, ave: np.ndarray, std: np.ndarray, pv_p: np.ndarray,
               pv_sd: np.ndarray, device, cap: int = COUNT_CAP) -> CnvTables:
    """The z stage's tables on ``device`` in one upload: the count tables
    of the 2 nb bin rows ``arrs`` (hi-mapq rows, then lo-mapq rows; each
    capped at ``cap`` entries), the bin means and stdevs and the pval2sd
    table. Raises unless every row is sorted ascending and non-negative
    (the counts cover keys from 0) and pv_p is non-decreasing (the
    kernel bisects it)."""
    for k, row in enumerate(arrs):
        row = np.asarray(row)
        if len(row) > 1 and np.any(row[1:] < row[:-1]):
            raise ValueError("bin row %d is not sorted ascending" % k)
        if len(row) and row[0] < 0:
            raise ValueError("bin row %d holds a negative depth" % k)
    if len(pv_p) > 1 and np.any(pv_p[1:] < pv_p[:-1]):
        raise ValueError("pval2sd probabilities are not non-decreasing")
    return CnvTables(**pack_arrays(dict(
        count_tables(arrs, cap), ave=np.reshape(ave, -1),
        std=np.reshape(std, -1), pv_p=pv_p, pv_sd=pv_sd), TABLE_DTYPES,
        device))


# positions a block of the z stage's upload carries: its pinned staging
# buffer is 8 bytes a position (32 MiB), whatever the chromosome's length
Z_UPLOAD_BLOCK = 1 << 22


def z_inputs(depth, mq, gc, low_acgt, lo: int, hi: int, device) -> ZInputs:
    """The z stage's per-base inputs over [lo, hi) on ``device``: views of
    one buffer laid out as ``pack_arrays`` lays it out, filled
    ``Z_UPLOAD_BLOCK`` positions at a time through one staging buffer
    (pinned on a CUDA device), so no host buffer of the whole range is
    made. The staging buffer is refilled once the copies out of it have
    finished; the last block's copies are not waited for."""
    dev = torch.device(device)
    n = hi - lo
    arrays = dict(depth=depth, mq=mq, gc=gc, low_acgt=low_acgt)
    offs, total = {}, 0
    for name, dt in ZIN_DTYPES.items():
        offs[name] = total
        total += -(-n * dt.itemsize // 16) * 16
    buf = torch.empty(max(total, 16), dtype=torch.uint8, device=dev)
    views = {name: buf[off:off + n * ZIN_DTYPES[name].itemsize].view(
        ZIN_DTYPES[name]) for name, off in offs.items()}
    B = max(min(Z_UPLOAD_BLOCK, n), 1)
    cuda = dev.type == "cuda"
    stage = torch.empty(B * sum(dt.itemsize for dt in ZIN_DTYPES.values()),
                        dtype=torch.uint8, pin_memory=cuda)
    sb = stage.numpy()
    copied = None
    with torch.cuda.device(dev) if cuda else contextlib.nullcontext():
        for b0 in range(0, n, B):
            k = min(B, n - b0)
            if copied is not None:
                copied.synchronize()
            off = 0
            for name, dt in ZIN_DTYPES.items():
                np_dt = np.dtype(str(dt).replace("torch.", ""))
                sb[off:off + k * dt.itemsize].view(np_dt)[:] = \
                    arrays[name][lo + b0:lo + b0 + k]
                views[name][b0:b0 + k].copy_(
                    stage[off:off + k * dt.itemsize].view(dt),
                    non_blocking=True)
                off += B * dt.itemsize
            if cuda:
                copied = torch.cuda.Event()
                copied.record()
    return ZInputs(**views)


# bytes a block of ``span_inputs``'s upload carries: it goes through two
# pinned staging buffers of this size, whatever the number of spans
SPAN_UPLOAD_BLOCK = 4 << 20


@functools.lru_cache(maxsize=None)
def _copy_stream(index: int) -> "torch.cuda.Stream":
    """A stream of card ``index`` for uploads that must not queue behind
    the kernels already enqueued on its current stream."""
    return torch.cuda.Stream(device=index)


def span_inputs(batch, eligible: np.ndarray, device) -> Spans:
    """The batch's M-spans (start, length, read) and its reads' mapq and
    eligibility as ``rd_scatter`` inputs on ``device``: views of one buffer
    laid out as ``pack_arrays`` lays it out. On a CUDA device the buffer is
    allocated on a copy stream of its own and filled there
    ``SPAN_UPLOAD_BLOCK`` bytes at a time through two pinned staging
    buffers; the current stream waits for that stream. So the upload
    neither waits on the host for the kernels queued before it (a
    staging buffer is refilled once the copy out of it has finished, and
    the copy stream holds only copies) nor leaves a pinned block of the
    whole upload (an ingest chunk's spans, 64 MiB at 30x) that torch's
    caching host allocator would keep, resident, through the scan."""
    arrays = dict(ref=batch.span_ref, len=batch.span_len,
                  read=batch.span_read, mapq=batch.mapq, elig=eligible)
    dev = torch.device(device)
    if dev.type != "cuda":
        return Spans(**pack_arrays(arrays, SPAN_DTYPES, dev))
    offs, total = pack_offsets(arrays, SPAN_DTYPES)
    with torch.cuda.device(dev):
        side = _copy_stream(torch.cuda.current_device())
        with torch.cuda.stream(side):
            buf = torch.empty(total, dtype=torch.uint8, device=dev)
            stages = [torch.empty(SPAN_UPLOAD_BLOCK, dtype=torch.uint8,
                                  pin_memory=True) for _ in range(2)]
            copied = [None, None]
            i = 0
            for name, off, n in offs:
                dt = SPAN_DTYPES[name]
                np_dt = np.dtype(str(dt).replace("torch.", ""))
                step = SPAN_UPLOAD_BLOCK // dt.itemsize
                a = arrays[name]
                for e0 in range(0, len(a), step):
                    k = min(step, len(a) - e0) * dt.itemsize
                    if copied[i] is not None:
                        copied[i].synchronize()
                    stages[i].numpy()[:k].view(np_dt)[:] = a[e0:e0 + step]
                    buf[off + e0 * dt.itemsize:off + e0 * dt.itemsize + k] \
                        .copy_(stages[i][:k], non_blocking=True)
                    copied[i] = torch.cuda.Event()
                    copied[i].record(side)
                    i ^= 1
        main = torch.cuda.current_stream()
        main.wait_stream(side)
        buf.record_stream(main)
    return Spans(**{name: buf[off:off + n].view(SPAN_DTYPES[name])
                    for name, off, n in offs})


def cell_deltas(d_pos: np.ndarray, d_mq: np.ndarray, d_hi: np.ndarray,
                d_lo: np.ndarray, t0: int, t1: int, device):
    """The deltas a cell [t0, t1) owns (``d_pos`` sorted) as ``rd_scatter``
    inputs: (pos int32 cell-relative, w_mq int32, w_hi int8, w_lo int8)."""
    a = int(np.searchsorted(d_pos, t0, side="left"))
    b = int(np.searchsorted(d_pos, t1, side="left"))
    return (to_device(d_pos[a:b] - t0, np.int32, device),
            to_device(d_mq[a:b], np.int32, device),
            to_device(d_hi[a:b], np.int8, device),
            to_device(d_lo[a:b], np.int8, device))


def sv_tables(mq_tab: np.ndarray, hez_tab: np.ndarray, device) -> SvTables:
    """The scorer's tables on ``device``: the f64 binomial tables and
    sv_screen's etype -> kind / reverse-side index tables, as they are."""
    from grom_tpu_torch.call.sv_screen import _ETYPE_KIND, _ETYPE_REV
    if mq_tab.shape != hez_tab.shape or mq_tab.ndim != 2:
        raise ValueError("the mq and hez tables must be 2-D of one shape")
    return SvTables(mq=to_device(mq_tab, np.float64, device),
                    hez=to_device(hez_tab, np.float64, device),
                    kind=to_device(_ETYPE_KIND, np.int32, device),
                    rev=to_device(_ETYPE_REV, np.int32, device))


def sv_entries(arrays, device) -> torch.Tensor:
    """One window's entry arrays (sv_screen's ``scorer`` arguments: pos,
    etype, count, rs, re, rd, weak_f, weak_r, ctx_f_here) as the int64
    [9, n] ``sv_score`` input on ``device``: packed into one host buffer
    (pinned for a CUDA device) and uploaded in one copy, not waited for."""
    dev = torch.device(device)
    n = len(arrays[0])
    host = torch.empty((len(ENTRY_KEYS), n), dtype=torch.int64,
                       pin_memory=dev.type == "cuda")
    hb = host.numpy()
    for k, a in enumerate(arrays):
        hb[k] = a
    if dev.type == "cpu":
        return host
    if dev.type == "cuda":
        with torch.cuda.device(dev):
            return host.to(dev, non_blocking=True)
    return host.to(dev)


# positions a block of ``DepthLists.to_host`` carries: its pinned staging
# buffer is 12 bytes a position (24 MiB), whatever the chromosome's length
RD_DOWNLOAD_BLOCK = 1 << 21


class DepthLists:
    """A chromosome's three caf_rd_* depth lists (rd_mq, rd_hi, rd_lo) as
    int32 rows [3, L] on ``device``: where a device engine builds them
    through the scan stage, so the host holds no list of the chromosome's
    length until the scan ends. ``add_window`` adds an ingest chunk's
    spans (the torch engine), the mesh engine writes its cells' rows into
    ``rows``; ``to_host`` then gives the stages after the scan the three
    host arrays the host engine builds."""

    def __init__(self, L: int, device):
        self.L = L
        self.device = torch.device(device)
        self.rows = torch.zeros((3, L), dtype=torch.int32, device=self.device)

    @property
    def nbytes(self) -> int:
        return self.rows.numel() * self.rows.element_size()

    def add_window(self, lo: int, hi: int, starts: np.ndarray,
                   ends: np.ndarray, mapq: np.ndarray, min_mapq: int) -> None:
        """Add the depth of spans [starts, ends) (relative to ``lo``, within
        [0, hi - lo]) with their reads' ``mapq`` into [lo, hi) of each list:
        mapq into rd_mq, one into rd_hi (mapq >= ``min_mapq``) or rd_lo.
        The endpoint counts are summed and prefix-summed in int64 on the
        device (integers, so exact in any order) and added into the rows
        as int32, as ``driver._accumulate_rd_window`` adds its f64 counts
        into host lists."""
        n = hi - lo
        if not len(starts) or n <= 0:
            return
        dev = self.device
        i64 = torch.int64
        s = torch.from_numpy(np.ascontiguousarray(starts, np.int32)).to(dev)
        e = torch.from_numpy(np.ascontiguousarray(ends, np.int32)).to(dev)
        mq = torch.from_numpy(np.ascontiguousarray(mapq, np.int32)).to(dev)
        w = torch.empty((3, len(mq)), dtype=i64, device=dev)
        w[0] = mq
        torch.ge(mq, min_mapq, out=w[1])
        torch.sub(1, w[1], out=w[2])
        d = torch.zeros((3, n + 1), dtype=i64, device=dev)
        d.index_add_(1, s.to(i64), w)
        d.index_add_(1, e.to(i64), w, alpha=-1)
        d.cumsum_(1)
        self.rows[:, lo:hi] += d[:, :n].to(torch.int32)

    def to_host(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rd_mq, rd_hi, rd_lo) as three int32 [L] host arrays, copied
        ``RD_DOWNLOAD_BLOCK`` positions at a time through one staging
        buffer (pinned on a CUDA device): never through a pinned block of
        the whole length, which torch's caching host allocator would keep,
        and keep resident, after the copy."""
        L = self.L
        out = tuple(np.empty(L, np.int32) for _ in range(3))
        B = max(min(RD_DOWNLOAD_BLOCK, L), 1)
        cuda = self.device.type == "cuda"
        stage = torch.empty(3 * B, dtype=torch.int32, pin_memory=cuda)
        sb = stage.numpy()
        with torch.cuda.device(self.device) if cuda else \
                contextlib.nullcontext():
            for b0 in range(0, L, B):
                k = min(B, L - b0)
                for r in range(3):
                    stage[r * k:(r + 1) * k].copy_(self.rows[r, b0:b0 + k],
                                                   non_blocking=cuda)
                if cuda:
                    torch.cuda.current_stream().synchronize()
                for r in range(3):
                    out[r][b0:b0 + k] = sb[r * k:(r + 1) * k]
        return out
