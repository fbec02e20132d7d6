"""Per-tile accumulate + SNV superset screen (the counterpart of
grom_tpu/ops/accumulate.py).

The chromosome range of a detect sub-chunk is cut into 2^18-base position
tiles; spans are clipped at tile edges on the host (``SpanIndex``), so every
per-base statistic is tile-local. Each tile goes through one kernel:

* ``tile_kernel`` dispatches on the device of its inputs: CUDA tensors go to
  the hand-written kernel in ``csrc/tile_accumulate.cu``, CPU tensors to
  ``tile_kernel_plain``, the same computation in plain torch.
* ``TorchAccumulator.run`` has the signature and return contract of
  grom_tpu's ``DeviceAccumulator.run``, so the SNV caller
  (``call/snv.py candidates_from_device``) consumes its dict unchanged.

Tiles take runtime sizes: there are no padded buckets, no overflow ladder
and no host fallback. The candidate outputs are sized by a count pass.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from grom_tpu_torch import _build

NT = 4
TILE_L = 1 << 18      # positions per tile
NAME_LEN_CAP = 50     # names at least this long are never stored by dedup
_BLOCK = 256          # threads per block of the CUDA passes

CAND_KEYS = ("pos", "counts", "lowmq", "pos_in_read", "fstrand", "bq",
             "bq_all", "mq", "mq_all", "bq_read_count", "mq_read_count",
             "read_count_all")
_CHANNELS = ("counts", "lowmq", "pos_in_read", "fstrand")


class TileInputs(NamedTuple):
    """One tile's tensors at runtime sizes, all on one device.

    Spans (S): ``span_read`` (tile-local read index), ``span_ref``
    (tile-local start), ``span_off`` (read-base offset), int32; ``cum``
    int32 [S + 1] the exclusive prefix of span lengths. Reads (R): ``elig``
    u8, ``mapq`` u8, ``flag`` int32, ``lseq`` int32, ``seq_off`` int32
    (into ``seq``/``qual``), ``name_id`` int32, ``name_len`` u8. Bytes (Q):
    ``seq``, ``qual`` u8. Positions (L): ``chrom_up`` u8 (uppercased
    reference), ``is_n`` bool, ``gate`` u8."""
    span_read: torch.Tensor
    span_ref: torch.Tensor
    span_off: torch.Tensor
    cum: torch.Tensor
    elig: torch.Tensor
    mapq: torch.Tensor
    flag: torch.Tensor
    lseq: torch.Tensor
    seq_off: torch.Tensor
    name_id: torch.Tensor
    name_len: torch.Tensor
    seq: torch.Tensor
    qual: torch.Tensor
    chrom_up: torch.Tensor
    is_n: torch.Tensor
    gate: torch.Tensor


_DTYPES = dict(span_read=torch.int32, span_ref=torch.int32,
               span_off=torch.int32, cum=torch.int32, elig=torch.uint8,
               mapq=torch.uint8, flag=torch.int32, lseq=torch.int32,
               seq_off=torch.int32, name_id=torch.int32,
               name_len=torch.uint8, seq=torch.uint8, qual=torch.uint8,
               chrom_up=torch.uint8, is_n=torch.bool, gate=torch.uint8)


def screen_threshold(min_ratio: float) -> float:
    """The screen's f32 threshold ``min_ratio*(1-1e-3) - 1e-9``, rounded
    as f32 at every step like the reference kernel (an exact f32 value)."""
    f = np.float32
    return float(f(min_ratio) * f(1.0 - 1e-3) - f(1e-9))


def to_device(a, dtype, device) -> torch.Tensor:
    """A numpy array as a contiguous tensor of numpy ``dtype`` on
    ``device``; on the CPU it may share memory with ``a``."""
    arr = np.ascontiguousarray(a, dtype=dtype)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


class SpanIndex:
    """M-span table sorted by reference start with per-range clipping —
    the host-side tiling step. Splitting spans at tile edges keeps every
    per-base statistic position-local, so tiling is exact."""

    def __init__(self, batch):
        sref = batch.span_ref.astype(np.int64)
        slen = batch.span_len.astype(np.int64)
        sread = batch.span_read.astype(np.int64)
        soff = batch.span_readoff.astype(np.int64)
        if len(sref):
            order = np.argsort(sref, kind="stable")
            sref, slen, sread, soff = (sref[order], slen[order],
                                       sread[order], soff[order])
        self.sref, self.slen, self.sread, self.soff = sref, slen, sread, soff
        self.send = sref + slen
        self.max_len = int(slen.max()) if len(slen) else 0

    def slice_range(self, t0: int, t1: int):
        """Spans clipped to [t0, t1): (read_idx, cell-local ref start,
        read-base offset, length) — all spans wholly inside the range after
        clipping, in sorted-start order."""
        lo = int(np.searchsorted(self.sref, t0 - self.max_len, side="left"))
        hi = int(np.searchsorted(self.sref, t1, side="left"))
        m = self.send[lo:hi] > t0
        t_ref = self.sref[lo:hi][m]
        t_end = np.minimum(self.send[lo:hi][m], t1)
        t_read = self.sread[lo:hi][m]
        t_off = self.soff[lo:hi][m]
        delta = np.maximum(t0 - t_ref, 0)
        t_len = t_end - (t_ref + delta)
        keep = t_len > 0
        return (t_read[keep], (t_ref + delta - t0)[keep],
                (t_off + delta)[keep], t_len[keep])


def tile_inputs(sindex: SpanIndex, reads, elig_u8: np.ndarray, t0: int,
                t1: int, chrom_up: np.ndarray, is_n: np.ndarray,
                gate: np.ndarray, device) -> Optional[TileInputs]:
    """The tile [t0, t1) as device tensors; ``chrom_up``/``is_n``/``gate``
    are already cut to the tile. None when no span reaches the tile."""
    t_read, t_ref, t_off, t_len = sindex.slice_range(t0, t1)
    S = len(t_len)
    if S == 0:
        return None
    r0 = int(t_read.min())
    r1 = int(t_read.max()) + 1
    q0 = int(reads.seq_off[r0])
    q1 = int(reads.seq_off[r1])
    cum = np.zeros(S + 1, np.int64)
    np.cumsum(t_len, out=cum[1:])
    if cum[-1] >= 1 << 31:
        raise ValueError("tile [%d, %d) holds %d aligned bases, above the "
                         "int32 event index" % (t0, t1, cum[-1]))
    dev = device
    return TileInputs(
        span_read=to_device(t_read - r0, np.int32, dev),
        span_ref=to_device(t_ref, np.int32, dev),
        span_off=to_device(t_off, np.int32, dev),
        cum=to_device(cum, np.int32, dev),
        elig=to_device(elig_u8[r0:r1], np.uint8, dev),
        mapq=to_device(reads.mapq[r0:r1], np.uint8, dev),
        flag=to_device(reads.flag[r0:r1], np.int32, dev),
        lseq=to_device(reads.lseq[r0:r1], np.int32, dev),
        seq_off=to_device(reads.seq_off[r0:r1].astype(np.int64) - q0, np.int32,
                    dev),
        name_id=to_device(reads.name_id[r0:r1], np.int32, dev),
        name_len=to_device(reads.name_len[r0:r1], np.uint8, dev),
        seq=to_device(reads.seq[q0:q1], np.uint8, dev),
        qual=to_device(reads.qual[q0:q1], np.uint8, dev),
        chrom_up=to_device(chrom_up, np.uint8, dev),
        is_n=to_device(is_n, np.bool_, dev),
        gate=to_device(gate, np.uint8, dev))


def _lut(device) -> torch.Tensor:
    lut = torch.full((256,), NT, dtype=torch.int64)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
        lut[ch | 0x20] = i
    return lut.to(device)


def tile_kernel_plain(t: TileInputs, thr: float, min_mapq: int, min_bq: int,
                      min_snv: int, name_len_cap: int = NAME_LEN_CAP
                      ) -> Tuple[torch.Tensor, int, dict]:
    """The tile kernel in plain torch. Returns (base_tot int32 [L], n_mm,
    cand) where cand holds the candidate positions (int64, ascending) and
    their int32 statistics ([4, K] for the per-base channels)."""
    dev = t.cum.device
    i64 = torch.int64
    L = t.chrom_up.shape[0]
    lut = _lut(dev)
    cum = t.cum.to(i64)
    E = int(cum[-1])
    e = torch.arange(E, dtype=i64, device=dev)
    sid = torch.searchsorted(cum[1:], e, right=True)
    within = e - cum[sid]
    rid = t.span_read.to(i64)[sid]
    pos = t.span_ref.to(i64)[sid] + within
    ridx = t.span_off.to(i64)[sid] + within
    ok = (t.elig[rid] > 0) & (pos >= 0) & (pos < L)
    # only ok events can count; keep them in event-index order
    rid, pos, ridx = rid[ok], pos[ok], ridx[ok]
    flat = t.seq_off.to(i64)[rid] + ridx
    sb = t.seq.to(i64)[flat]
    code = lut[sb]
    q = t.qual.to(i64)[flat]
    mq = t.mapq.to(i64)[rid]
    fwd = (t.flag[rid] & 16) == 0
    lsq = t.lseq.to(i64)[rid]
    nid = t.name_id.to(i64)[rid]
    nshort = t.name_len.to(i64)[rid] < name_len_cap
    hi = (mq >= min_mapq) & (q >= min_bq)
    # byte-level mismatch: toupper(ref) != read byte
    mm = t.chrom_up.to(i64)[pos] != sb

    # ---- exact read-name dedup on the hi & mm events -------------------
    d = torch.nonzero(hi & mm).squeeze(1)      # arrival (event) order
    n_mm = int(d.numel())
    skip = torch.zeros_like(hi)
    if n_mm:
        dpos, dnid, dshort = pos[d], nid[d], nshort[d]
        # group by (pos, name); a stable sort keeps arrival order inside
        key = dpos * (1 << 32) + (dnid + (1 << 31))
        order = torch.sort(key, stable=True).indices
        skey = key[order]
        first = torch.ones(n_mm, dtype=torch.bool, device=dev)
        first[1:] = skey[1:] != skey[:-1]
        gid = torch.cumsum(first.to(i64), 0) - 1
        g_arr = order[first]                 # arrival index of group firsts
        g_pos = dpos[g_arr]
        # short groups ranked per position by first arrival
        sg = torch.nonzero(dshort[g_arr]).squeeze(1)
        o2 = torch.sort(g_pos[sg] * (1 << 32) + g_arr[sg]).indices
        sg = sg[o2]
        sp = g_pos[sg]
        rank = (torch.arange(sg.numel(), device=dev)
                - torch.searchsorted(sp, sp, right=False))
        stored = torch.zeros(g_arr.numel(), dtype=torch.bool, device=dev)
        stored[sg] = rank < min_snv
        skip_sorted = (~first) & stored[gid]
        skip_d = torch.zeros(n_mm, dtype=torch.bool, device=dev)
        skip_d[order] = skip_sorted
        skip[d] = skip_d

    # ---- per-base tallies ------------------------------------------------
    counted = hi & ~skip & (code < NT)
    low = ~hi & (code < NT)
    pir = torch.where(mm | fwd, ridx, lsq - ridx)
    ch_idx = code.clamp(max=NT - 1) * L + pos

    def tally(mask, weights=None, channels=False):
        out = torch.zeros(NT * L if channels else L, dtype=i64, device=dev)
        idx = (ch_idx if channels else pos)[mask]
        w = (torch.ones_like(idx) if weights is None else weights[mask])
        out.index_add_(0, idx, w)
        out = out.to(torch.int32)
        return out.view(NT, L) if channels else out

    snv = tally(counted, channels=True)
    lowmq = tally(low, channels=True)
    fstrand = tally(counted & fwd, channels=True)
    pos_in_read = tally(counted, pir, channels=True)
    bq = tally(counted, q)
    bq_low = tally(low, q)
    mq_sum = tally(counted, mq)
    mq_low = tally(low, mq)
    n_hi = tally(counted)
    n_low = tally(low)

    total = snv.sum(0, dtype=torch.int32)
    base_tot = total + lowmq.sum(0, dtype=torch.int32)

    # ---- superset SNV screen ---------------------------------------------
    ref_code = lut[t.chrom_up.to(i64)]
    is_alt = torch.arange(NT, device=dev)[:, None] != ref_code[None, :]
    ratio = snv.to(torch.float32) / total.to(torch.float32)
    qual_m = (is_alt & (ratio >= thr) & (snv >= min_snv)
              & (t.gate > 0)[None, :] & ~t.is_n[None, :])
    w = torch.nonzero(qual_m.any(0)).squeeze(1)
    cand = dict(
        pos=w, counts=snv[:, w], lowmq=lowmq[:, w],
        pos_in_read=pos_in_read[:, w], fstrand=fstrand[:, w],
        bq=bq[w], bq_all=(bq + bq_low)[w], mq=mq_sum[w],
        mq_all=(mq_sum + mq_low)[w], bq_read_count=n_hi[w],
        mq_read_count=n_hi[w], read_count_all=(n_hi + n_low)[w])
    return base_tot, n_mm, cand


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("tile_accumulate")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tile = [P] * 4 + [I] + [P] * 10 + [I] * 4
    _build.bind(lib, "gt_tile_events", tile + [I, P, P, P])
    _build.bind(lib, "gt_tile_dedup_screen",
                tile + [I, P, P, P, P, P, P, I, P, P, F, P, P, P, P])
    _build.bind(lib, "gt_tile_compact", tile + [P] * 15 + [I, P])
    return lib


def _check_tile(t: TileInputs) -> None:
    dev = t.cum.device
    for name, want in _DTYPES.items():
        x = getattr(t, name)
        if x.dtype != want or x.device != dev or not x.is_contiguous():
            raise ValueError("tile input %s must be a contiguous %s tensor "
                             "on %s (got %s on %s)"
                             % (name, want, dev, x.dtype, x.device))


def _tile_kernel_cuda(t: TileInputs, thr: float, min_mapq: int, min_bq: int,
                      min_snv: int, name_len_cap: int):
    _check_tile(t)
    lib = _lib()
    dev = t.cum.device
    L = int(t.chrom_up.shape[0])
    S = int(t.span_read.shape[0])
    E = int(t.cum[-1])
    stream = _build.stream_ptr(dev)
    targs = (t.span_read.data_ptr(), t.span_ref.data_ptr(),
             t.span_off.data_ptr(), t.cum.data_ptr(), S, t.elig.data_ptr(),
             t.mapq.data_ptr(), t.flag.data_ptr(), t.lseq.data_ptr(),
             t.seq_off.data_ptr(), t.name_id.data_ptr(),
             t.name_len.data_ptr(), t.seq.data_ptr(), t.qual.data_ptr(),
             t.chrom_up.data_ptr(), L, min_mapq, min_bq, name_len_cap)
    i32 = torch.int32
    tally = torch.zeros((22, L), dtype=i32, device=dev)
    mm_count = torch.zeros(L, dtype=i32, device=dev)
    _build.check(lib, lib.gt_tile_events(*targs, E, tally.data_ptr(),
                                         mm_count.data_ptr(), stream),
                 "tile_events")
    # per-position CSR of the hi & mm events (count -> scan -> fill)
    ends = torch.cumsum(mm_count, 0, dtype=torch.int64)
    off = ends - mm_count
    n_mm = int(ends[-1]) if L else 0
    fill = torch.zeros(L, dtype=i32, device=dev)
    csr = torch.empty(max(n_mm, 1), dtype=i32, device=dev)
    table = torch.empty(max(n_mm, 1), dtype=i32, device=dev)
    base_tot = torch.empty(L, dtype=i32, device=dev)
    flag = torch.empty(L, dtype=torch.uint8, device=dev)
    nblk = (L + _BLOCK - 1) // _BLOCK
    block_count = torch.empty(nblk, dtype=i32, device=dev)
    _build.check(lib, lib.gt_tile_dedup_screen(
        *targs, E, tally.data_ptr(), mm_count.data_ptr(), off.data_ptr(),
        fill.data_ptr(), csr.data_ptr(), table.data_ptr(), min_snv,
        t.is_n.data_ptr(), t.gate.data_ptr(), thr, base_tot.data_ptr(),
        flag.data_ptr(), block_count.data_ptr(), stream),
        "tile_dedup_screen")
    block_end = torch.cumsum(block_count, 0, dtype=torch.int64)
    block_off = block_end - block_count
    K = int(block_end[-1]) if nblk else 0
    cand = dict(pos=torch.empty(K, dtype=torch.int64, device=dev))
    for k in _CHANNELS:
        cand[k] = torch.empty((NT, K), dtype=i32, device=dev)
    for k in CAND_KEYS[5:]:
        cand[k] = torch.empty(K, dtype=i32, device=dev)
    _build.check(lib, lib.gt_tile_compact(
        *targs, tally.data_ptr(), flag.data_ptr(), block_off.data_ptr(),
        *(cand[k].data_ptr() for k in CAND_KEYS), K, stream),
        "tile_compact")
    _build.LAUNCHES["tile_accumulate"] += 1
    return base_tot, n_mm, cand


def tile_kernel(t: TileInputs, thr: float, min_mapq: int, min_bq: int,
                min_snv: int, name_len_cap: int = NAME_LEN_CAP):
    """One tile's accumulate + screen: the CUDA kernel for CUDA tensors,
    ``tile_kernel_plain`` for CPU tensors."""
    kind = t.cum.device.type
    if kind == "cuda":
        with torch.cuda.device(t.cum.device):
            return _tile_kernel_cuda(t, thr, min_mapq, min_bq, min_snv,
                                     name_len_cap)
    if kind == "cpu":
        return tile_kernel_plain(t, thr, min_mapq, min_bq, min_snv,
                                 name_len_cap)
    raise ValueError("tile_kernel runs on cuda or cpu tensors, not %s" % kind)


_EMPTY = {"n": 0, "pos": np.empty(0, np.int64),
          "counts": np.empty((4, 0), np.int64),
          "lowmq": np.empty((4, 0), np.int64),
          "pos_in_read": np.empty((4, 0), np.int64),
          "fstrand": np.empty((4, 0), np.int64),
          "bq": np.empty(0, np.int64), "bq_all": np.empty(0, np.int64),
          "mq": np.empty(0, np.int64), "mq_all": np.empty(0, np.int64),
          "bq_read_count": np.empty(0, np.int64),
          "mq_read_count": np.empty(0, np.int64),
          "read_count_all": np.empty(0, np.int64)}


class TorchAccumulator:
    """Host wrapper: splits a position range into tiles, uploads each
    tile's span/read slices, runs the tile kernel, merges the results.
    ``device`` is where the tiles run: a CUDA device, or "cpu" for the
    plain versions."""

    def __init__(self, device):
        self.device = torch.device(device)

    def run(self, chrom: np.ndarray, batch, eligible: np.ndarray, cfg,
            gate: np.ndarray, lo: int = 0, hi: int = 0,
            base_tot_out: np.ndarray = None, gate_base: int = 0,
            base_tot_base: int = 0):
        """``lo``/``hi`` restrict processing to a position range (spans are
        clipped at the range edges exactly like tile edges);
        ``base_tot_out`` receives base_tot in place across chunked calls.
        ``gate``/``base_tot_out`` may be chunk-local arrays whose index 0 is
        ``gate_base``/``base_tot_base``. Returns (base_tot, candidates)."""
        reads = batch.reads
        if reads.name_id is None or reads.name_len is None:
            raise ValueError("the torch accumulator needs read-name ids: "
                             "decode the reads with their names")
        L = len(chrom)
        hi = hi if hi > 0 else L
        sindex = SpanIndex(batch)
        part = chrom[lo:hi]
        up = np.where(part >= 97, part - 32, part).astype(np.uint8)
        is_n = up == ord("N")
        elig_u8 = eligible.astype(np.uint8)
        gate_u8 = (gate > 0).astype(np.uint8)
        base_tot = (base_tot_out if base_tot_out is not None
                    else np.zeros(L, np.int64))
        thr = screen_threshold(cfg.min_snv_ratio)
        parts = []
        for t0 in range(lo, hi, TILE_L):
            t1 = min(t0 + TILE_L, hi)
            tile = tile_inputs(sindex, reads, elig_u8, t0, t1,
                               up[t0 - lo:t1 - lo], is_n[t0 - lo:t1 - lo],
                               gate_u8[t0 - gate_base:t1 - gate_base],
                               self.device)
            if tile is None:
                continue
            bt, _, cand = tile_kernel(tile, thr, cfg.min_mapq,
                                      cfg.min_base_qual, cfg.min_snv)
            base_tot[t0 - base_tot_base:t1 - base_tot_base] = \
                bt.cpu().numpy()
            if cand["pos"].numel():
                p = {k: v.cpu().numpy() for k, v in cand.items()}
                p["pos"] = p["pos"] + t0
                parts.append(p)
        if not parts:
            return base_tot, dict(_EMPTY)
        dev = {"n": int(sum(len(p["pos"]) for p in parts))}
        for k in CAND_KEYS:
            dev[k] = np.concatenate([p[k] for p in parts],
                                    axis=1 if k in _CHANNELS else 0)
        return base_tot, dev
