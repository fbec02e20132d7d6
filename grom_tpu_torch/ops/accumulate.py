"""Per-tile accumulate + SNV superset screen (the counterpart of
grom_tpu/ops/accumulate.py).

The chromosome range of a detect sub-chunk is cut into 2^18-base position
tiles; spans are clipped at tile edges on the host (``SpanIndex``), so every
per-base statistic is tile-local. Each tile goes through one kernel:

* ``tile_inputs`` packs a tile's fifteen arrays into one buffer (pinned
  for a CUDA device) and uploads it in one copy; ``TileInputs`` holds views
  of it. The tile's gate (``tile_gate``: positions whose depth lets a
  candidate through) is not among them: it exists only once the detect
  sub-chunk's deposits have drained, so it is uploaded apart, at launch.
* ``tile_launch`` enqueues the tile with its gate and returns its packed
  result (header, base_tot, candidate rows; ``HDR``/``REC``) without
  waiting: CUDA tensors go to the hand-written kernel in
  ``csrc/tile_accumulate.cu``, CPU tensors to ``tile_kernel_plain``, the
  same computation in plain torch.
* ``tile_kernel`` returns the unpacked result, as ``tile_kernel_plain``
  does, after one sync to read the header.
* ``TorchAccumulator.run`` has the signature and return contract of
  grom_tpu's ``DeviceAccumulator.run``, so the SNV caller
  (``call/snv.py candidates_from_device``) consumes its dict unchanged. It
  is ``prepare`` (every tile's inputs uploaded, one upload a tile: a
  ``TorchJob`` that holds only device tensors) then ``launch`` (the gate's
  one upload, then per tile one launch, one copy back of the header,
  base_tot and the candidate rows, one sync). The streamed driver prepares
  a detect sub-chunk's job when it feeds the sub-chunk and launches it when
  the sub-chunk drains, so a queued job holds no host reads.

Tiles take runtime sizes: there are no padded buckets, no overflow ladder
and no host fallback. The card bounds every buffer by sizes the host knows
(positions, aligned bases), so no launch waits for a count.
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

CAND_KEYS = ("pos", "counts", "lowmq", "pos_in_read", "fstrand", "bq",
             "bq_all", "mq", "mq_all", "bq_read_count", "mq_read_count",
             "read_count_all")
_CHANNELS = ("counts", "lowmq", "pos_in_read", "fstrand")
_SCALARS = CAND_KEYS[1 + len(_CHANNELS):]

# A tile's result, int32: a header of HDR entries (H_NMM hi & mm events,
# H_K candidates, H_ERR spans out of order), base_tot [L], then K candidate
# rows of REC entries in CAND_KEYS order (pos tile-local; four per channel)
HDR = 8
H_NMM, H_K, H_ERR = 0, 1, 2
REC = 1 + NT * len(_CHANNELS) + len(_SCALARS)
K_GUESS = 4096        # candidate rows the first copy back of a tile brings


class TileInputs(NamedTuple):
    """One tile's tensors at runtime sizes, all on one device (``pack_tile``
    makes them views of one buffer); the gate goes beside them
    (``tile_gate``).

    Spans (S): ``span_read`` (tile-local read index), ``span_ref``
    (tile-local start), ``span_off`` (read-base offset), int32; ``cum``
    int32 [S + 1] the exclusive prefix of span lengths. Reads (R): ``elig``
    u8, ``mapq`` u8, ``flag`` int32, ``lseq`` int32, ``seq_off`` int32
    (into ``seq``/``qual``), ``name_id`` int32, ``name_len`` u8. Bytes (Q):
    ``seq``, ``qual`` u8. Positions (L): ``chrom_up`` u8 (uppercased
    reference), ``is_n`` bool. Host ints: ``n_events`` =
    cum[S], ``max_span`` the longest span. The CUDA kernel also needs the
    spans in non-decreasing ``span_ref`` order (``SpanIndex`` order); the
    plain version takes any order."""
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
    n_events: int
    max_span: int


_DTYPES = dict(span_read=torch.int32, span_ref=torch.int32,
               span_off=torch.int32, cum=torch.int32, elig=torch.uint8,
               mapq=torch.uint8, flag=torch.int32, lseq=torch.int32,
               seq_off=torch.int32, name_id=torch.int32,
               name_len=torch.uint8, seq=torch.uint8, qual=torch.uint8,
               chrom_up=torch.uint8, is_n=torch.bool)

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
    per-base statistic position-local, so tiling is exact. Its columns are
    int32 (BAM positions, lengths and offsets are): an ingest chunk's
    index lives through all the chunk's sub-chunks."""

    def __init__(self, batch, lo: int = 0, hi: int = 0):
        """With ``hi > lo``, only the spans overlapping [lo, hi): the
        tiles of that range slice the same spans in the same order."""
        sref, slen = batch.span_ref, batch.span_len
        sread, soff = batch.span_read, batch.span_readoff
        if hi > lo:
            m = (sref < hi) & (sref + slen > lo)
            sref, slen, sread, soff = sref[m], slen[m], sread[m], soff[m]
        sref = sref.astype(np.int32)
        slen = slen.astype(np.int32)
        sread = sread.astype(np.int32)
        soff = soff.astype(np.int32)
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


def pack_offsets(arrays: dict, dtypes: dict):
    """``pack_arrays``'s layout of the numpy ``arrays`` as ``dtypes`` types
    them: [(name, byte offset, bytes)] at 16-byte aligned offsets, and the
    buffer's bytes (at least 16)."""
    offs, total = [], 0
    for name, dt in dtypes.items():
        n = len(arrays[name]) * dt.itemsize
        offs.append((name, total, n))
        total += -(-n // 16) * 16
    return offs, max(total, 16)


def pack_arrays(arrays: dict, dtypes: dict, device) -> dict:
    """Views on ``device``, keyed as ``dtypes`` (name -> torch dtype), of
    the numpy ``arrays`` (1-D, any numeric or bool dtype): packed into one
    host buffer (``pack_offsets``) and uploaded in one copy. For a CUDA
    device the host buffer is pinned and the copy is not waited for:
    torch's caching host allocator hands the pinned block out again only
    once the copy out of it has finished, and keeps it, resident, for the
    next request of its size class."""
    dev = torch.device(device)
    offs, total = pack_offsets(arrays, dtypes)
    host = torch.empty(total, dtype=torch.uint8,
                       pin_memory=dev.type == "cuda")
    hb = host.numpy()
    for name, off, n in offs:
        np_dt = np.dtype(str(dtypes[name]).replace("torch.", ""))
        hb[off:off + n].view(np_dt)[:] = arrays[name]
    if dev.type == "cpu":
        buf = host
    elif dev.type == "cuda":
        with torch.cuda.device(dev):
            buf = host.to(dev, non_blocking=True)
    else:
        buf = host.to(dev)
    return {name: buf[off:off + n].view(dtypes[name])
            for name, off, n in offs}


def pack_tile(arrays: dict, device) -> TileInputs:
    """``TileInputs`` on ``device`` from the tile's arrays (numpy, keyed by
    field name; any other key, such as ``gate``, is not packed), in one
    upload (``pack_arrays``)."""
    cum = np.asarray(arrays["cum"])
    return TileInputs(**pack_arrays(arrays, _DTYPES, device),
                      n_events=int(cum[-1]),
                      max_span=int(np.diff(cum).max()) if len(cum) > 1 else 0)


def tile_gate(gate: np.ndarray, device) -> torch.Tensor:
    """``gate > 0`` as the u8 tensor ``tile_launch`` takes, on ``device`` in
    one upload (pinned and not waited for on a CUDA device, as
    ``pack_arrays`` uploads); a range's gate, whose slices are its tiles'
    gates."""
    return pack_arrays({"gate": np.asarray(gate) > 0},
                       {"gate": torch.uint8}, device)["gate"]


def tile_inputs(sindex: SpanIndex, reads, elig_u8: np.ndarray, t0: int,
                t1: int, chrom_up: np.ndarray, is_n: np.ndarray,
                device) -> Optional[TileInputs]:
    """The tile [t0, t1) on ``device`` (one upload); ``chrom_up``/``is_n``
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
    return pack_tile(dict(
        span_read=t_read - r0, span_ref=t_ref, span_off=t_off, cum=cum,
        elig=elig_u8[r0:r1], mapq=reads.mapq[r0:r1],
        flag=reads.flag[r0:r1], lseq=reads.lseq[r0:r1],
        seq_off=reads.seq_off[r0:r1].astype(np.int64) - q0,
        name_id=reads.name_id[r0:r1], name_len=reads.name_len[r0:r1],
        seq=reads.seq[q0:q1], qual=reads.qual[q0:q1], chrom_up=chrom_up,
        is_n=is_n), device)


def _lut(device) -> torch.Tensor:
    lut = torch.full((256,), NT, dtype=torch.int64)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
        lut[ch | 0x20] = i
    return lut.to(device)


def tile_kernel_plain(t: TileInputs, gate: torch.Tensor, thr: float,
                      min_mapq: int, min_bq: int, min_snv: int,
                      name_len_cap: int = NAME_LEN_CAP
                      ) -> Tuple[torch.Tensor, int, dict]:
    """The tile kernel in plain torch; ``gate`` u8 [L]. Returns (base_tot
    int32 [L], n_mm, cand) where cand holds the candidate positions (int64,
    ascending) and their int32 statistics ([4, K] for the per-base
    channels)."""
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
              & (gate > 0)[None, :] & ~t.is_n[None, :])
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
    P, I, Lg, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
    _build.bind(lib, "gt_tile_accumulate",
                [P] * 4 + [I] + [P] * 12 + [I, Lg] + [I] * 5 + [F] + [P] * 4)
    for fn, args in (("gt_tile_scratch_bytes", [I, Lg]),
                     ("gt_tile_result_len", [I])):
        getattr(lib, fn).restype = Lg
        getattr(lib, fn).argtypes = args
    return lib


def _check_tile(t: TileInputs, gate: torch.Tensor) -> None:
    dev = t.cum.device
    for name, want in dict(_DTYPES, gate=torch.uint8).items():
        x = gate if name == "gate" else getattr(t, name)
        if x.dtype != want or x.device != dev or not x.is_contiguous():
            raise ValueError("tile input %s must be a contiguous %s tensor "
                             "on %s (got %s on %s)"
                             % (name, want, dev, x.dtype, x.device))
    if gate.shape != t.chrom_up.shape:
        raise ValueError("the tile's gate has %d positions, the tile %d"
                         % (gate.shape[0], t.chrom_up.shape[0]))


def _tile_launch_cuda(t: TileInputs, gate: torch.Tensor, thr: float,
                      min_mapq: int, min_bq: int, min_snv: int,
                      name_len_cap: int, pass_ms=None) -> torch.Tensor:
    _check_tile(t, gate)
    lib = _lib()
    dev = t.cum.device
    L = int(t.chrom_up.shape[0])
    scratch = torch.empty(lib.gt_tile_scratch_bytes(L, t.n_events),
                          dtype=torch.uint8, device=dev)
    res = torch.empty(lib.gt_tile_result_len(L), dtype=torch.int32,
                      device=dev)
    # the kernel's pointer order: the fields, then the gate
    ptrs = [getattr(t, name).data_ptr() for name in _DTYPES]
    ptrs.append(gate.data_ptr())
    _build.check(lib, lib.gt_tile_accumulate(
        *ptrs[:4], int(t.span_read.shape[0]), *ptrs[4:], L, t.n_events,
        t.max_span, min_mapq, min_bq, min_snv, name_len_cap, thr,
        scratch.data_ptr(), res.data_ptr(),
        None if pass_ms is None else pass_ms.ctypes.data,
        _build.stream_ptr(dev)), "tile_accumulate")
    return res


def pack_result(base_tot: torch.Tensor, n_mm: int, cand: dict
                ) -> torch.Tensor:
    """``tile_kernel_plain``'s outputs in the packed result layout (header,
    base_tot, K candidate rows)."""
    i32 = torch.int32
    hdr = torch.zeros(HDR, dtype=i32)
    hdr[H_NMM] = n_mm
    hdr[H_K] = cand["pos"].shape[0]
    rows = torch.cat([cand["pos"].to(i32)[None]]
                     + [cand[k].to(i32) for k in _CHANNELS]
                     + [cand[k].to(i32)[None] for k in _SCALARS])
    return torch.cat([hdr.to(base_tot.device), base_tot.to(i32),
                      rows.t().reshape(-1)])


def result_len(L: int, K: int) -> int:
    """int32 entries of a packed result up to its K-th candidate row."""
    return HDR + L + K * REC


def result_header(res):
    """The HDR header entries of a packed result (a view)."""
    return res[:HDR]


def result_base_tot(res, L: int):
    """base_tot [L] of a packed result (a view)."""
    return res[HDR:HDR + L]


def result_rows(res, L: int, K: int):
    """The first K candidate rows [K, REC] of a packed result (a view)."""
    return res[HDR + L:result_len(L, K)].reshape(K, REC)


def read_header(res) -> Tuple[int, int]:
    """(n_mm, K) from a packed result or its header (numpy or CPU tensor);
    raises if the kernel found the spans out of order."""
    if int(res[H_ERR]):
        raise ValueError("the tile's spans are not sorted by span_ref: the "
                         "CUDA tile kernel needs SpanIndex order")
    return int(res[H_NMM]), int(res[H_K])


def split_rows(rows, copy) -> dict:
    """The candidate dict of ``rows`` [K, REC] (torch or numpy): pos, the
    [4, K] channels and the [K] statistics, each a view of ``rows`` passed
    through ``copy``."""
    out = {"pos": copy(rows[:, 0])}
    r = 1
    for k in _CHANNELS:
        out[k] = copy(rows[:, r:r + NT].T)
        r += NT
    for k in _SCALARS:
        out[k] = copy(rows[:, r])
        r += 1
    return out


def unpack_rows(rows: np.ndarray, t0: int = 0) -> dict:
    """The candidate dict of numpy ``rows`` [K, REC] in C-ordered arrays
    of its own, never views of ``rows`` (a row of one candidate is already
    contiguous): pos int64 plus ``t0``, the statistics in the rows'
    dtype."""
    cand = split_rows(rows, lambda x: np.array(x, order="C"))
    cand["pos"] = cand["pos"].astype(np.int64) + t0
    return cand


def merge_cands(parts) -> dict:
    """The candidate dicts of consecutive ranges, concatenated in order."""
    if not parts:
        return dict(_EMPTY)
    out = {"n": int(sum(len(p["pos"]) for p in parts))}
    for k in CAND_KEYS:
        out[k] = np.concatenate([p[k] for p in parts],
                                axis=1 if k in _CHANNELS else 0)
    return out


def tile_launch(t: TileInputs, gate: torch.Tensor, thr: float,
                min_mapq: int, min_bq: int, min_snv: int,
                name_len_cap: int = NAME_LEN_CAP) -> torch.Tensor:
    """Enqueue one tile's accumulate + screen under ``gate`` (u8 [L], on the
    tile's device) and return its packed result (int32: header, base_tot,
    candidate rows) on the tile's device, without waiting for it: the CUDA
    kernel for CUDA tensors, ``tile_kernel_plain`` (packed) for CPU
    tensors."""
    kind = t.cum.device.type
    if kind == "cuda":
        with torch.cuda.device(t.cum.device):
            res = _tile_launch_cuda(t, gate, thr, min_mapq, min_bq, min_snv,
                                    name_len_cap)
        _build.LAUNCHES["tile_accumulate"] += 1
        return res
    if kind == "cpu":
        return pack_result(*tile_kernel_plain(t, gate, thr, min_mapq, min_bq,
                                              min_snv, name_len_cap))
    raise ValueError("tile_kernel runs on cuda or cpu tensors, not %s" % kind)


def tile_kernel(t: TileInputs, gate: torch.Tensor, thr: float,
                min_mapq: int, min_bq: int, min_snv: int,
                name_len_cap: int = NAME_LEN_CAP):
    """One tile's accumulate + screen, unpacked as ``tile_kernel_plain``
    returns it (base_tot int32 [L], n_mm, cand): the CUDA kernel for CUDA
    tensors (one sync, to read the header), ``tile_kernel_plain`` for CPU
    tensors."""
    if t.cum.device.type == "cpu":
        return tile_kernel_plain(t, gate, thr, min_mapq, min_bq, min_snv,
                                 name_len_cap)
    res = tile_launch(t, gate, thr, min_mapq, min_bq, min_snv, name_len_cap)
    n_mm, K = read_header(result_header(res).cpu())
    L = int(t.chrom_up.shape[0])
    # views of the result rows; pos as int64, as the plain version has it
    cand = split_rows(result_rows(res, L, K), lambda x: x)
    cand["pos"] = cand["pos"].to(torch.int64)
    return result_base_tot(res, L), n_mm, cand


def tile_pass_ms(t: TileInputs, gate: torch.Tensor, thr: float,
                 min_mapq: int, min_bq: int, min_snv: int,
                 name_len_cap: int = NAME_LEN_CAP) -> dict:
    """Card milliseconds of each pass of one CUDA launch of the tile
    (CUDA events between the passes); a measurement, not counted in
    ``LAUNCHES``."""
    ms = np.zeros(2, np.float32)
    with torch.cuda.device(t.cum.device):
        _tile_launch_cuda(t, gate, thr, min_mapq, min_bq, min_snv,
                          name_len_cap, pass_ms=ms)
    return {"tile_window": float(ms[0]), "tile_compact": float(ms[1])}


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
        self._k_guess = K_GUESS
        self._host: Optional[torch.Tensor] = None

    def _fetch(self, res: torch.Tensor, L: int, t0: int = 0):
        """(base_tot, n_mm, candidate dict or None) of a tile's packed
        result, candidate positions plus ``t0``: for a CUDA result one copy
        of the header, base_tot and the first ``_k_guess`` candidate rows
        into this accumulator's pinned buffer, then the one sync of the
        tile (a second copy only for more rows than that). base_tot may be
        a view of that buffer, valid until the next fetch; the candidate
        dict owns its arrays."""
        if res.device.type == "cpu":
            arr = res.numpy()
        else:
            n0 = min(res.numel(), result_len(L, self._k_guess))
            if self._host is None or self._host.numel() < n0:
                self._host = torch.empty(n0, dtype=torch.int32,
                                         pin_memory=True)
            self._host[:n0].copy_(res[:n0], non_blocking=True)
            torch.cuda.current_stream(res.device).synchronize()
            arr = self._host.numpy()[:n0]
            K = read_header(arr)[1]
            if result_len(L, K) > n0:
                arr = np.concatenate(
                    [arr, res[n0:result_len(L, K)].cpu().numpy()])
            self._k_guess = max(self._k_guess, 2 * K)
        n_mm, K = read_header(arr)
        cand = unpack_rows(result_rows(arr, L, K), t0) if K else None
        return result_base_tot(arr, L), n_mm, cand

    def chunk(self, batch, eligible: np.ndarray, lo: int = 0,
              hi: int = 0) -> "ChunkReads":
        """The host index ``prepare`` reads: the spans of ``batch`` over
        [lo, hi) (all of them unless ``hi > lo``)."""
        return ChunkReads(batch, eligible, "torch", lo, hi)

    def prepare(self, chrom: np.ndarray, chunk: "ChunkReads", cfg,
                lo: int = 0, hi: int = 0) -> "TorchJob":
        """The job of [lo, hi) (within ``chunk``'s range): every tile's
        inputs on this accumulator's device, one upload a tile, not waited
        for. The job holds no host array of the reads."""
        L = len(chrom)
        hi = hi if hi > 0 else L
        up, is_n = ref_bases(chrom, lo, hi)
        tiles = []
        for t0 in range(lo, hi, TILE_L):
            t1 = min(t0 + TILE_L, hi)
            tile = tile_inputs(chunk.sindex, chunk.reads, chunk.elig_u8, t0,
                               t1, up[t0 - lo:t1 - lo],
                               is_n[t0 - lo:t1 - lo], self.device)
            if tile is not None:
                tiles.append((t0, t1, tile))
        return TorchJob(lo, hi, L, tiles, screen_threshold(cfg.min_snv_ratio),
                        (cfg.min_mapq, cfg.min_base_qual, cfg.min_snv))

    def launch(self, job: "TorchJob", gate: np.ndarray,
               base_tot_out: np.ndarray = None, gate_base: int = 0,
               base_tot_base: int = 0):
        """Run a prepared job under ``gate``: the gate of [lo, hi) in one
        upload, then per tile one launch and one read back. ``gate`` /
        ``base_tot_out`` may be range-local arrays whose index 0 is
        ``gate_base`` / ``base_tot_base``. Returns (base_tot,
        candidates)."""
        lo, hi = job.lo, job.hi
        base_tot = (base_tot_out if base_tot_out is not None
                    else np.zeros(job.L, np.int64))
        g = (tile_gate(gate[lo - gate_base:hi - gate_base], self.device)
             if job.tiles else None)
        parts = []
        for t0, t1, tile in job.tiles:
            res = tile_launch(tile, g[t0 - lo:t1 - lo], job.thr, *job.params)
            bt, _, cand = self._fetch(res, t1 - t0, t0)
            base_tot[t0 - base_tot_base:t1 - base_tot_base] = bt
            if cand is not None:
                parts.append(cand)
        return base_tot, merge_cands(parts)

    def run(self, chrom: np.ndarray, batch, eligible: np.ndarray, cfg,
            gate: np.ndarray, lo: int = 0, hi: int = 0,
            base_tot_out: np.ndarray = None, gate_base: int = 0,
            base_tot_base: int = 0):
        """``lo``/``hi`` restrict processing to a position range (spans are
        clipped at the range edges exactly like tile edges);
        ``base_tot_out`` receives base_tot in place across chunked calls.
        ``gate``/``base_tot_out`` may be chunk-local arrays whose index 0 is
        ``gate_base``/``base_tot_base``. Returns (base_tot, candidates):
        ``prepare`` then ``launch``."""
        hi = hi if hi > 0 else len(chrom)
        job = self.prepare(chrom, self.chunk(batch, eligible, lo, hi), cfg,
                           lo, hi)
        return self.launch(job, gate, base_tot_out, gate_base,
                           base_tot_base)


class ChunkReads:
    """What the device jobs of an ingest chunk's detect sub-chunks read on
    the host while they are prepared: one ``SpanIndex`` of the chunk's
    spans over [lo, hi) (all of them unless ``hi > lo``), the reads, their
    eligibility as u8; ``spans``: what an accumulator uploads of them once
    a chunk (the mesh engine: each lane's K5 input), or None. A job of a
    range within [lo, hi) slices the same spans in the same order as an
    index of its own range would give it. ``engine`` names the accumulator
    in the error for reads decoded without their name ids."""

    def __init__(self, batch, eligible: np.ndarray, engine: str,
                 lo: int = 0, hi: int = 0):
        reads = batch.reads
        if reads.name_id is None or reads.name_len is None:
            raise ValueError("the %s accumulator needs read-name ids: decode "
                             "the reads with their names" % engine)
        self.reads = reads
        self.elig_u8 = eligible.astype(np.uint8)
        self.sindex = SpanIndex(batch, lo, hi)
        self.spans = None


class TorchJob(NamedTuple):
    """A prepared range [lo, hi) of a chromosome of L bases: its tiles
    (t0, t1, ``TileInputs`` on the device), the screen's threshold and the
    kernel's (min_mapq, min_bq, min_snv)."""
    lo: int
    hi: int
    L: int
    tiles: list
    thr: float
    params: tuple

    @property
    def nbytes(self) -> int:
        """Device bytes of the job's inputs."""
        return sum(tile_bytes(t) for _, _, t in self.tiles)


def tile_bytes(t: TileInputs) -> int:
    """Bytes of a tile's packed inputs (its one buffer)."""
    return t.span_read.untyped_storage().nbytes()


def ref_bases(chrom: np.ndarray, lo: int, hi: int):
    """(the reference of [lo, hi) uppercased, u8; where it is N)."""
    part = chrom[lo:hi]
    up = np.where(part >= 97, part - 32, part).astype(np.uint8)
    return up, up == ord("N")
