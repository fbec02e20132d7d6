"""CNV kernels on the device (the counterpart of grom_tpu/ops/cnv_device.py):
per-base z-scores, per-seed window evaluation under the host outer walk,
and the null window-length model.

Each kernel has a wrapper that dispatches on the device of its inputs —
CUDA tensors go to ``csrc/cnv.cu``, CPU tensors to the plain torch version
beside it — and both are held to the host engine's bits:

* ``zscores``: the midrank z of every base with its mapq weight, bitwise
  equal to the host and to grom_tpu's ``zscores_device`` under x64; one
  pass over the per-base inputs (``ZInputs``, one upload), midrank counts
  from per-row count tables (``count_tables``) instead of row searches.
* ``seed_eval``: first-fail offset, first-window score and grow-phase
  totals of every (seed, outer class), accumulated sequentially in f64,
  returned packed in one int64 [5, NS] tensor (``unpack_outcomes``).
* ``null_model``: per-length null window stdev, held to the host's
  ``call/cnv.py:_null_window_model`` (sequential per-segment prefixes, the
  host's carry chain and one owner per window length; no float atomics),
  in batches of ``NULL_BATCH`` segments on the card with no host round
  trip between them.

``window_scan`` is the host outer walk of grom_tpu's ``window_scan_device``
(seed acceptance order, jumps, slide, trim) over ``seed_eval``'s outcomes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from grom_tpu_torch import _build

_BLOCK = 256
# segments per batch of the CUDA null model: its scratch is about
# 12 * NULL_BATCH * maxw bytes (123 MB at maxw = 10,000), whatever the
# chromosome's length
NULL_BATCH = 1024


# the widest count table of a bin row: keys past it bisect the row's tail
COUNT_CAP = 1 << 12


class CnvTables(NamedTuple):
    """The z stage's tables on one device (views of one upload,
    ``state.cnv_tables``). Per (class, GC) bin row k of the 2 nb rows,
    ``rows`` int32 [2 nb, 5]: the row's length nk, the width of its count
    table, the table's offset in ``cnt``, its tail's offset in ``tail`` and
    the tail's length. ``cnt`` int32: ``cnt[off + v]`` = #(row <= v) for v
    in [0, width), width = min(largest value + 1, cap). ``tail`` int32: the
    row's values at or above its width, ascending (none unless the row's
    largest value reaches the cap). ``ave``/``std`` f64 [2 nb];
    ``pv_p`` (non-decreasing) and ``pv_sd`` f64 [P], the pval2sd table."""
    rows: torch.Tensor
    cnt: torch.Tensor
    tail: torch.Tensor
    ave: torch.Tensor
    std: torch.Tensor
    pv_p: torch.Tensor
    pv_sd: torch.Tensor


TABLE_DTYPES = dict(rows=torch.int32, cnt=torch.int32, tail=torch.int32,
                    ave=torch.float64, std=torch.float64,
                    pv_p=torch.float64, pv_sd=torch.float64)


class ZInputs(NamedTuple):
    """The z stage's per-base inputs over its block [n] (views of one
    upload, ``state.z_inputs``): depth int32, mq int16, gc int8 (the GC
    bin), low_acgt int8 (0: the base passes the ACGT gate)."""
    depth: torch.Tensor
    mq: torch.Tensor
    gc: torch.Tensor
    low_acgt: torch.Tensor


ZIN_DTYPES = dict(depth=torch.int32, mq=torch.int16, gc=torch.int8,
                  low_acgt=torch.int8)


def count_tables(arrs: List[np.ndarray], cap: int = COUNT_CAP) -> dict:
    """The count tables of the bin rows ``arrs`` (each sorted ascending,
    non-negative; hi-mapq rows then lo-mapq rows), as ``CnvTables``'s
    ``rows``, ``cnt`` and ``tail`` (numpy int32)."""
    rows = np.zeros((len(arrs), 5), np.int64)
    cnts, tails = [], []
    c_off = t_off = 0
    for k, a in enumerate(arrs):
        a = np.asarray(a)
        nk = len(a)
        width = min(int(a[-1]) + 1, cap) if nk else 0
        cnt = np.searchsorted(a, np.arange(width), side="right")
        tail = a[np.searchsorted(a, width, side="left"):]
        rows[k] = (nk, width, c_off, t_off, len(tail))
        cnts.append(cnt)
        tails.append(tail)
        c_off += width
        t_off += len(tail)
    if c_off >= 1 << 31 or t_off >= 1 << 31:
        raise ValueError("count tables past the int32 offsets")
    cat = lambda xs: (np.concatenate(xs) if xs else np.zeros(0, np.int64))
    return dict(rows=rows.reshape(-1), cnt=cat(cnts), tail=cat(tails))


class SeedInputs(NamedTuple):
    """Per-base inputs of ``seed_eval`` over the whole chromosome [L]:
    ``svals`` f64 (side-signed weighted z) and ``flags`` uint8
    (``pack_flags``); ``win_std`` f64 [maxw + 1]."""
    svals: torch.Tensor
    flags: torch.Tensor
    win_std: torch.Tensor


# bits of SeedInputs.flags (csrc/cnv.cu reads the same)
F_LOWA = 1      # low_acgt == 0 (gated)
F_SOK0 = 2      # passes the class-0 seed threshold
F_SOK1 = 4      # passes the class-1 seed threshold
F_GCLS1 = 8     # the last gated-definite base at or before p is class 1
F_GDEF = 16     # p itself is gated-definite


def pack_flags(lowa, sok0, sok1, gcls_idx, gcls_val, base: int = 0
               ) -> np.ndarray:
    """The per-base flag byte of the window walk from its numpy state:
    ``lowa``/``sok0``/``sok1`` bool, ``gcls_idx`` int64 (last
    gated-definite position at or before p, -1 if none; a running maximum,
    so ``gcls_idx[p] >= seed`` holds exactly when a gated-definite base
    lies in [seed, p]), ``gcls_val`` (its class); the arrays cover the
    positions from ``base`` on."""
    u8 = np.uint8
    return (lowa.astype(u8) * u8(F_LOWA) | sok0.astype(u8) * u8(F_SOK0)
            | sok1.astype(u8) * u8(F_SOK1)
            | (gcls_val == 1).astype(u8) * u8(F_GCLS1)
            | (gcls_idx == np.arange(base, base + len(gcls_idx))).astype(u8)
            * u8(F_GDEF))


def pack_outcomes(f1, begin, c_end, c_sd, n) -> torch.Tensor:
    """The five seed outcomes as one int64 [5, NS] tensor (c_sd by its
    bits), so a launch's results come back in one copy."""
    return torch.stack([f1, begin.to(torch.int64), c_end,
                        c_sd.view(torch.int64), n])


def unpack_outcomes(out: torch.Tensor):
    """(f1 int64, begin bool, c_end int64, c_sd f64, n int64) of a packed
    [5, NS] ``seed_eval`` result."""
    return (out[0], out[1].to(torch.bool), out[2], out[3].view(torch.float64),
            out[4])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.library("cnv")
    P, I, Lg, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, \
        ctypes.c_double
    _build.bind(lib, "gt_zscores",
                [P] * 11 + [Lg, I, I, I, I, D, D, D, I, P, P, P])
    lib.gt_zscores_scratch_bytes.restype = Lg
    lib.gt_zscores_scratch_bytes.argtypes = [Lg, I]
    _build.bind(lib, "gt_seed_eval",
                [P] * 3 + [Lg, Lg, Lg, D, Lg, P, P, Lg, P, P, P])
    lib.gt_seed_scratch_bytes.restype = Lg
    lib.gt_seed_scratch_bytes.argtypes = [Lg]
    lib.gt_null_scratch_bytes.restype = Lg
    lib.gt_null_scratch_bytes.argtypes = [Lg, Lg]
    _build.bind(lib, "gt_null_model", [P] * 3 + [Lg] * 4 + [P] * 4)
    return lib


def _require(name: str, x: torch.Tensor, dtype, device) -> None:
    if x.dtype != dtype or x.device != device or not x.is_contiguous():
        raise ValueError("%s must be a contiguous %s tensor on %s (got %s "
                         "on %s)" % (name, dtype, device, x.dtype, x.device))


def _dispatch(x: torch.Tensor, name: str) -> str:
    kind = x.device.type
    if kind not in ("cuda", "cpu"):
        raise ValueError("%s runs on cuda or cpu tensors, not %s"
                         % (name, kind))
    return kind


# ---------------------------------------------------------------------------
# z-scores
# ---------------------------------------------------------------------------

def _count_le(tables: CnvTables, r: torch.Tensor, key: torch.Tensor
              ) -> torch.Tensor:
    """#(row <= key) per query, from the count tables: ``r`` int64 [m, 5]
    the queries' row entries (nk >= 1), ``key`` int64 [m]."""
    nk, width, c_off, t_off, t_len = r.unbind(1)
    inside = (key >= 0) & (key < width)
    at = c_off + torch.minimum(key.clamp(min=0), width - 1)
    out = torch.where(inside, tables.cnt[at].to(torch.int64), 0)
    past = key >= width
    out = torch.where(past, nk - t_len, out)
    # keys past a capped table bisect the row's tail (a row with a tail
    # is the only one at its tail offset)
    far = torch.nonzero(past & (t_len > 0)).squeeze(1)
    for ro in torch.unique(t_off[far]).tolist():
        sel = far[t_off[far] == ro]
        tail = tables.tail[ro:ro + int(t_len[sel[0]])].to(torch.int64)
        out[sel] += torch.searchsorted(tail, key[sel], right=True)
    return out


def zscores_plain(zin: ZInputs, tables: CnvTables, nb: int, min_mapq: int,
                  mapq_factor: float, dup_thr_factor: float, ranks: bool,
                  out=None) -> torch.Tensor:
    """Per-base z over one block in plain torch, as the kernel computes
    it: the sticky class as a running maximum of idx * 2 + class, midrank
    counts from the count tables, the mapq weight in numpy's order (the
    kernel evaluates the z of each (bin row, depth) pair once and each
    mapq's weight once, the same operations on the same values). Returns
    f64 [n] (written into ``out`` when given)."""
    dev = zin.depth.device
    i64, f64 = torch.int64, torch.float64
    n = zin.depth.shape[0]
    d = zin.depth.to(i64)
    m = zin.mq.to(i64)
    g = zin.gc.to(i64)
    rows = tables.rows.view(-1, 5).to(i64)
    lens = rows[:, 0]
    hi_mq = m >= min_mapq
    defz = torch.where(hi_mq, 0, torch.where(d > 0, 1, -1))
    k_elig = torch.where(hi_mq, 0, nb) + g
    eligible = (zin.low_acgt == 0) & (lens[k_elig] > 1)
    # sticky class: forward fill of defz at eligible definite positions,
    # the class carried in the low bit of the filled index
    idx = torch.arange(n, device=dev)
    fi = torch.cummax(torch.where(eligible & (defz >= 0), idx * 2 + defz,
                                  -1), 0).values
    last_cls = torch.where(fi >= 0, fi & 1, 0)
    cls = torch.where(defz >= 0, defz, last_cls)
    k = cls * nb + g
    nk = lens[k]
    valid = eligible & (nk > 0)
    z = torch.zeros(n, dtype=f64, device=dev)
    v = torch.nonzero(valid).squeeze(1)
    if v.numel():
        kv, dv, nv = k[v], d[v], nk[v]
        av = tables.ave[kv]
        dd = dv.to(f64)
        below = dd < av
        clamp = dup_thr_factor * av
        if ranks:
            key_l = torch.where(dd > clamp, clamp.to(i64), dv)
            rv = rows[kv]
            cle = lambda key: _count_le(tables, rv, key)

            def fx(c):
                return torch.where((nv == 2) & (c == 0), 1, c)

            bi = torch.where(below, fx(cle(dv)), nv - fx(cle(key_l - 1)))
            bi2 = torch.where(below, fx(cle(dv - 1)), nv - fx(cle(dv)))
            di = torch.where(bi <= 0, 0.5, bi.to(f64))
            di2 = torch.where(bi2 <= 0, 0.5, bi2.to(f64))
            prob = (di + di2) / (2.0 * nv.to(f64))
            P = tables.pv_p.shape[0]
            pi = torch.searchsorted(tables.pv_p, prob,
                                    right=True).clamp(0, P - 1)
            base = torch.where(below, tables.pv_sd[pi], -tables.pv_sd[pi])
        else:
            sb = tables.std[kv]
            nz = sb != 0.0
            plain = torch.where(nz, (av - dd) / sb, 0.0)
            clamped = torch.where(nz, (dup_thr_factor - 1.0) * (-av) / sb,
                                  0.0)
            base = torch.where(below | ~(dd > clamp), plain, clamped)
        mv = m[v]
        omf = 1.0 - mapq_factor
        w = torch.where(mv >= min_mapq,
                        mapq_factor + (omf * (mv - min_mapq).to(f64)) / 40.0,
                        mapq_factor)
        z[v] = w * base
    if out is None:
        return z
    out.copy_(z)
    return out


def _zscores_cuda(zin: ZInputs, tables: CnvTables, nb: int, min_mapq: int,
                  mapq_factor: float, dup_thr_factor: float, ranks: bool,
                  out=None) -> torch.Tensor:
    dev = zin.depth.device
    n = int(zin.depth.shape[0])
    for name, dt in ZIN_DTYPES.items():
        x = getattr(zin, name)
        _require(name, x, dt, dev)
        if x.shape != (n,) or x.data_ptr() % 16:
            raise ValueError("%s must be a 16-byte aligned [%d] tensor"
                             % (name, n))
    for name, dt in TABLE_DTYPES.items():
        _require(name, getattr(tables, name), dt, dev)
    R = int(tables.ave.shape[0])
    P = int(tables.pv_p.shape[0])
    if tables.rows.numel() != 5 * R or R != 2 * nb:
        raise ValueError("the tables must hold 2 nb = %d bin rows" % (2 * nb))
    if n >= 1 << 30:
        raise ValueError("a z block of %d bases is past the kernel's "
                         "int32 indices" % n)
    if out is None:
        out = torch.empty(n, dtype=torch.float64, device=dev)
    elif (out.dtype != torch.float64 or out.device != dev
          or out.shape != (n,) or not out.is_contiguous()):
        raise ValueError("out must be a contiguous f64 [%d] tensor on %s"
                         % (n, dev))
    lib = _lib()
    scratch = torch.empty(lib.gt_zscores_scratch_bytes(n, R),
                          dtype=torch.uint8, device=dev)
    _build.check(lib, lib.gt_zscores(
        zin.depth.data_ptr(), zin.mq.data_ptr(), zin.gc.data_ptr(),
        zin.low_acgt.data_ptr(), tables.rows.data_ptr(),
        tables.cnt.data_ptr(), tables.tail.data_ptr(), tables.ave.data_ptr(),
        tables.std.data_ptr(), tables.pv_p.data_ptr(),
        tables.pv_sd.data_ptr(), n, R, P, nb, min_mapq, float(mapq_factor),
        1.0 - float(mapq_factor), float(dup_thr_factor), 1 if ranks else 0,
        scratch.data_ptr(), out.data_ptr(), _build.stream_ptr(dev)),
        "zscores")
    _build.LAUNCHES["zscores"] += 1
    return out


def zscores(zin: ZInputs, tables: CnvTables, nb: int, min_mapq: int,
            mapq_factor: float, dup_thr_factor: float, ranks: bool,
            out=None) -> torch.Tensor:
    """Per-base z over one block, mapq weight included (f64 [n], written
    into ``out`` when given): the CUDA kernel for CUDA tensors,
    ``zscores_plain`` for CPU tensors."""
    if _dispatch(zin.depth, "zscores") == "cuda":
        with torch.cuda.device(zin.depth.device):
            return _zscores_cuda(zin, tables, nb, min_mapq, mapq_factor,
                                 dup_thr_factor, ranks, out)
    return zscores_plain(zin, tables, nb, min_mapq, mapq_factor,
                         dup_thr_factor, ranks, out)


# ---------------------------------------------------------------------------
# seed evaluation
# ---------------------------------------------------------------------------

def _min_table(P: torch.Tensor) -> List[torch.Tensor]:
    """Sparse table of range minima: ``tab[k][x] = min(P[x:x + 2**k])``
    (over the shorter tail near the end)."""
    tab = [P]
    h = 1
    while 2 * h <= P.shape[0]:
        prev = tab[-1]
        cur = prev.clone()
        cur[:-h] = torch.minimum(prev[:-h], prev[h:])
        tab.append(cur)
        h *= 2
    return tab


def _first_at_most(P, tab, a, e, t):
    """Per query, the first x in [a, e] with P[x] <= t, else -1: binary
    lifting over the sparse table, skipping blocks whose minimum is above
    the threshold."""
    last = P.shape[0] - 1
    x = a.clone()
    for k in range(len(tab) - 1, -1, -1):
        step = 1 << k
        adv = (x + (step - 1) <= e) & (tab[k][x.clamp(max=last)] > t)
        x = torch.where(adv, x + step, x)
    hit = (x <= e) & (P[x.clamp(max=last)] <= t)
    return torch.where(hit, x, -1)


_CHUNK = 256     # window offsets per step of the f64 pass


def seed_eval_plain(si: SeedInputs, seeds, seed_cls, minw: int, maxw: int,
                    max_low: float, be: int):
    """First-window + grow phases of every seed, in plain torch. Returns
    the packed (f1 int64, begin bool, c_end int64, c_sd f64, n int64), each
    [NS] (``pack_outcomes``).

    The integer half needs no walk: ``2 * (gated bases before j) - j`` is a
    +-1 walk over the window, and the first fail is where it first reaches
    -1, found per seed by binary lifting over prefix sums (the seed's outer
    class up to its first gated-definite base, the global class from
    there). The f64 half walks only the seeds that can begin (first fail at
    or past minw, some non-zero z in the window), in chunks of offsets; the
    running total is a ``torch.cumsum`` seeded with the carry, sequential
    on the CPU, so it is accumulated in the host's order. A chunk's grow
    scores are evaluated only for seeds whose running total could reach
    3 there (an exact bound: the total must exceed 2.9 x the smallest
    count x window stdev of the chunk)."""
    dev = seeds.device
    i64, f64 = torch.int64, torch.float64
    NS = seeds.shape[0]
    L = si.svals.shape[0]
    n = (be - seeds).clamp(min=minw, max=maxw)
    f1 = n.clone()
    zero = torch.zeros(NS, dtype=i64, device=dev)
    if NS == 0:
        return pack_outcomes(f1, torch.zeros(0, dtype=torch.bool, device=dev),
                             zero, torch.zeros(0, dtype=f64, device=dev), n)

    # ---- the positions every window reaches, with "no data" (as grom_tpu
    # pads them) past the chromosome end and one chunk past the last window
    lo = int(seeds.min())
    hi = int((seeds + n).max())
    top = min(hi, L)

    def span(x, fill):
        pad = torch.full((hi - top + _CHUNK + 1,), fill, dtype=x.dtype,
                         device=dev)
        return torch.cat([x[lo:top], pad])

    def prefix(x):
        return torch.cat([torch.zeros(1, dtype=i64, device=dev),
                          torch.cumsum(x.to(i64), 0)])

    fl = span(si.flags, 0)
    bit = lambda f: (fl & f) != 0
    lw = bit(F_LOWA)
    inc = torch.stack([lw & bit(F_SOK0), lw & bit(F_SOK1)])
    incg = torch.where(bit(F_GCLS1), inc[1], inc[0])
    sv = span(si.svals, 0.0)
    zl = torch.where(lw, sv, 0.0)
    b = seeds - lo
    # windows read the outer class up to the first gated-definite base at
    # or after the seed, the global class from there
    gd = torch.nonzero(bit(F_GDEF)[:top - lo]).squeeze(1)
    if gd.numel():
        k = torch.searchsorted(gd, b)
        g = torch.where(k < gd.numel(), gd[k.clamp(max=gd.numel() - 1)],
                        top - lo)
    else:
        g = torch.full_like(b, top - lo)

    # ---- first fail: the +-1 walk first reaching -1 --------------------
    Pg = prefix(2 * incg.to(i64) - 1)
    tg = _min_table(Pg)
    for c in (0, 1):
        r = torch.nonzero(seed_cls == c).squeeze(1)
        if r.numel() == 0:
            continue
        Pm = prefix(2 * inc[c].to(i64) - 1)
        br, gr, nr = b[r], g[r], n[r]
        # outer class: positions b .. g - 1
        xa = _first_at_most(Pm, _min_table(Pm), br + 1,
                            torch.minimum(gr, br + nr), Pm[br] - 1)
        # global class from g on, continuing the walk
        xb = _first_at_most(Pg, tg, gr + 1, br + nr,
                            Pg[gr] - (Pm[gr] - Pm[br]) - 1)
        x = torch.where(xa >= 0, xa, xb)
        f1[r] = torch.where(x >= 0, x - br - 1, nr)

    # ---- f64 running totals of the seeds that can begin -----------------
    PL = prefix(lw)
    low_count0 = PL[b + minw] - PL[b]
    pos_sv, pos_zl = prefix(sv > 0.0), prefix(zl > 0.0)
    fc = f1.clamp(min=minw)
    # a score of 3 needs a positive running total, so some positive z in
    # the window (a sum of terms <= 0 stays <= 0 in any rounding); the
    # first window also needs gated bases, and so does the grow phase past
    # it (its good bases are gated)
    nz = ((pos_sv[b + minw] - pos_sv[b])
          + (pos_zl[b + fc] - pos_zl[b + minw]) > 0)
    grows = (f1 > minw) & (PL[b + fc] - PL[b + minw] > 0) & nz
    firsts = (f1 >= minw) & (low_count0 > 0) & nz
    f_end = torch.where(grows, f1, torch.where(firsts, minw, 0))
    live = f_end > 0
    lt = torch.zeros(NS, dtype=f64, device=dev)
    low_total0 = torch.zeros(NS, dtype=f64, device=dev)
    any_good = torch.zeros(NS, dtype=torch.bool, device=dev)
    lastg = torch.full((NS,), -1, dtype=i64, device=dev)
    c_sd_grow = torch.zeros(NS, dtype=f64, device=dev)
    ws = si.win_std
    live = torch.nonzero(live).squeeze(1)
    j0 = 0
    while live.numel():
        J = torch.arange(j0, j0 + _CHUNK, device=dev)
        bl = b[live]
        q = bl[:, None] + J
        alive = J < f_end[live][:, None]
        contrib = zl[q]
        if j0 < minw:
            contrib = torch.where(J < minw, sv[q], contrib)
        ltc = torch.cumsum(torch.cat([lt[live][:, None], contrib], 1),
                           1)[:, 1:]
        if j0 <= minw - 1 < j0 + _CHUNK:
            low_total0[live] = ltc[:, minw - 1 - j0]
        wl = J + 1
        wsg = ws[wl.clamp(max=maxw)]
        col = (J >= minw) & (wsg > 0.0)
        if bool(col.any()):
            # lower bound of the gated count over the chunk
            lcb = low_count0[live] + PL[bl + max(j0, minw)] - PL[bl + minw]
            top_lt = torch.where(alive & col, ltc, -torch.inf).max(1).values
            cand = (top_lt > 0.0) & (
                (lcb <= 0) | (top_lt >= 2.9 * lcb.to(f64) * wsg[col].min()))
            # no gated base at all up to the chunk's end: no good base
            lce = low_count0[live] + PL[bl + (f_end[live] - j0).clamp(
                max=_CHUNK) + j0] - PL[bl + minw]
            cand &= lce > 0
            if bool(cand.any()):
                cl = live[cand]
                qc = q[cand]
                lc = (low_count0[cl] - PL[b[cl] + minw])[:, None] + PL[qc + 1]
                incw = torch.where(qc >= g[cl][:, None], incg[qc],
                                   inc[seed_cls[cl].to(i64)[:, None], qc])
                tsg = torch.where((lc > 0) & (wsg > 0.0),
                                  ltc[cand] / (lc.to(f64) * wsg), 0.0)
                good = (alive[cand] & col & incw & (tsg >= 3.0)
                        & ((wl - lc).to(f64) / wl <= max_low))
                hit = good.any(1)
                if bool(hit.any()):
                    gl = cl[hit]
                    tmax = torch.where(good[hit], tsg[hit],
                                       -torch.inf).max(1).values
                    lastg[gl] = j0 + (_CHUNK - 1 - good[hit].flip(1).to(
                        torch.uint8).argmax(1))
                    better = ~any_good[gl] | (tmax > c_sd_grow[gl])
                    c_sd_grow[gl[better]] = tmax[better]
                    any_good[gl] = True
        last = (f_end[live] - j0).clamp(max=_CHUNK) - 1
        lt[live] = ltc[torch.arange(live.numel(), device=dev), last]
        live = live[f_end[live] > j0 + _CHUNK]
        j0 += _CHUNK

    ws_min = ws[minw]
    ts0 = torch.where((low_count0 > 0) & (ws_min > 0.0),
                      low_total0 / (low_count0.to(f64) * ws_min), 0.0)
    begin0 = ((f1 >= minw) & (low_count0 > 0) & (ws_min > 0.0)
              & (ts0 >= 3.0)
              & ((minw - low_count0).to(f64) / minw <= max_low))
    c_sd = torch.where(begin0, ts0, 0.0)
    c_sd = torch.where(any_good & (c_sd_grow > c_sd), c_sd_grow, c_sd)
    begin = begin0 | any_good
    c_end = torch.where(any_good, seeds + lastg,
                        torch.where(begin0, seeds + minw, 0))
    return pack_outcomes(f1, begin, c_end, c_sd, n)


def _seed_eval_cuda(si: SeedInputs, seeds, seed_cls, minw: int, maxw: int,
                    max_low: float, be: int):
    dev = seeds.device
    for name, dt in (("svals", torch.float64), ("flags", torch.uint8),
                     ("win_std", torch.float64)):
        _require(name, getattr(si, name), dt, dev)
    _require("seeds", seeds, torch.int64, dev)
    _require("seed_cls", seed_cls, torch.int8, dev)
    if si.flags.shape != si.svals.shape:
        raise ValueError("flags and svals must cover the same positions")
    if si.win_std.shape[0] != maxw + 1:
        raise ValueError("win_std must hold maxw + 1 entries")
    lib = _lib()
    NS = int(seeds.shape[0])
    out = torch.empty((5, NS), dtype=torch.int64, device=dev)
    scratch = torch.empty(lib.gt_seed_scratch_bytes(NS), dtype=torch.uint8,
                          device=dev)
    _build.check(lib, lib.gt_seed_eval(
        si.svals.data_ptr(), si.flags.data_ptr(), si.win_std.data_ptr(),
        int(si.svals.shape[0]), minw, maxw, float(max_low), be,
        seeds.data_ptr(), seed_cls.data_ptr(), NS, scratch.data_ptr(),
        out.data_ptr(), _build.stream_ptr(dev)), "seed_eval")
    _build.LAUNCHES["seed_eval"] += 1
    return out


def seed_eval(si: SeedInputs, seeds, seed_cls, minw: int, maxw: int,
              max_low: float, be: int):
    """Every seed's window outcome, packed (see ``seed_eval_plain``): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if _dispatch(seeds, "seed_eval") == "cuda":
        with torch.cuda.device(seeds.device):
            return _seed_eval_cuda(si, seeds, seed_cls, minw, maxw, max_low,
                                   be)
    return seed_eval_plain(si, seeds, seed_cls, minw, maxw, max_low, be)


# positions a block of seed_inputs' temporaries covers
SEED_INPUT_BLOCK = 1 << 24


def seed_inputs(depth, mq, gc, low_acgt, stdev_list, thr, win_std, cfg,
                L: int, side: int, device):
    """Host-side per-base state of the window scan (numpy) and the kernel's
    inputs on ``device``. Returns (defc, gcls_idx, sok0, sok1, svals, lowa,
    SeedInputs). The threshold gathers, the class of ``gcls_idx`` and the
    flag byte are made ``SEED_INPUT_BLOCK`` positions at a time, so beyond
    what it returns (21 bytes a base) it holds a block's temporaries
    only."""
    defc = np.where(mq >= cfg.min_mapq, np.int8(0),
                    np.where(depth > 0, np.int8(1), np.int8(-1)))
    lowa = low_acgt == 0
    gcls_idx = np.arange(L, dtype=np.int64)
    gcls_idx[~(lowa & (defc >= 0))] = -1
    np.maximum.accumulate(gcls_idx, out=gcls_idx)
    sok0 = np.empty(L, np.bool_)
    sok1 = np.empty(L, np.bool_)
    flags = np.empty(L, np.uint8)
    cmp = np.less_equal if side > 0 else np.greater_equal
    for b0 in range(0, L, SEED_INPUT_BLOCK):
        sl = slice(b0, min(b0 + SEED_INPUT_BLOCK, L))
        g = gc[sl]
        cmp(depth[sl], thr[0, g], out=sok0[sl])
        cmp(depth[sl], thr[1, g], out=sok1[sl])
        # the class at gcls_idx, defc[0] where it is -1
        flags[sl] = pack_flags(lowa[sl], sok0[sl], sok1[sl], gcls_idx[sl],
                               np.take(defc, gcls_idx[sl], mode="clip"), b0)
    svals = side * stdev_list
    to = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(
        device)
    si = SeedInputs(svals=to(svals, np.float64), flags=to(flags, np.uint8),
                    win_std=to(win_std, np.float64))
    return defc, gcls_idx, sok0, sok1, svals, lowa, si


# Seeds per seed_eval launch of the window scan: the walk evaluates the
# candidates from the first seed it needs onward, in the outer class it
# needs. Large batches fill the card; on the CPU the plain version pays for
# every seed it evaluates, and smaller batches skip the seeds inside calls.
SEED_BATCH = {"cuda": 1 << 16, "cpu": 1 << 10}


def window_scan(blocks, depth, mq, gc, nwin, low_acgt, stdev_list, thr,
                win_std, cfg, L, side: int, device) -> list:
    """Drop-in for call/cnv._window_scan with the per-seed window math in
    ``seed_eval``: candidate seeds are evaluated in batches, from the first
    seed the walk needs onward and in the outer class it needs there, and
    the host outer walk consumes the outcomes in the reference's order
    (jump/suppression after each emitted call), keeping the rare
    slide/trim phases sequential."""
    from grom_tpu_torch.call.cnv import CnvCall, _slide_phase, _trim_phase
    from grom_tpu_torch.utils.timing import phase

    minw = cfg.min_rd_window_len
    maxw = cfg.max_rd_window_len
    max_low = cfg.max_rd_low_acgt_or_windows
    out = []
    defc, gcls_idx, sok0, sok1, svals, lowa, si = seed_inputs(
        depth, mq, gc, low_acgt, stdev_list, thr, win_std, cfg, L, side,
        device)
    batch = SEED_BATCH[torch.device(device).type]

    for (bs, be0) in blocks:
        be = be0 - minw
        if be <= bs:
            continue
        cand = np.flatnonzero((sok0 | sok1)[bs:be]) + bs
        if not len(cand):
            continue
        # candidate index by position - bs: 4 bytes a position and no
        # Python object a candidate
        pos_to_i = np.full(be - bs, -1, np.int32)
        pos_to_i[cand - bs] = np.arange(len(cand), dtype=np.int32)
        pos_to_i = memoryview(pos_to_i)
        batches = {0: (0, 0, None), 1: (0, 0, None)}

        def evaluate(i0, cls):
            """Outcomes of candidates [i0, i0 + batch) in outer class
            ``cls``."""
            i1 = min(i0 + batch, len(cand))
            with phase("cnv.seed_eval_dev"):
                seeds = torch.from_numpy(cand[i0:i1]).to(device)
                cls_t = torch.full((i1 - i0,), cls, dtype=torch.int8,
                                   device=device)
                # one copy back per launch
                r = [x.numpy() for x in unpack_outcomes(seed_eval(
                    si, seeds, cls_t, minw, maxw, max_low, be).cpu())]
            return i0, i1, r

        # host outer walk (reference order; src/GROM.c:19358-19380)
        mq_index = 0
        pos = bs
        while pos < be:
            dc = defc[pos]
            if dc >= 0:
                mq_index = int(dc)
            sok_cls = sok0 if mq_index == 0 else sok1
            if not sok_cls[pos]:
                pos += 1
                continue
            i = pos_to_i[pos - bs]
            b_lo, b_hi, res = batches[mq_index]
            if not b_lo <= i < b_hi:
                b_lo, b_hi, res = batches[mq_index] = evaluate(i, mq_index)
            k = i - b_lo
            f1, begin, c_end, c_sd, n = (int(res[0][k]), bool(res[1][k]),
                                         int(res[2][k]), float(res[3][k]),
                                         int(res[4][k]))
            if f1 < minw:
                pos = pos + f1 + 1
                continue
            stop_base = f1 < n or n < maxw
            lp = pos + f1 if f1 < n else pos + n - 1
            q = gcls_idx[lp]
            mqi = int(defc[q]) if q >= pos else mq_index
            last_good = c_end if begin else 0
            if not stop_base and begin:
                c_end, c_sd, last_good, mqi = _slide_phase(
                    pos, maxw, L, maxw + 500, last_good, c_end, c_sd, mqi,
                    mq, depth, lowa, nwin, gc, svals, win_std, cfg,
                    3.0, max_low)
            if begin:
                c_end, _ = _trim_phase(pos, c_end, minw, mqi, mq, depth,
                                       lowa, sok0, sok1, cfg, max_low)
                out.append(CnvCall(pos, c_end, c_sd))
                pos = c_end + 2
            else:
                pos += 1
    return out


# ---------------------------------------------------------------------------
# null window model
# ---------------------------------------------------------------------------

class NullSegments(NamedTuple):
    """The null model's window segments in the host's walk order: start,
    length, window length carried in (``w``) and whether the carry resets
    (int64/bool numpy arrays [S])."""
    s: np.ndarray
    n: np.ndarray
    w: np.ndarray
    reset: np.ndarray


def null_segments(lowvar_blocks, maxw: int, sampling_rate: int
                  ) -> NullSegments:
    """Window boundaries per (block, phase): pure modular arithmetic,
    mirroring the host loop's carry rules (call/cnv.py:_null_window_model;
    a block resets the carry, a phase does not)."""
    seg_s, seg_n, seg_w = [], [], []
    for (bs, be) in lowvar_blocks:
        wl0 = 0
        for phase in range(sampling_rate):
            s = bs + phase * maxw // sampling_rate
            while s < be:
                e = min(s + maxw - wl0, be)
                seg_s.append(s)
                seg_n.append(e - s)
                seg_w.append(wl0)
                if wl0 + (e - s) < maxw:
                    wl0 += e - s
                    break
                wl0 = 0
                s = e
    w = np.asarray(seg_w, np.int64)
    return NullSegments(np.asarray(seg_s, np.int64),
                        np.asarray(seg_n, np.int64), w, w == 0)


def _carries(seg: NullSegments, lo: int, hi: int, seg_z: np.ndarray,
             seg_c: np.ndarray, run: list) -> Tuple[np.ndarray, np.ndarray]:
    """tot0/cnt0 of segments [lo, hi) in the host's order: the running
    total since the last reset, continued from ``run`` = [z, c]."""
    tot0 = np.zeros(hi - lo)
    cnt0 = np.zeros(hi - lo, np.int64)
    rz, rc = run
    for i in range(lo, hi):
        if seg.reset[i]:
            rz, rc = 0.0, 0
        tot0[i - lo] = rz
        cnt0[i - lo] = rc
        rz = rz + float(seg_z[i - lo])
        rc = rc + int(seg_c[i - lo])
    run[0], run[1] = rz, rc
    return tot0, cnt0


def _finish(sums: np.ndarray, counts: np.ndarray, minw: int) -> np.ndarray:
    win_std = np.zeros(len(sums))
    sel = counts > 1
    win_std[sel] = np.sqrt(sums[sel] / (counts[sel] - 1))
    win_std[:minw] = 0.0
    return win_std


def null_model_plain(z, gate, seg: NullSegments, minw: int, maxw: int,
                     batch: int = NULL_BATCH) -> np.ndarray:
    """Null window stdev in plain torch: per segment, the sequential prefix
    of gated z (``torch.cumsum``, sequential on the CPU) and of counts; per
    length, squared window means added in segment order. Returns f64
    [maxw + 1] (numpy)."""
    dev = z.device
    f64, i64 = torch.float64, torch.int64
    L = z.shape[0]
    zg = torch.where(gate, z, 0.0)
    cg = gate.to(i64)
    sums = torch.zeros(maxw + 1, dtype=f64, device=dev)
    counts = torch.zeros(maxw + 1, dtype=i64, device=dev)
    j = torch.arange(maxw, device=dev)
    run = [0.0, 0]
    S = len(seg.s)
    for b0 in range(0, S, batch):
        b1 = min(b0 + batch, S)
        s = torch.from_numpy(seg.s[b0:b1]).to(dev)
        nn = torch.from_numpy(seg.n[b0:b1]).to(dev)
        act = j[None, :] < nn[:, None]
        x = torch.where(act, s[:, None] + j[None, :], 0).clamp(max=L - 1)
        pz = torch.cumsum(torch.where(act, zg[x], 0.0), 1)
        pc = torch.cumsum(torch.where(act, cg[x], 0), 1)
        last = nn - 1
        rows = torch.arange(b1 - b0, device=dev)
        tot0, cnt0 = _carries(seg, b0, b1, pz[rows, last].cpu().numpy(),
                              pc[rows, last].cpu().numpy(), run)
        for i in range(b1 - b0):
            ni = int(seg.n[b0 + i])
            lens = int(seg.w[b0 + i]) + 1 + j[:ni]
            c = int(cnt0[i]) + pc[i, :ni]
            ok = (lens >= minw) & (c > 0)
            v = (float(tot0[i]) + pz[i, :ni][ok]) / c[ok].to(f64)
            sums.index_add_(0, lens[ok], v * v)
            counts.index_add_(0, lens[ok], torch.ones_like(lens[ok]))
    return _finish(sums.cpu().numpy(), counts.cpu().numpy(), minw)


def _segment_rows(seg: NullSegments, device) -> torch.Tensor:
    """The segments as one int64 [4, S] tensor (start, length, carried
    window length, reset) on ``device``: one upload."""
    return torch.from_numpy(np.stack([seg.s, seg.n, seg.w,
                                      seg.reset.astype(np.int64)])).to(device)


def _null_model_cuda(z, gate, seg: NullSegments, minw: int, maxw: int,
                     batch: int, pass_ms=None) -> np.ndarray:
    dev = z.device
    _require("z", z, torch.float64, dev)
    _require("gate", gate, torch.bool, dev)
    lib = _lib()
    S = len(seg.s)
    B = max(1, min(batch, S))
    segs = _segment_rows(seg, dev)
    scratch = torch.empty(lib.gt_null_scratch_bytes(B, maxw),
                          dtype=torch.uint8, device=dev)
    out = torch.empty((2, maxw + 1), dtype=torch.int64, device=dev)
    _build.check(lib, lib.gt_null_model(
        z.data_ptr(), gate.data_ptr(), segs.data_ptr(), S, minw, maxw, B,
        scratch.data_ptr(), out.data_ptr(),
        None if pass_ms is None else pass_ms.ctypes.data,
        _build.stream_ptr(dev)), "null_model")
    out = out.cpu()                    # the one copy back
    return _finish(out[0].view(torch.float64).numpy(), out[1].numpy(), minw)


def null_pass_ms(z, gate, seg: NullSegments, minw: int, maxw: int,
                 batch: int = NULL_BATCH) -> dict:
    """Card milliseconds of each pass of one CUDA null model, summed over
    its batches (CUDA events between the launches); a measurement, not
    counted in ``LAUNCHES``."""
    ms = np.zeros(3, np.float32)
    with torch.cuda.device(z.device):
        _null_model_cuda(z, gate, seg, minw, maxw, batch, pass_ms=ms)
    return {"null_prefix": float(ms[0]), "null_carry": float(ms[1]),
            "null_accum": float(ms[2])}


def null_model(z, gate, seg: NullSegments, minw: int, maxw: int,
               batch: int = NULL_BATCH) -> np.ndarray:
    """Per-length null window stdev, f64 [maxw + 1] (numpy), from the
    per-base z (f64) and gate (bool) tensors, ``batch`` segments at a
    time: the CUDA kernel for CUDA tensors, ``null_model_plain`` for CPU
    tensors. Bitwise equal to the host's ``_null_window_model``."""
    if _dispatch(z, "null_model") == "cuda":
        with torch.cuda.device(z.device):
            res = _null_model_cuda(z, gate, seg, minw, maxw, batch)
        _build.LAUNCHES["null_model"] += 1
        return res
    return null_model_plain(z, gate, seg, minw, maxw, batch)
