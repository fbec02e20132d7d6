"""The CNV rows of GROM's read-depth caller, worked out again from the
plain reference's depth lists and GC-bin samples (``plainref.cnv_state``),
in NumPy, independent of the program.

GROM's stages (src/GROM.c:18683-20035), each in float64 as the
configuration states, or in float32 for the control:

* the per-base z-score: the midrank of the base's depth in its GC bin's
  sorted sample, read through GROM's p-value to SD table, signed, and
  weighted by the base's mean mapq;
* the null window model: the RMS of window means of z over GROM's sampled
  windows of every length from ``min_rd_window_len`` to
  ``max_rd_window_len``, with its window state carried across sampling
  phases as GROM carries it;
* the seed walk: from every base whose depth passes the class's threshold,
  a window grows while at least half of its gated bases pass; a window
  whose mean z over its null SD reaches 3 makes a call, which slides at
  the longest window and is trimmed at its end;
* the row: SD, its p-value by GROM's erf polynomial (with its
  ``1 + p + x`` slip), CN and CS from ``plainref.copy_number``; rows with a
  p-value at or above ``rd_pval_threshold`` are not written.

Each seed's first window is evaluated for all seeds at once (its first
fail is where a +-1 walk over the window first reaches -1); the seeds that
survive it are grown one at a time, with sums accumulated in GROM's
sequential order. The grow, slide and trim rules follow the host engine's
scan of the program (``call/cnv.py _window_scan``), which the program's
own tests hold to GROM's binary; the device engine the benchmark times
runs other code for them (``ops/cnv_device.py`` and ``csrc/cnv.cu``).
GROM's repeat rescoring is not modelled: a contig with a dinucleotide
repeat type biased enough to trigger it is refused.
"""

from __future__ import annotations

import bisect
import math
from typing import List, Tuple

import numpy as np

# GROM's defaults (src/GROM.c; the port's config.py) for what the
# configuration files do not state
MIN_SD = 3.0                 # g_one_base_read_depth_min_rd_low_stdev
MAX_LOW = 2.0                # g_max_rd_low_acgt_or_windows
MAPQ_FACTOR = 0.5            # -F
DUP_FACTOR = 2               # -L
MAX_W = 10000                # -X
SAMPLING_RATE = 2            # -A
MIN_REPEAT = 20              # -D
RD_PVAL = 1e-9               # -V
_AP, _A1, _A2, _A3, _A4, _A5 = (0.3275911, 0.254829592, -0.284496736,
                                1.421413741, -1.453152027, 1.061405429)
_PAIRS = [b"AA", b"AC", b"AG", b"AT", b"CC", b"CG", b"CT", b"GG", b"GT",
          b"TT"]


def pval_table() -> Tuple[np.ndarray, np.ndarray]:
    """GROM's p-value to SD table (src/GROM.c:20714-20748): SD from 10 down
    to 0 by 0.01, p ascending, evaluated with libm's pow and exp."""
    n = int(10.0 / 0.01 + 0.5) + 1
    sds, ps = np.empty(n), np.empty(n)
    for i in range(n):
        sd = max(10.0 - i * 0.01, 0.0)
        x = sd / math.sqrt(2.0)
        t = 1.0 / (1.0 + _AP * x)
        erf = 1.0 - ((_A1 * t + _A2 * math.pow(t, 2) + _A3 * math.pow(t, 3)
                      + _A4 * math.pow(t, 4) + _A5 * math.pow(t, 5))
                     * math.exp(-math.pow(x, 2)))
        sds[i], ps[i] = sd, (1.0 - erf) / 2.0
    return ps, sds


def sd_to_pvalue(sd: float) -> float:
    """GROM's SD to p-value, with ``t = 1 / (1 + p + x)`` (src/GROM.c:17158)
    where Abramowitz-Stegun have ``1 / (1 + p x)``."""
    x = abs(sd) / math.sqrt(2.0)
    t = 1.0 / (1.0 + _AP + x)
    erf = 1.0 - (_A1 * t + _A2 * t**2 + _A3 * t**3 + _A4 * t**4
                 + _A5 * t**5) * math.exp(-x**2)
    return (1.0 - erf) / 2.0


def repeat_runs(genome: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Runs of at least ``MIN_REPEAT`` bases of one dinucleotide class in
    [lo, hi), counted a class (src/GROM.c:1727-1764)."""
    lut = np.full((256, 256), 10, np.int8)
    for t, (a, b) in enumerate(_PAIRS):
        for x in (a, a | 0x20):
            for y in (b, b | 0x20):
                lut[x, y] = lut[y, x] = t
    out = np.zeros(10, np.int64)
    if hi - lo < 2:
        return out
    pc = lut[genome[lo:hi], genome[lo + 1:hi + 1]]
    cut = np.flatnonzero(pc[1:] != pc[:-1]) + 1
    starts = np.concatenate([[0], cut])
    ends = np.concatenate([cut, [hi - lo]])
    t = pc[starts]
    ok = (t < 10) & (ends < hi - lo) & (ends - starts >= MIN_REPEAT)
    np.add.at(out, t[ok].astype(np.int64), 1)
    return out


def zscores(st, g: dict, ft=np.float64) -> np.ndarray:
    """Each base's weighted z-score over [m - 1, L - 2m + 1), 0 elsewhere
    (src/GROM.c:18770-18965)."""
    L, m = len(st.depth), st.mean
    lo, hi = m - 1, L - (2 * m - 1)
    z = np.zeros(L, ft)
    if hi <= lo:
        return z
    ps, sds = pval_table()
    ps, sds = ps.astype(ft), sds.astype(ft)
    d, mq, gc = st.depth[lo:hi], st.mq_mean[lo:hi], st.gc[lo:hi]
    hi_mq = mq >= g["min_mapq"]
    elig = (st.low_acgt[lo:hi] == 0) & (st.nwin[np.where(hi_mq, 0, 1), gc] > 1)
    defz = np.where(hi_mq, 0, np.where(d > 0, 1, -1))
    # a base of no class takes the class of the last eligible base that
    # had one (0 before any)
    last = np.where(elig & (defz >= 0), np.arange(hi - lo), -1)
    np.maximum.accumulate(last, out=last)
    cls = np.where(defz >= 0, defz,
                   np.where(last >= 0, defz[np.maximum(last, 0)], 0))
    valid = elig & (st.nwin[cls, gc] > 0)
    base = np.zeros(hi - lo, ft)
    key = cls * 101 + gc
    for k in np.unique(key[valid]):
        at = np.flatnonzero(valid & (key == k))
        c, b = divmod(int(k), 101)
        arr = st.samples[c][b]
        n = len(arr)
        dv = d[at]
        ave = st.ave[c, b]

        def rank(x, side):
            r = np.searchsorted(arr, x, side)
            # GROM's bisection answers 1 where a textbook one answers 0,
            # for a sample of two
            return np.where(r == 0, 1, r) if n == 2 else r

        below = dv < ave
        clamp = DUP_FACTOR * ave
        key_hi = np.where(dv > clamp, np.int64(clamp), dv)
        r1 = np.where(below, rank(dv, "right"), n - rank(key_hi, "left"))
        r2 = np.where(below, rank(dv, "left"), n - rank(dv, "right"))
        d1 = np.where(r1 <= 0, 0.5, r1.astype(np.float64))
        d2 = np.where(r2 <= 0, 0.5, r2.astype(np.float64))
        prob = ((d1 + d2) / (2 * n)).astype(ft)
        pi = np.clip(np.searchsorted(ps, prob, "right"), 0, len(ps) - 1)
        base[at] = np.where(below, sds[pi], -sds[pi])
    w = np.where(hi_mq, ft(MAPQ_FACTOR) + ft(1.0 - MAPQ_FACTOR)
                 * (mq - g["min_mapq"]).astype(ft) / ft(40.0),
                 ft(MAPQ_FACTOR)).astype(ft)
    z[lo:hi] = np.where(valid, w * base, 0)
    return z


def null_model(st, z: np.ndarray, g: dict, ft=np.float64) -> np.ndarray:
    """The null SD of a window of each length: the RMS of the mean gated z
    of GROM's sampled windows (src/GROM.c:18975-19015, :19180-19215). Each
    sampling phase starts ``phase * maxw / rate`` into a block; a window
    that the block's end cuts off carries on into the next phase."""
    minw, maxw = g["min_rd_window_len"], MAX_W
    hi_mq = st.mq_mean >= g["min_mapq"]
    gate = (st.low_acgt == 0) & (st.nwin[np.where(hi_mq, 0, 1), st.gc] > 1)
    zg = np.where(gate, z, 0).astype(ft)
    sums = np.zeros(maxw + 1, ft)
    counts = np.zeros(maxw + 1, np.int64)
    for bs, be in st.blocks:
        wl, tot, cnt = 0, ft(0), 0
        for phase in range(SAMPLING_RATE):
            s = bs + phase * maxw // SAMPLING_RATE
            while s < be:
                e = min(s + maxw - wl, be)
                zc = tot + np.concatenate([[ft(0)], np.cumsum(zg[s:e])])
                cc = cnt + np.concatenate([[0], np.cumsum(gate[s:e])])
                lens = np.arange(wl + 1, wl + (e - s) + 1)
                keep = (lens >= minw) & (cc[1:] > 0)
                v = (zc[1:][keep] / cc[1:][keep].astype(ft)).astype(ft)
                sums[lens[keep]] += v * v
                counts[lens[keep]] += 1
                if wl + (e - s) < maxw:
                    wl, tot, cnt = wl + (e - s), zc[-1], int(cc[-1])
                    break
                wl, tot, cnt = 0, ft(0), 0
                s = e
    out = np.zeros(maxw + 1, ft)
    ok = counts > 1
    ok[:minw] = False
    out[ok] = np.sqrt(sums[ok] / (counts[ok] - 1).astype(ft))
    return out


class _Walk:
    """One side of the seed walk (``side`` +1 for deletions, -1 for
    duplications) over one contig's arrays."""

    def __init__(self, st, z, win_std, thr, side, g, ft):
        L = len(st.depth)
        self.g, self.ft, self.L = g, ft, L
        mq, depth, gc = st.mq_mean, st.depth, st.gc
        self.mq, self.depth, self.gc, self.nwin = mq, depth, gc, st.nwin
        self.defc = np.where(mq >= g["min_mapq"], 0,
                             np.where(depth > 0, 1, -1)).astype(np.int8)
        idx = np.arange(L)
        self.ld_all = np.where(self.defc >= 0, idx, -1)
        np.maximum.accumulate(self.ld_all, out=self.ld_all)
        self.lowa = st.low_acgt == 0
        self.ld_gated = np.where(self.lowa & (self.defc >= 0), idx, -1)
        np.maximum.accumulate(self.ld_gated, out=self.ld_gated)
        self.defg = self.defc[np.maximum(self.ld_gated, 0)]
        cmp = np.less_equal if side > 0 else np.greater_equal
        self.sok = (cmp(depth, thr[0, gc]), cmp(depth, thr[1, gc]))
        self.svals = (side * z).astype(ft)
        self.win_std = win_std

    def gated_class(self, p: int, start: int, fallback: int) -> int:
        q = self.ld_gated[p]
        return int(self.defc[q]) if q >= start else fallback

    def first_fails(self, seeds: np.ndarray, cls: np.ndarray, n: int
                    ) -> np.ndarray:
        """The first fail of each seed's window within ``n`` bases (``n``
        if none): the base where twice the passing gated bases before it
        fall below its window length, the +-1 walk first at -1."""
        out = np.empty(len(seeds), np.int64)
        for c0 in range(0, len(seeds), 50_000):
            s = seeds[c0:c0 + 50_000]
            at = np.minimum(s[:, None] + np.arange(n), self.L - 1)
            c = np.where(self.ld_gated[at] >= s[:, None], self.defg[at],
                         cls[c0:c0 + 50_000, None])
            inc = self.lowa[at] & np.where(c == 0, self.sok[0][at],
                                           self.sok[1][at])
            walk = np.cumsum(2 * inc.astype(np.int64) - 1, axis=1)
            hit = walk < 0
            out[c0:c0 + len(s)] = np.where(hit.any(1), hit.argmax(1), n)
        return out

    def grow(self, pos: int, mq_index: int, be: int):
        """The whole evaluation of a seed that passed its first window's
        fail test: (begin, c_start, c_end, c_sd, next_pos)."""
        g, ft, minw = self.g, self.ft, self.g["min_rd_window_len"]
        n = max(minw, min(MAX_W, be - pos))
        f1 = int(self.first_fails(np.array([pos]), np.array([mq_index]),
                                  n)[0])
        lowa, svals, ws_all = self.lowa, self.svals, self.win_std
        begin, c_start, c_end, c_sd, last_good = False, 0, 0, ft(0), 0
        lc0 = int(lowa[pos:pos + minw].sum())
        lt0 = np.cumsum(svals[pos:pos + minw])[-1]
        if lc0 > 0 and ws_all[minw] > 0:
            ts0 = lt0 / (ft(lc0) * ws_all[minw])
            if ts0 >= MIN_SD and (minw - lc0) / minw <= MAX_LOW:
                begin, c_start, c_end, c_sd = True, pos, pos + minw, ts0
                last_good = pos + minw
        stop = f1 < n or n < MAX_W
        if f1 > minw:
            sl = slice(pos + minw, pos + f1)
            lt = np.cumsum(np.concatenate(
                [[lt0], np.where(lowa[sl], svals[sl], 0)]).astype(ft))[1:]
            lc = lc0 + np.cumsum(lowa[sl])
            wl = np.arange(minw + 1, f1 + 1)
            ws = ws_all[wl]
            with np.errstate(divide="ignore", invalid="ignore"):
                ts = np.where((lc > 0) & (ws > 0),
                              lt / (lc.astype(ft) * ws), 0).astype(ft)
            at = np.arange(pos + minw, pos + f1)
            c = np.where(self.ld_gated[at] >= pos, self.defg[at], mq_index)
            inc = lowa[sl] & np.where(c == 0, self.sok[0][sl],
                                      self.sok[1][sl])
            good = np.flatnonzero(inc & (ws > 0) & (ts >= MIN_SD)
                                  & ((wl - lc) / wl <= MAX_LOW))
            if len(good):
                if not begin:
                    begin, c_start = True, pos
                last_good = c_end = pos + minw + int(good[-1])
                c_sd = max(c_sd, ts[good].max())
        last = pos + f1 if f1 < n else pos + n - 1
        mqi = self.gated_class(last, pos, mq_index)
        if not begin:
            return False, 0, 0, 0.0, pos + 1
        if not stop:
            c_end, c_sd, mqi = self.slide(pos, last_good, c_end, c_sd, mqi)
        c_end = self.trim(c_start, c_end, mqi)
        return True, c_start, c_end, float(c_sd), c_end + 2

    def _class(self, p: int, cur: int) -> int:
        if self.mq[p] >= self.g["min_mapq"]:
            return 0
        return 1 if self.depth[p] > 0 else cur

    def _counts(self, p: int, c: int) -> bool:
        return bool(self.lowa[p]) and self.nwin[c, self.gc[p]] > 1

    def slide(self, pos, last_good, c_end, c_sd, mqi):
        """The longest window slides on while it scores (src/GROM.c:
        19510-19600); the class of its trailing edge is the one of the
        first pass over it."""
        ft, W = self.ft, MAX_W
        pa, tot, cnt, mqb = pos + W, ft(0), 0, mqi
        while pa < self.L and pa - last_good <= W + 500:
            if pa == pos + W:
                for pb in range(pa - W + 1, pa + 1):
                    mqb = self._class(pb, mqb)
                    if self._counts(pb, mqb):
                        tot, cnt = ft(tot + self.svals[pb]), cnt + 1
            else:
                pb = pa - W
                mqb = self._class(pb, mqb)
                if self._counts(pb, mqb):
                    tot, cnt = ft(tot - self.svals[pb]), cnt - 1
                mqi = self._class(pa, mqi)
                if self._counts(pa, mqi):
                    tot, cnt = ft(tot + self.svals[pa]), cnt + 1
            ws = self.win_std[W]
            if cnt > 0 and ws > 0 and (W - cnt) / W <= MAX_LOW:
                ts = ft(tot / (ft(cnt) * ws))
                if ts >= MIN_SD:
                    last_good = c_end = pa
                    c_sd = max(c_sd, ts)
            pa += 1
        return c_end, c_sd, mqi

    def trim(self, c_start, c_end, mqi) -> int:
        """The call's end is cut back over bases that fail or where fewer
        than half the gated bases pass (src/GROM.c:19585-19660)."""
        minw = self.g["min_rd_window_len"]
        pos = c_end
        while pos > c_start + minw:
            mqi = self._class(pos, mqi)
            if not self.sok[mqi][pos]:
                pos -= 1
                c_end = pos
                continue
            passed = gated = 0
            pa, mqa = c_end, mqi
            while pa > c_start + minw:
                if self.lowa[pa]:
                    mqa = self._class(pa, mqa)
                    gated += 1
                    passed += bool(self.sok[mqa][pa])
                span = c_end - pa + 1
                if (gated == 0 or passed / gated < 0.5
                        or (span - gated) / float(span) > MAX_LOW):
                    c_end = pa - 1
                    pa -= 1
                    break
                pa -= 1
            pos = pa
        return c_end

    def _walk_prefix(self, inc: np.ndarray):
        """(P, sorted keys) of a +-1 walk: P[x] the walk's sum over bases
        before x, and the keys (P - min) * (L + 2) + x sorted, so that the
        first x after a base with P[x] at a value is one search away."""
        P = np.concatenate([[0], np.cumsum(2 * inc.astype(np.int64) - 1)])
        lo = int(P.min())
        return P, np.sort((P - lo) * (self.L + 2) + np.arange(self.L + 1)), lo

    def _first_at(self, walk, after: np.ndarray, value: np.ndarray
                  ) -> np.ndarray:
        """The first x > ``after`` with P[x] == ``value`` (L + 1 if none)."""
        P, keys, lo = walk
        span = self.L + 2
        want = (value - lo) * span + after + 1
        at = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
        hit = (value >= lo) & ((keys[at] // span) == (value - lo))
        return np.where(hit, keys[at] % span, self.L + 1)

    def fails_known(self, seeds: np.ndarray, cls: np.ndarray, n: np.ndarray
                    ) -> np.ndarray:
        """The first fails (capped at ``n``) of seeds whose class needs no
        walk state. A window reads the seed's class up to the first gated
        base of a class at or after the seed (g), the global class from
        there, so its +-1 walk is one prefix sum before g and another from
        g on; it fails where it first falls to -1, at most one search in
        each."""
        lowa, sok = self.lowa, self.sok
        if not hasattr(self, "_walks"):
            gdef = np.flatnonzero(lowa & (self.defc >= 0))
            incg = lowa & np.where(self.defg == 0, sok[0], sok[1])
            self._walks = (gdef, self._walk_prefix(incg), {})
        gdef, wg, wc = self._walks
        k = np.searchsorted(gdef, seeds)
        g = np.where(k < len(gdef), gdef[np.minimum(k, len(gdef) - 1)],
                     self.L)
        x = np.full(len(seeds), self.L + 1, np.int64)
        for c in (0, 1):
            sel = np.flatnonzero((cls == c) & (g > seeds))
            if not len(sel):
                continue
            if c not in wc:
                wc[c] = self._walk_prefix(lowa & sok[c])
            Pc = wc[c][0]
            b, gg = seeds[sel], g[sel]
            xa = self._first_at(wc[c], b, Pc[b] - 1)
            before = xa <= gg
            x[sel[before]] = xa[before]
            rest = sel[~before]
            b, gg = seeds[rest], g[rest]
            inside = gg < self.L
            xb = self._first_at(wg, gg, wg[0][np.minimum(gg, self.L)]
                                - (Pc[gg] - Pc[b]) - 1)
            x[rest] = np.where(inside, xb, self.L + 1)
        at_g = g == seeds
        b = seeds[at_g]
        x[at_g] = self._first_at(wg, b, wg[0][b] - 1)
        return np.minimum(x - seeds - 1, n)

    def begins(self, seeds: np.ndarray, cls: np.ndarray, f1: np.ndarray
               ) -> np.ndarray:
        """Whether each seed (first fail ``f1`` >= minw) makes a call: its
        first window scores, or a grown window that passes scores. Windows
        are scored exactly, with sums in GROM's sequential order, only
        where a bound from prefix sums over chunks of 32 offsets leaves a
        score of 3 possible."""
        minw, ft = self.g["min_rd_window_len"], self.ft
        if not hasattr(self, "_sums"):
            sv = self.svals.astype(np.float64)
            pre = lambda x: np.concatenate([[0.0], np.cumsum(x)])
            self._sums = (pre(sv), pre(np.maximum(sv, 0)), pre(np.abs(sv)),
                          np.concatenate([[0], np.cumsum(self.lowa)]))
        S, Sp, Sa, C = self._sums
        tol = 1e-3 if ft == np.float32 else 1e-9
        ws = self.win_std.astype(np.float64)
        out = self._first_window(seeds)
        # chunk [k0, k1) of offsets: the total there is at most the total
        # before k0 plus the positive terms of the chunk, and the bar at
        # least 3 x the count before k0 x the chunk's least null SD
        width = int(f1.max(initial=minw))
        k0 = np.arange(minw, max(width, minw + 1), 32)
        k1 = np.minimum(k0 + 32, MAX_W)
        wsmin = np.array([ws[a + 1:b + 1].min() for a, b in zip(k0, k1)])
        maybe = np.zeros(len(seeds), bool)
        for r0 in range(0, len(seeds), 1 << 14):
            b = seeds[r0:r0 + (1 << 14), None]
            f = f1[r0:r0 + (1 << 14), None]
            e0 = np.minimum(b + k0, self.L)
            e1 = np.minimum(b + np.minimum(k1, f), self.L)
            top = S[e0] - S[b] + (Sp[e1] - Sp[e0]) \
                + tol * (Sa[e1] - Sa[b]) + 1e-12
            bar = MIN_SD * (C[np.minimum(b + k0, self.L)] - C[b]) * wsmin
            maybe[r0:r0 + len(b)] = ((top >= bar) & (top > 0)
                                     & (k0 < f)).any(1)
        pick = np.flatnonzero(maybe & ~out)
        if len(pick):
            out[pick] = self._grown(seeds[pick], cls[pick], f1[pick])
        return out

    def _first_window(self, seeds: np.ndarray) -> np.ndarray:
        minw, ft = self.g["min_rd_window_len"], self.ft
        at = seeds[:, None] + np.arange(minw)
        lt0 = np.cumsum(self.svals[at], axis=1)[:, -1]
        lc0 = self.lowa[at].sum(1)
        ws0 = self.win_std[minw]
        with np.errstate(divide="ignore", invalid="ignore"):
            return (lc0 > 0) & (ws0 > 0) & (
                lt0 / (lc0.astype(ft) * ws0) >= MIN_SD) & (
                (minw - lc0) / minw <= MAX_LOW)

    def _grown(self, seeds: np.ndarray, cls: np.ndarray, f1: np.ndarray
               ) -> np.ndarray:
        """Whether a grown window of each seed passes and scores, exactly."""
        minw, ft = self.g["min_rd_window_len"], self.ft
        out = np.zeros(len(seeds), bool)
        order = np.argsort(f1, kind="stable")
        r0 = 0
        while r0 < len(order):
            rows = max(1, (1 << 22) // max(int(f1[order[r0]]), 1))
            r1 = min(r0 + rows, len(order))
            width = int(f1[order[r1 - 1]])
            pick = order[r0:r1]
            s, c, f = seeds[pick], cls[pick], f1[pick]
            at = np.minimum(s[:, None] + np.arange(width), self.L - 1)
            sv, lw = self.svals[at], self.lowa[at]
            lt0 = np.cumsum(sv[:, :minw], axis=1)[:, -1]
            lc0 = lw[:, :minw].sum(1)
            if width > minw:
                lt = np.cumsum(np.concatenate(
                    [lt0[:, None], np.where(lw, sv, 0)[:, minw:]],
                    axis=1).astype(ft), axis=1)[:, 1:]
                lc = lc0[:, None] + np.cumsum(lw[:, minw:], axis=1)
                wl = np.arange(minw + 1, width + 1)
                ws = self.win_std[wl][None, :]
                a2 = at[:, minw:]
                cw = np.where(self.ld_gated[a2] >= s[:, None], self.defg[a2],
                              c[:, None])
                inc = lw[:, minw:] & np.where(cw == 0, self.sok[0][a2],
                                              self.sok[1][a2])
                with np.errstate(divide="ignore", invalid="ignore"):
                    ts = np.where((lc > 0) & (ws > 0), lt / (lc * ws), 0)
                good = inc & (ws > 0) & (ts >= MIN_SD) & (
                    (wl - lc) / wl <= MAX_LOW) & (
                    np.arange(minw, width)[None, :] < f[:, None])
                out[pick] = good.any(1)
            r0 = r1
        return out

    def calls(self, bs: int, be0: int) -> List[Tuple[int, int, float]]:
        """GROM's walk over one block: each seed's first fail and whether it
        begins a call are worked out for all seeds at once where they need
        no walk state (gated seeds of a class); the walk then visits the
        seeds in order and grows the ones that begin, one at a time."""
        minw = self.g["min_rd_window_len"]
        be = be0 - minw
        if be <= bs:
            return []
        defc, sok = self.defc, self.sok
        seg = slice(bs, be)
        cand = np.flatnonzero(np.where(defc[seg] == 0, sok[0][seg],
                                       np.where(defc[seg] == 1, sok[1][seg],
                                                sok[0][seg] | sok[1][seg])))
        cand = cand + bs
        n = np.maximum(minw, np.minimum(MAX_W, be - cand))
        known = defc[cand] >= 0
        f1 = np.full(len(cand), -1, np.int64)
        f1[known] = self.fails_known(cand[known],
                                     defc[cand[known]].astype(np.int64),
                                     n[known])
        # whether a seed begins is worked out when the walk first reaches
        # it, for it and the seeds the walk would visit next if none of
        # them began (a batch that doubles while none does)
        begin = np.full(len(cand), -1, np.int8)
        cl, fl = cand.tolist(), f1.tolist()
        kl = known.tolist()
        batch = 64

        def ahead(i: int) -> List[int]:
            out, j, budget = [], i, 1 << 22
            while j < len(cl) and len(out) < batch and budget > 0:
                if not kl[j]:
                    break
                if fl[j] >= minw:
                    if begin[j] < 0:
                        out.append(j)
                        budget -= fl[j]
                    j += 1
                else:
                    j = bisect.bisect_left(cl, cl[j] + fl[j] + 1)
            return out

        out = []
        run_start, ll0, i = bs, 0, 0
        while i < len(cl):
            pos = cl[i]
            dc = int(defc[pos])
            if dc >= 0:
                mq_index = dc
            else:
                q = self.ld_all[pos]
                mq_index = int(defc[q]) if q >= run_start else ll0
            if not sok[mq_index][pos]:
                i += 1
                continue
            if kl[i]:
                f = fl[i]
            else:
                f = int(self.first_fails(np.array([pos]),
                                         np.array([mq_index]), minw)[0])
            if kl[i] and f >= minw and begin[i] < 0:
                idx = np.array(ahead(i), np.int64)
                got = self.begins(cand[idx], defc[cand[idx]].astype(np.int64),
                                  f1[idx])
                begin[idx] = got
                batch = 64 if got.any() else min(2 * batch, 1 << 16)
            if f < minw:
                next_pos = pos + f + 1
            elif kl[i] and not begin[i]:
                next_pos = pos + 1
            else:
                began, cs, ce, sd, next_pos = self.grow(pos, mq_index, be)
                if began:
                    out.append((cs, ce, sd))
            q = self.ld_all[pos]
            ll0 = int(defc[q]) if q >= run_start else ll0
            run_start = next_pos
            i = bisect.bisect_left(cl, next_pos)
        return out


def cnv_calls(st, genome: np.ndarray, g: dict, prec: str = "stated"
              ) -> Tuple[List[tuple], List[tuple]]:
    """(deletions, duplications) of one contig: (start, end, SD) each, in
    the order GROM writes them."""
    ft = np.float32 if prec == "lower" else np.float64
    L, m = len(st.depth), st.mean
    lo, hi = m - 1, L - (2 * m - 1)
    runs = repeat_runs(genome, lo, hi)
    if runs.max(initial=0) > 100:
        raise NotImplementedError("a repeat class of %d runs: GROM would "
                                  "rescore it" % runs.max())
    z = zscores(st, g, ft)
    win_std = null_model(st, z, g, ft)
    ploidy = g["ploidy"]
    thr_del = (1.0 - 0.6 / ploidy) * st.ave
    thr_dup = (1.0 + 0.6 / ploidy) * st.ave
    out = []
    for thr, side in ((thr_del, +1), (thr_dup, -1)):
        out.append(_Walk(st, z, win_std, thr, side, g, ft).calls(lo, hi))
    return out[0], out[1]
