"""Paired-end/split-read SV detection, clustering and emission:
DEL / DUP / INV / INS plus the per-chromosome CTX (translocation) candidate
records consumed by the cross-chromosome merge.

Re-expresses the reference's per-position detectors (src/GROM.c:11750-13553),
the list→list2 clustering (src/GROM.c:15140-16250) and the emitters
(DUP :15340, INV :15940/15996, INS :16084, CTX :16168/16244, DEL :16557).

Detection is sparse: a vectorized screen finds positions whose primary
evidence clears ``min_disc``; the exact sequential pairing/bisect logic then
runs over those positions in order. The reference's interpolation-seeded
bisection (src/GROM.c:12629-12770) only prunes — its inner distance/position
filters are authoritative — so we reproduce the scanned index range
[last_le(lo_target), first_ge(hi_target)) with searchsorted.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from grom_tpu_torch.call.scan import ChromArrays
from grom_tpu_torch.config import DerivedConfig, GromConfig


@dataclass
class BkptSide:
    """One breakpoint's snapshot (start or end side of a candidate)."""
    pos: int = -1
    binom: float = 0.0
    hez: float = 2.0
    ev: int = 0          # scaled evidence count (del_f etc.)
    rd: int = 0
    conc: int = 0
    other_len: int = 0
    read_start: int = 0
    read_end: int = 0


@dataclass
class SvCandidate:
    start: BkptSide = field(default_factory=BkptSide)
    end: BkptSide = field(default_factory=BkptSide)
    dist: float = 0.0


@dataclass
class CtxCandidate:
    pos: int
    binom: float
    hez: float
    ev: int
    rd: int
    conc: int
    other_len: int
    mchr: int
    mpos: int            # int truncation of the running mean (±strand sign)
    read_start: int
    read_end: int


def _binom_pair(rd: int, strong: int, weak: int, mq_table, hez_table,
                af: int, max_trials: int, gate_weak: Optional[int] = None,
                gate_strong: Optional[int] = None) -> Tuple[float, float]:
    """The per-detector probability pattern (e.g. src/GROM.c:11966-12010):
    binom from strong evidence vs rd; hez (default 2.0) from strong+weak when
    gate_weak/gate_strong <= max_evidence_ratio.

    gate_weak/gate_strong default to weak/strong; ctx_r's rd<=max_trials
    branch passes the ctx_f-side values to reproduce the reference's
    copy-paste bug at src/GROM.c:12068 (0/0 → NaN → gate fails → hez 2.0).
    A zero gate_strong divides by zero in float like the reference (inf or
    NaN compare false unless weak is 0 too... 0/0 is NaN → false).
    """
    def gate_ok(w, s):
        with np.errstate(divide="ignore", invalid="ignore"):
            r = np.float32(w) / np.float32(s)
        return bool(r <= np.float32(0.25))

    hez = 2.0
    if rd > max_trials:
        k = strong * max_trials // (af * rd)
        binom = mq_table[max_trials][min(k, max_trials)]
        if gate_ok(weak, strong):
            k2 = (strong + weak) // af
            if k2 < rd:
                k2i = (strong + weak) * max_trials // (af * rd)
                hez = hez_table[max_trials][min(k2i, max_trials)]
            else:
                hez = hez_table[max_trials][max_trials]
    else:
        binom = mq_table[rd][min(strong // af, max_trials)]
        gw = weak if gate_weak is None else gate_weak
        gs = strong if gate_strong is None else gate_strong
        if gate_ok(gw, gs):
            k2 = (strong + weak) // af
            if k2 < rd:
                hez = hez_table[rd][k2]
            else:
                hez = hez_table[rd][rd]
    return float(binom), float(hez)


def _scan_range(starts: List[int], lo_target: int, hi_target: int) -> Tuple[int, int]:
    """Candidate index range the reference's double bisect scans
    (src/GROM.c:12615-12780): [last_le(lo_target), first_ge(hi_target)),
    swapped if inverted, clamped to [0, n]."""
    arr = starts  # ascending
    import bisect as _b
    a = _b.bisect_left(arr, hi_target)          # first_ge(hi)
    b = max(_b.bisect_right(arr, lo_target) - 1, 0)  # last_le(lo)
    lo, hi = (b, a) if b <= a else (a, b)
    return lo, hi


class SvDetector:
    """Runs the sequential per-position SV detection. State (the candidate
    lists and the INS state machine) persists across ``run_chunk`` calls, so
    the streamed driver can feed drained [lo, hi) windows in ascending order
    and get byte-identical results to one whole-chromosome pass."""

    def __init__(self, chrom_len: int, cfg: GromConfig, drv: DerivedConfig,
                 mq_table, hez_table):
        self.L = chrom_len
        self.cfg = cfg
        self.drv = drv
        self.mq = mq_table
        self.hez = hez_table
        self.af = cfg.add_factor
        self.lo_gate = 2 * cfg.overlap_mult * drv.insert_max

        self.scorer = None   # ops/sv_device.DeviceSvScorer when a device
                             # engine should run the screen's score math

        self.ins_list: List[SvCandidate] = []
        self.dup_list: List[SvCandidate] = []
        self.dup_starts: List[int] = []
        self.del_list: List[SvCandidate] = []
        self.del_starts: List[int] = []
        self.inv_f_list: List[SvCandidate] = []
        self.inv_f_starts: List[int] = []
        self.inv_r_list: List[SvCandidate] = []
        self.inv_r_starts: List[int] = []
        self.ctx_f_list: List[CtxCandidate] = []
        self.ctx_r_list: List[CtxCandidate] = []

    # -- main ---------------------------------------------------------------

    def run_chunk(self, ev, dense, lo: int, hi: int, scan_start: int,
                  scan_end: int) -> None:
        """Detect over [lo, hi): the vectorized screen (sv_screen.py) scores
        every soft-clip position and SV-family evidence entry of the window
        in one batch of table gathers, then the exact sequential tail
        (_consume) walks the accepted actions in the reference's order.
        ``ev`` is the window's EvidenceChunk; ``dense`` the drained
        DenseArrays whose arrays start at ``dense.base`` (whole-chromosome
        runs pass base 0). ``self.scorer`` (set by the driver for device
        engines, ops/sv_device.py) moves the entry score math onto the
        attached accelerator."""
        from grom_tpu_torch.call import sv_screen
        acts = sv_screen.screen_window(ev, dense, lo, hi, self.cfg, self.drv,
                                       self.mq, self.hez, self.lo_gate,
                                       scan_start, scan_end, self.L,
                                       scorer=self.scorer)
        self._consume(acts)

    def _consume(self, a) -> None:
        """Sequential tail over the accepted actions — candidate list caps,
        bisect end-matching and the INS state machine, byte-identical to the
        reference's scalar walk (src/GROM.c:11750-13553)."""
        from grom_tpu_torch.call.sv_screen import (K_CTX_F, K_CTX_R, K_DEL_END,
                                             K_DEL_START, K_DUP_END,
                                             K_DUP_START, K_INS_END,
                                             K_INVF_END, K_INVF_START,
                                             K_INVR_END, K_INVR_START)
        cfg, drv = self.cfg, self.drv
        cap = cfg.sv_list_len - 1
        mean = drv.insert_mean
        lseq = drv.read_len
        tolw = cfg.range_mult_tol(drv)
        # (start_list, starts, dmin/dmax dist shift, lo_t/hi_t pos shift,
        #  equal-binom tie >=) per end kind; DEL's >= reproduces
        # src/GROM.c:12785 (the LAST tied position wins, unlike DUP/INV)
        end_rule = {
            K_DUP_END: (self.dup_list, self.dup_starts, 2 * lseq,
                        -mean + 2 * lseq, False),
            K_DEL_END: (self.del_list, self.del_starts, 0, mean, True),
            K_INVF_END: (self.inv_f_list, self.inv_f_starts, lseq, lseq,
                         False),
            K_INVR_END: (self.inv_r_list, self.inv_r_starts, lseq, lseq,
                         False),
        }
        start_rule = {
            K_DUP_START: (self.dup_list, self.dup_starts),
            K_DEL_START: (self.del_list, self.del_starts),
            K_INVF_START: (self.inv_f_list, self.inv_f_starts),
            K_INVR_START: (self.inv_r_list, self.inv_r_starts),
        }
        for i in range(len(a)):
            kind = int(a.kind[i])
            pos = int(a.pos[i])
            binom = float(a.binom[i])
            evc = int(a.ev[i])
            rd = int(a.rd[i])
            conc = int(a.conc[i])
            ol = int(a.other_len[i])
            if kind <= K_INS_END:
                self._ins_update(pos, binom, evc, rd, conc, ol,
                                 "start" if kind == 0 else "end")
                continue
            hez = float(a.hez[i])
            if kind == K_CTX_F or kind == K_CTX_R:
                lst = self.ctx_f_list if kind == K_CTX_F else self.ctx_r_list
                if len(lst) < cap:
                    lst.append(CtxCandidate(
                        pos, binom, hez, evc, rd, conc, ol,
                        int(a.mchr[i]), int(a.dist[i]),
                        int(a.rs[i]), int(a.re[i])))
                continue
            side = BkptSide(pos=pos, binom=binom, hez=hez, ev=evc, rd=rd,
                            conc=conc, other_len=ol,
                            read_start=int(a.rs[i]), read_end=int(a.re[i]))
            if kind in start_rule:
                lst, starts = start_rule[kind]
                if len(lst) < cap:
                    c = SvCandidate()
                    c.start = side
                    c.dist = float(a.dist[i])
                    lst.append(c)
                    starts.append(pos)
                continue
            lst, starts, dshift, pshift, tie_ge = end_rule[kind]
            dist = float(a.dist[i])
            dmin = int(dist + dshift - tolw + 0.5)
            dmax = int(dist + dshift + tolw + 0.5)
            lo_t = pos + pshift - dmax
            hi_t = pos + pshift - dmin
            sa, sb = _scan_range(starts, lo_t, hi_t)
            for j in range(sa, sb):
                c = lst[j]
                if dmin <= c.dist <= dmax and lo_t <= c.start.pos <= hi_t:
                    e = c.end
                    if ((e.binom > binom and evc >= e.ev) or e.pos == -1
                            or (e.binom == binom
                                and (evc >= e.ev if tie_ge else evc > e.ev))):
                        c.end = side

    # -- INS state machine (shared index), src/GROM.c:11765-11960 ----------

    def _ins_update(self, pos: int, binom: float, ins_ev: int, rd: int,
                    conc: int, other_len: int, side: str) -> None:
        cfg = self.cfg
        fields = BkptSide(pos=pos, binom=binom, ev=ins_ev,
                          rd=rd, conc=conc, other_len=other_len)
        lst = self.ins_list
        if not lst:
            c = SvCandidate()
            setattr(c, side, fields)
            lst.append(c)
            return
        cur = lst[-1]
        far = ((cur.start.pos != -1 and pos - cur.start.pos > cfg.sc_range) or
               (cur.end.pos != -1 and pos - cur.end.pos > cfg.sc_range))
        if far:
            if len(lst) < cfg.sv_list_len - 1:
                c = SvCandidate()
                setattr(c, side, fields)
                lst.append(c)
        else:
            cs = getattr(cur, side)
            if cs.pos == -1 or binom < cs.binom:
                setattr(cur, side, fields)


# ---------------------------------------------------------------------------
# Clustering (list → list2), src/GROM.c:15140-16250
# ---------------------------------------------------------------------------

def cluster_paired(cands: List[SvCandidate], cfg: GromConfig,
                   drv: DerivedConfig) -> List[SvCandidate]:
    """DEL/DUP/INV template: sequential clusters keyed on start proximity;
    representative replaced by strictly-better candidates, midpoint-merged on
    exact ties (src/GROM.c:15345-15530)."""
    out: List[SvCandidate] = []
    gap = drv.insert_max - 2 * drv.read_len
    begin = False
    first_start = last_start = first_end = last_end = 0
    first_dist = last_dist = 0.0
    for c in cands:
        if begin:
            if c.start.pos > last_start + gap:
                begin = False
            else:
                rep = out[-1]
                cmax = max(c.start.binom, c.end.binom)
                rmax = max(rep.start.binom, rep.end.binom)
                if (cmax <= rmax and c.start.pos >= 0 and c.end.pos >= 0
                        and rep.start.ev <= c.start.ev and rep.end.ev <= c.end.ev):
                    if (c.start.binom == rep.start.binom
                            and c.end.binom == rep.end.binom):
                        if ((rep.start.ev < c.start.ev and rep.end.ev <= c.end.ev)
                                or (rep.start.ev <= c.start.ev and rep.end.ev < c.end.ev)):
                            first_start = last_start = c.start.pos
                            first_end = last_end = c.end.pos
                            first_dist = last_dist = c.dist
                            out[-1] = _copy_cand(c)
                        elif rep.start.ev == c.start.ev and rep.end.ev == c.end.ev:
                            last_start = c.start.pos
                            last_end = c.end.pos
                            last_dist = c.dist
                            nc = _copy_cand(c)
                            nc.start.pos = (first_start + last_start) // 2
                            nc.end.pos = (first_end + last_end) // 2
                            nc.dist = (first_dist + last_dist) / 2.0
                            # midpoint merge keeps the candidate's ev values
                            out[-1] = nc
                    else:
                        first_start = last_start = c.start.pos
                        first_end = last_end = c.end.pos
                        first_dist = last_dist = c.dist
                        out[-1] = _copy_cand(c)
        if not begin:
            if c.start.pos >= 0 and c.end.pos >= 0:
                if len(out) < cfg.sv_list_len - 1:
                    begin = True
                    first_start = last_start = c.start.pos
                    first_end = last_end = c.end.pos
                    first_dist = last_dist = c.dist
                    out.append(_copy_cand(c))
    return out


def _copy_cand(c: SvCandidate) -> SvCandidate:
    import copy
    return copy.deepcopy(c)


def cluster_ins(cands: List[SvCandidate], cfg: GromConfig,
                drv: DerivedConfig) -> List[SvCandidate]:
    """INS clustering (src/GROM.c:16013-16082)."""
    out: List[SvCandidate] = []
    gap = drv.insert_max - 2 * drv.read_len
    begin = False
    for c in cands:
        if begin:
            rep = out[-1]
            if (c.start.pos > rep.start.pos + gap or c.start.pos > rep.end.pos + gap
                    or c.end.pos > rep.start.pos + gap or c.end.pos > rep.end.pos + gap):
                begin = False
            else:
                if (c.start.binom <= rep.start.binom and c.start.pos >= 0
                        and c.end.binom <= rep.end.binom and c.end.pos >= 0):
                    out[-1] = _copy_cand(c)
        if not begin:
            if c.start.pos >= 0 and c.end.pos >= 0:
                begin = True
                out.append(_copy_cand(c))
    return out


def cluster_ctx(cands: List[CtxCandidate], cfg: GromConfig,
                drv: DerivedConfig) -> List[CtxCandidate]:
    """CTX clustering (src/GROM.c:16104-16166): keep the best per cluster."""
    out: List[CtxCandidate] = []
    gap = drv.insert_max - 2 * drv.read_len
    begin = False
    for c in cands:
        if begin:
            rep = out[-1]
            if c.pos > rep.pos + gap:
                begin = False
            else:
                if (((c.binom < rep.binom and rep.ev <= c.ev)
                     or (c.binom == rep.binom and rep.ev < c.ev))
                        and c.pos >= 0):
                    out[-1] = c
        if not begin:
            if c.pos >= 0:
                begin = True
                out.append(c)
    return out


# ---------------------------------------------------------------------------
# Emission
# ---------------------------------------------------------------------------

def _pass_sv(c: SvCandidate, cfg: GromConfig) -> bool:
    af = float(cfg.add_factor)
    t = cfg.pval_threshold
    return ((c.start.binom <= t or c.start.hez <= t)
            and (c.end.binom <= t or c.end.hez <= t)
            and (c.start.ev / c.start.rd if c.start.rd else math.inf) >= cfg.min_sv_ratio * af
            and (c.end.ev / c.end.rd if c.end.rd else math.inf) >= cfg.min_sv_ratio * af)


_SV_FMT = ("%s\t%d\t.\t.\t<%s>\t.\t.\tEND=%d\t"
           "SPR:EPR:SEV:EEV:SRD:ERD:SCO:ECO:SOT:EOT:SFR:SLR:EFR:ELR\t"
           "%e:%e:%.1f:%.1f:%d:%d:%d:%d:%d:%d:%d:%d:%d:%d")

# tabular (-f) paired-SV row (src/GROM.c:15347 DUP, :15947/:16003 INV_F/R,
# :16564 DEL): 0-based coordinates, raw (unscaled) evidence ints, hez CDFs
_SV_TAB_FMT = ("%s\t%s\t%d\t%d\t%6.2f\t%e\t%e\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t"
               "%d\t%d\t%d\t%d\t%d\t%e\t%e")


def _sv_row(chr_name: str, typ: str, c: SvCandidate, cfg: GromConfig,
            tab_typ: str = "") -> str:
    af = float(cfg.add_factor)
    if not cfg.vcf_output:
        return _SV_TAB_FMT % (
            tab_typ or typ, chr_name, c.start.pos, c.end.pos, c.dist,
            c.start.binom, c.end.binom, c.start.ev, c.end.ev,
            c.start.rd, c.end.rd, c.start.conc, c.end.conc,
            c.start.other_len, c.end.other_len,
            c.start.read_start, c.start.read_end,
            c.end.read_start, c.end.read_end, c.start.hez, c.end.hez)
    return _SV_FMT % (
        chr_name, c.start.pos + 1, typ, c.end.pos + 1, c.start.binom,
        c.end.binom, c.start.ev / af, c.end.ev / af, c.start.rd, c.end.rd,
        c.start.conc, c.end.conc, c.start.other_len, c.end.other_len,
        c.start.read_start + 1, c.start.read_end + 1,
        c.end.read_start + 1, c.end.read_end + 1)


def format_dup_rows(chr_name, dup2, cfg) -> List[str]:
    return [_sv_row(chr_name, "DUP", c, cfg) for c in dup2 if _pass_sv(c, cfg)]


def format_inv_rows(chr_name, inv_f2, inv_r2, arr: ChromArrays, cfg,
                    drv) -> List[str]:
    """INV emission with cross-family dedup and flank depth symmetry filter
    (src/GROM.c:15896-16010). INV_F ties beat INV_R."""
    rows = []
    lseq = drv.read_len
    L = arr.chr_len
    lim = drv.insert_max - 2 * lseq

    def flank_ave(rs, re):
        # per-candidate slice sum (exact int64) — the round-3 whole-
        # chromosome depth cumsum was an O(L) 8B/base transient
        a = max(min(rs, L), 0)
        b = max(min(re + lseq, L), 0)
        n = re + lseq - rs
        if n == 0:
            return math.nan
        x, y, sgn = (a, b, 1) if b >= a else (b, a, -1)
        tot = sgn * (int(arr.rd_hi[x:y].astype(np.int64).sum())
                     + int(arr.rd_lo[x:y].astype(np.int64).sum()))
        return float(tot) / n

    def rd_sym(c):
        r1 = flank_ave(c.start.read_start, c.start.read_end)
        r2 = flank_ave(c.end.read_start, c.end.read_end)
        with np.errstate(divide="ignore", invalid="ignore"):
            a = np.float64(r1) / np.float64(r2)
            b = np.float64(r2) / np.float64(r1)
        return bool(a <= cfg.max_inv_rd_diff) and bool(b <= cfg.max_inv_rd_diff)

    for c in inv_f2:
        if not _pass_sv(c, cfg):
            continue
        lose = any(
            abs(c.start.pos - r.start.pos) < lim and abs(c.end.pos - r.end.pos) < lim
            and ((r.start.pos <= c.start.pos <= r.end.pos)
                 or (c.start.pos <= r.start.pos <= c.end.pos))
            and r.start.binom * r.end.binom < c.start.binom * c.end.binom
            for r in inv_r2)
        if not lose and rd_sym(c):
            rows.append(_sv_row(chr_name, "INV", c, cfg, tab_typ="INV_F"))
    for c in inv_r2:
        if not _pass_sv(c, cfg):
            continue
        lose = any(
            abs(c.start.pos - f.start.pos) < lim and abs(c.end.pos - f.end.pos) < lim
            and ((f.start.pos <= c.start.pos <= f.end.pos)
                 or (c.start.pos <= f.start.pos <= c.end.pos))
            and f.start.binom * f.end.binom <= c.start.binom * c.end.binom
            for f in inv_f2)
        if not lose and rd_sym(c):
            rows.append(_sv_row(chr_name, "INV", c, cfg, tab_typ="INV_R"))
    return rows


def format_ins_rows(chr_name, ins2, cfg) -> List[str]:
    """INS emission (src/GROM.c:16084-16100): END prints the START again."""
    af = float(cfg.add_factor)
    rows = []
    for c in ins2:
        if (c.start.binom <= cfg.pval_insertion and c.end.binom <= cfg.pval_insertion
                and abs(c.end.pos - c.start.pos) <= cfg.max_ins_range):
            if not cfg.vcf_output:
                # tabular (src/GROM.c:16091): empty 5th column, raw counts
                rows.append(
                    "INS\t%s\t%d\t%d\t\t%e\t%e\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d"
                    % (chr_name, c.start.pos, c.end.pos, c.start.binom,
                       c.end.binom, c.start.ev, c.end.ev, c.start.rd,
                       c.end.rd, c.start.conc, c.end.conc,
                       c.start.other_len, c.end.other_len))
                continue
            rows.append(
                "%s\t%d\t.\t.\t<INS>\t.\t.\tEND=%d\tSPR:EPR:SEV:EEV:SRD:ERD:SCO:ECO:SOT:EOT\t"
                "%e:%e:%.1f:%.1f:%d:%d:%d:%d:%d:%d"
                % (chr_name, c.start.pos + 1, c.start.pos + 1, c.start.binom,
                   c.end.binom, c.start.ev / af, c.end.ev / af, c.start.rd,
                   c.end.rd, c.start.conc, c.end.conc, c.start.other_len,
                   c.end.other_len))
    return rows


def format_del_rows(chr_name, del2, indel_dels, d_index, cfg, drv) -> List[str]:
    """DEL emission (src/GROM.c:16543-16630) with the indel-overlap dedup
    (ties favor the indel). ``indel_dels``/``d_index`` are the small-indel
    candidates (the same off-by-one bound applies)."""
    from grom_tpu_torch.call.indel import _overlap_ratios_del2
    af = float(cfg.add_factor)
    lim = drv.insert_max - 2 * drv.read_len
    rows = []
    for c in del2:
        if not _pass_sv(c, cfg):
            continue
        overlap = False
        for b in range(max(d_index, 0)):
            i = indel_dels[b]
            if not (i.start_binom <= cfg.pval_threshold
                    and i.end_binom <= cfg.pval_threshold
                    and (i.f / i.start_rd if i.start_rd else math.inf) > cfg.min_indel_ratio * af
                    and (i.r / i.end_rd if i.end_rd else math.inf) > cfg.min_indel_ratio * af
                    and abs(c.start.pos - i.start) < lim
                    and abs(c.end.pos - i.end) < lim):
                continue
            r1, r2 = _overlap_ratios_del2(c.start.pos, c.end.pos, i.start, i.end)
            if (r1 >= cfg.min_overlap_ratio and r2 >= cfg.min_overlap_ratio
                    and i.start_binom * i.end_binom <= c.start.binom * c.end.binom):
                overlap = True
                break
        if not overlap:
            rows.append(_sv_row(chr_name, "DEL", c, cfg))
    return rows


def format_ctx_records(chr_name, ctx_f2, ctx_r2, cfg) -> List[str]:
    """Per-chromosome CTX intermediate records (src/GROM.c:16168-16248),
    consumed by the cross-chromosome merge in the driver."""
    af = float(cfg.add_factor)
    out = []
    for tag, lst in (("CTX_F", ctx_f2), ("CTX_R", ctx_r2)):
        for c in lst:
            if ((c.binom <= cfg.pval_threshold or c.hez <= cfg.pval_threshold)
                    and (c.ev / c.rd if c.rd else math.inf) >= cfg.min_sv_ratio * af):
                out.append("%s\t%s\t%d\t%e\t%.1f\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%e"
                           % (tag, chr_name, c.pos, c.binom, c.ev / af, c.rd,
                              c.conc, c.other_len, c.mchr, c.mpos,
                              c.read_start, c.read_end, c.hez))
    return out
