"""Small-indel detection and emission.

Re-expresses the reference's per-position INDEL_INS / INDEL_DEL logic
(src/GROM.c:11340-11750) and the emission pass (src/GROM.c:16249-16560).
Detection is a sparse event walk: only positions whose indel evidence clears
``min_disc`` matter, so we vectorize the threshold screen and run the exact
start/end pairing state machine over the surviving positions in order.

Reference quirks reproduced:
  * the INDEL_DEL emission loop runs ``a < index`` — the final (still "open")
    candidate entry is never emitted (src/GROM.c:16349);
  * homopolymer run #2 compares against ``ref_char + 1`` — an off-by-one on
    the character value, so it is almost always 1 (src/GROM.c:16278,16447);
  * insertion END is -1+1=0; several emitted fields come from untouched
    (zero) memory;
  * VCF sample columns are printed in C argument order, which does NOT match
    the FORMAT labels for INDEL_DEL (SRD:ERD get the conc values, SOT:EOT get
    the rd values, src/GROM.c:16482).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from grom_tpu_torch.call.deposits import (DenseArrays, E_INDEL_D_F, E_INDEL_D_R,
                                    E_INDEL_I, EvidenceState)
from grom_tpu_torch.call.scan import ChromArrays
from grom_tpu_torch.config import DerivedConfig, GromConfig


@dataclass
class InsCandidate:
    start: int
    binom: float
    hez: float
    dist: int
    conc: int
    i: int
    rd: int
    sc: int
    other_len: int
    seq: Optional[bytes]


@dataclass
class DelCandidate:
    start: int = -1
    end: int = -1
    start_binom: float = 0.0
    start_hez: float = 0.0
    start_conc: int = 0
    f: int = 0
    start_rd: int = 0
    start_sc: int = 0
    start_other_len: int = 0
    end_binom: float = 0.0
    end_hez: float = 0.0
    end_conc: int = 0
    r: int = 0
    end_rd: int = 0
    end_sc: int = 0
    end_other_len: int = 0


class IndelDetector:
    """Sequential INDEL_INS / INDEL_DEL state machine over sparse indel
    events. State persists across ``run_chunk`` calls so the streamed driver
    can feed drained position windows in ascending order; the result is
    byte-identical to one whole-chromosome pass (the round-3 detect_indels).

    ``d_index`` mirrors the reference's cdp_indel_d_list_index so the emitter
    can reproduce the off-by-one (last entry dropped)."""

    def __init__(self, chrom_len: int, cfg: GromConfig, drv: DerivedConfig,
                 mq_table: np.ndarray, hez_table: np.ndarray):
        self.L = chrom_len
        self.cfg = cfg
        self.drv = drv
        self.mq = mq_table
        self.hez = hez_table
        self.lo_gate = 2 * cfg.overlap_mult * drv.insert_max
        self.ins_list: List[InsCandidate] = []
        self.del_list: List[DelCandidate] = []
        self.d_index = -1

    def run_chunk(self, ev, dense, lo: int, hi: int,
                  base_tot: np.ndarray, bt_base: int,
                  scan_start: int, scan_end: int) -> None:
        """Consume the indel events of [lo, hi). ``dense`` arrays start at
        ``dense.base`` (with >= 1 position of final halo past ``hi`` for the
        sc_left[pos+1] read); ``base_tot`` (per-base SNV totals) starts at
        ``bt_base``.

        Like the SV screen (sv_screen.py), the per-event score math —
        binomial-table gathers + integer gates, src/GROM.c:11340-11750 —
        is batched over the whole window; only the accepted events reach
        the sequential INDEL_DEL state machine below."""
        cfg = self.cfg
        L = self.L
        ins_list, del_list = self.ins_list, self.del_list

        (idx, kinds, binoms, hezs, counts, rds) = self._score_events(
            ev, dense, lo, hi, base_tot, bt_base, scan_start, scan_end)
        base = dense.base
        for w in range(len(idx)):
            i = int(idx[w])
            pos = int(ev.pos[i])
            kind = int(kinds[w])
            binom = float(binoms[w])
            hez = float(hezs[w])
            pb = pos - base
            if kind == 0:
                if len(ins_list) < cfg.sv_list_len - 1:
                    sc = int(dense.sc_left[pb + 1]) if pos + 1 < L else 0
                    sc += int(dense.sc_right[pb])
                    seq = None
                    if ev.seq_len[i] >= 0:
                        o = int(ev.seq_off[i])
                        seq = ev.seq_arena[o:o + int(ev.seq_len[i])]
                    ins_list.append(InsCandidate(
                        start=pos, binom=binom, hez=hez,
                        dist=int(ev.dist[i]), conc=int(dense.conc[pb]),
                        i=int(counts[w]), rd=int(rds[w]), sc=sc,
                        other_len=ev.other_len(pos), seq=seq))
            elif kind == 1:
                fields = dict(start=pos, start_binom=binom,
                              start_hez=hez,
                              start_conc=int(dense.conc[pb]),
                              f=int(counts[w]), start_rd=int(rds[w]),
                              start_sc=int(dense.sc_right[pb]),
                              start_other_len=ev.other_len(pos))
                if self.d_index == -1:
                    self.d_index = 0
                    del_list.append(DelCandidate(**fields))
                else:
                    cur = del_list[self.d_index]
                    if cur.start != -1 and cur.end != -1:
                        if self.d_index < cfg.sv_list_len - 1:
                            self.d_index += 1
                            del_list.append(DelCandidate(**fields))
                    elif (pos - cur.start > self.drv.read_len
                          and cur.end == -1) or binom < cur.start_binom:
                        old_end = cur.end
                        for k2, v in fields.items():
                            setattr(cur, k2, v)
                        if old_end < cur.start:
                            cur.end = -1
                        else:
                            cur.end = old_end
            else:  # kind == 2: d_r
                if self.d_index < 0:
                    continue
                cur = del_list[self.d_index]
                dist_ok = (float(pos) - float(cur.start)
                           - float(ev.dist[i])) < 5.0
                set_end = False
                if dist_ok and cur.start != -1 and cur.end != -1:
                    set_end = True
                elif dist_ok and (cur.end == -1 or binom < cur.end_binom):
                    set_end = True
                if set_end:
                    cur.end = pos
                    cur.end_binom = binom
                    cur.end_hez = hez
                    cur.end_conc = int(dense.conc[pb])
                    cur.r = int(counts[w])
                    cur.end_rd = int(rds[w])
                    cur.end_sc = int(dense.sc_left[pb])
                    cur.end_other_len = ev.other_len(pos)

    def _score_events(self, ev, dense, lo: int, hi: int,
                      base_tot: np.ndarray, bt_base: int,
                      scan_start: int, scan_end: int):
        """Batched score pass: returns (entry index, kind, binom, hez,
        count, trials) arrays for the ACCEPTED indel events of [lo, hi),
        in (pos, kind) order — exactly the events the scalar walk would
        have let through its value gates (state-dependent gates — list
        caps, d_index — stay in the caller)."""
        from grom_tpu_torch.call.deposits import E_INDEL_I
        cfg = self.cfg
        af = cfg.add_factor
        md, mt = cfg.min_disc, cfg.max_trials
        mq_t, hez_t = self.mq, self.hez
        base = dense.base
        Z = (np.empty(0, np.int64), np.empty(0, np.int32), np.empty(0),
             np.empty(0), np.empty(0, np.int64), np.empty(0, np.int64))

        idx = np.flatnonzero(
            (ev.etype >= E_INDEL_I) & (ev.pos >= lo) & (ev.pos < hi)
            & (ev.pos > self.lo_gate) & (ev.pos >= scan_start)
            & (ev.pos <= scan_end) & (ev.pos < self.L))
        if not len(idx):
            return Z
        pos = ev.pos[idx]
        pb = (pos - base).astype(np.intp)
        alive = (dense.rd[pb].astype(np.int64)
                 + dense.indel_sc_rd[pb]) > 0
        idx = idx[alive]
        if not len(idx):
            return Z
        pos, pb = pos[alive], pb[alive]
        kind = (ev.etype[idx] - E_INDEL_I).astype(np.int32)  # 0=i, 1=d_f, 2=d_r
        count = ev.count[idx].astype(np.int64)
        rd_base = base_tot[(pos - bt_base).astype(np.intp)].astype(np.int64)

        # INDEL_I: count clamp to rd_base*af (src/GROM.c:11346-11350), then
        # the count//af >= 1 event gate + min_disc/mt (src/GROM.c:11352)
        is_i = kind == 0
        cnt = np.where(is_i & (count // af > rd_base), rd_base * af, count)
        trials = np.where(is_i, rd_base, cnt // af + rd_base)
        ok = np.where(is_i, (count // af >= 1) & (cnt // af >= md),
                      cnt // af >= md) & (trials <= mt)

        row = np.minimum(trials, mt)
        binom = mq_t[row, np.minimum(cnt // af, mt)]
        # hez: INDEL_I takes max over left/right soft-clip columns with the
        # nested else-overwrite (src/GROM.c:11361-11395); d_f uses right,
        # d_r uses left
        scl = dense.indel_sc_left[pb].astype(np.int64)
        scr = dense.indel_sc_right[pb].astype(np.int64)
        k1 = (cnt + np.where(kind == 2, scl, scr)) // af   # d_f/d_r column
        hez_side = hez_t[row, np.minimum(np.where(k1 < trials, k1, trials),
                                         mt)]
        ki1 = (cnt + scl) // af
        ki2 = (cnt + scr) // af
        hez_rr = hez_t[row, np.minimum(trials, mt)]
        hez_i = np.where(
            ki1 < trials,
            np.where(ki2 < trials,
                     np.maximum(hez_t[row, np.minimum(ki1, mt)],
                                hez_t[row, np.minimum(ki2, mt)]),
                     hez_rr),
            hez_rr)
        hez = np.where(is_i, hez_i, hez_side)
        ok &= binom <= cfg.pval_threshold1

        w = np.flatnonzero(ok)
        return (idx[w], kind[w], binom[w], hez[w], cnt[w], trials[w])


def _homopolymer_ins(chrom: np.ndarray, start: int) -> int:
    """src/GROM.c:16256-16300: left run from ``start`` inclusive, plus the
    buggy right run against chr[start]+1."""
    L = len(chrom)
    h1 = 1
    c = chrom[start]
    for b in range(1, 20):
        if start - b >= 0 and chrom[start - b] == c:
            h1 += 1
        else:
            break
    h2 = 1
    if int(chrom[start]) + 1 < L:  # buggy guard: char value vs chromosome len
        c2 = int(chrom[start]) + 1
        for b in range(1, 20):
            if start + b + 1 < L and int(chrom[start + b + 1]) == c2:
                h2 += 1
            else:
                break
    return max(h1, h2)


def _homopolymer_del(chrom: np.ndarray, start: int, end: int) -> int:
    """src/GROM.c:16425-16470: left run from start-1, buggy right run against
    chr[end]+1."""
    L = len(chrom)
    h1 = 1
    if int(chrom[start]) - 1 >= 0:  # buggy guard (char value)
        c = chrom[start - 1] if start - 1 >= 0 else 0
        for b in range(1, 20):
            if start - b - 1 >= 0 and chrom[start - b - 1] == c:
                h1 += 1
            else:
                break
    h2 = 1
    if int(chrom[end]) + 1 < L:
        c2 = int(chrom[end]) + 1
        for b in range(1, 20):
            if end + b + 1 < L and int(chrom[end + b + 1]) == c2:
                h2 += 1
            else:
                break
    return max(h1, h2)


def format_indel_rows(chrom: np.ndarray, chr_name: str,
                      ins_list: List[InsCandidate],
                      del_list: List[DelCandidate], d_index: int,
                      del2: List, cfg: GromConfig, drv: DerivedConfig
                      ) -> List[str]:
    """Emission (src/GROM.c:16249-16560). ``del2`` is the clustered SV
    deletion list (for reciprocal-overlap dedup); entries need .start, .end,
    .start_binom, .end_binom attributes."""
    af = float(cfg.add_factor)
    rows: List[str] = []
    gt_cap = 100  # cdp_snv_gt_string_len (src/GROM.c:1477)

    for c in ins_list:
        if not (c.binom <= cfg.pval_threshold and
                (c.i / c.rd if c.rd else math.inf) > cfg.min_indel_ratio * af):
            continue
        hp = _homopolymer_ins(chrom, c.start)
        if hp > cfg.max_homopolymer:
            continue
        if not cfg.vcf_output:
            # tabular (src/GROM.c:16342): raw end (-1, never set), hez CDF
            rows.append(
                "INDEL_INS\t%s\t%d\t%d\t%d\t%e\t%e\t%d\t%d\t%d\t%d\t%d\t%d\t%d\t%d"
                % (chr_name, c.start, -1, c.dist, c.binom, c.hez, c.conc, 0,
                   c.other_len, 0, c.i, c.rd, c.sc, hp))
            continue
        if c.dist <= cfg.indel_i_seq_len and c.seq is not None:
            alt = c.seq[:c.dist].decode()
        else:
            alt = "<INS>"
        rows.append(
            "%s\t%d\t.\t.\t%s\t.\t.\tEND=%d\tSPR:SEV:SRD:SCO:ECO:SOT:EOT:SSC:HP\t"
            "%e:%.1f:%d:%d:%d:%d:%d:%d:%d"
            % (chr_name, c.start + 1, alt, 0, c.binom, c.i / af, c.rd,
               c.conc, 0, c.other_len, 0, c.sc, hp))

    # NOTE loop bound: the reference iterates a < d_index, dropping the final
    # list entry (src/GROM.c:16349)
    for a in range(max(d_index, 0)):
        c = del_list[a]
        if not (c.start_binom <= cfg.pval_threshold
                and c.end_binom <= cfg.pval_threshold
                and (c.f / c.start_rd if c.start_rd else math.inf) > cfg.min_indel_ratio * af
                and (c.r / c.end_rd if c.end_rd else math.inf) > cfg.min_indel_ratio * af):
            continue
        if _overlaps_sv_del(c, a, del2, cfg, drv):
            continue
        hp = _homopolymer_del(chrom, c.start, c.end)
        if hp > cfg.max_homopolymer:
            continue
        if not cfg.vcf_output:
            # tabular (src/GROM.c:16490): explicit length, hez CDFs, hp last
            rows.append(
                "INDEL_DEL\t%s\t%d\t%d\t%d\t%e\t%e\t%d\t%d\t%d\t%d\t%d\t%d\t"
                "%d\t%d\t%d\t%d\t%e\t%e\t%d"
                % (chr_name, c.start, c.end, c.end - c.start + 1,
                   c.start_binom, c.end_binom, c.start_conc, c.end_conc,
                   c.start_other_len, c.end_other_len, c.f, c.r,
                   c.start_rd, c.end_rd, c.start_sc, c.end_sc,
                   c.start_hez, c.end_hez, hp))
            continue
        n = c.end - c.start + 1
        if 0 < n < gt_cap - 1:
            refseq = chrom[c.start:c.end + 1].tobytes().decode()
            head = "%s\t%d\t.\t%s\t.\t.\t.\tEND=%d" % (chr_name, c.start + 1, refseq, c.end + 1)
        else:
            head = "%s\t%d\t.\t.\t<DEL>\t.\t.\tEND=%d" % (chr_name, c.start + 1, c.end + 1)
        rows.append(
            head + "\tSPR:EPR:SEV:EEV:SRD:ERD:SCO:ECO:SOT:EOT:SSC:ESC:HP\t"
            "%e:%e:%.1f:%.1f:%d:%d:%d:%d:%d:%d:%d:%d:%d"
            % (c.start_binom, c.end_binom, c.f / af, c.r / af,
               c.start_conc, c.end_conc, c.start_other_len, c.end_other_len,
               c.start_rd, c.end_rd, c.start_sc, c.end_sc, hp))
    return rows


def _overlap_ratios(a_start, a_end, b_start, b_end):
    """The reference's overlap-ratio arithmetic (src/GROM.c:16360-16390),
    including its asymmetric b-inside-a branch."""
    r1 = r2 = 0.0
    if a_start >= b_start and a_start <= b_end:
        if a_end >= b_end:
            r1 = (b_end - a_start) / (b_end - b_start) if b_end != b_start else 0.0
            r2 = (b_end - a_start) / (a_end - a_start) if a_end != a_start else 0.0
        else:
            r1 = (a_end - a_start) / (b_end - b_start) if b_end != b_start else 0.0
            r2 = (a_end - a_start) / (a_end - a_start) if a_end != a_start else 0.0
    elif b_start >= a_start and b_start <= a_end:
        if a_end >= b_end:
            r1 = (b_end - b_start) / (b_end - b_start) if b_end != b_start else 0.0
            r2 = (b_end - b_start) / (a_end - a_start) if a_end != a_start else 0.0
        else:
            r1 = (a_end - b_start) / (b_end - b_start) if b_end != b_start else 0.0
            r2 = (a_end - b_start) / (a_end - a_start) if a_end != a_start else 0.0
    return r1, r2


def _overlaps_sv_del(c: DelCandidate, indel_idx: int, del2: List,
                     cfg: GromConfig, drv: DerivedConfig) -> bool:
    """Indel loses to an overlapping clustered SV DEL with a strictly better
    p-value product (src/GROM.c:16352-16394). ``del2`` entries expose
    SvCandidate-style .start/.end BkptSides. One ratio branch reads
    del_list2_end at the INDEL's loop index (src/GROM.c:16370) — a
    cross-indexed term we reproduce (value -1 when out of range, matching the
    reference's -1-initialized list)."""
    lim = drv.insert_max - 2 * drv.read_len
    stray_end = del2[indel_idx].end.pos if indel_idx < len(del2) else -1
    for d in del2:
        ds, de = d.start.pos, d.end.pos
        if not (abs(ds - c.start) < lim and abs(de - c.end) < lim):
            continue
        ilen = c.end - c.start
        dlen = de - ds
        r1 = r2 = 0.0
        if c.start <= ds <= c.end:
            if de >= c.end:
                r1 = (c.end - ds) / ilen if ilen else 0.0
                r2 = (c.end - ds) / dlen if dlen else 0.0
            else:
                r1 = dlen / ilen if ilen else 0.0
                r2 = (stray_end - ds) / dlen if dlen else 0.0
        elif ds <= c.start <= de:
            if de >= c.end:
                r1 = 1.0 if ilen else 0.0
                r2 = ilen / dlen if dlen else 0.0
            else:
                r1 = (de - c.start) / ilen if ilen else 0.0
                r2 = (de - c.start) / dlen if dlen else 0.0
        if (r1 >= cfg.min_overlap_ratio and r2 >= cfg.min_overlap_ratio
                and d.start.binom * d.end.binom < c.start_binom * c.end_binom):
            return True
    return False


def _overlap_ratios_del2(d2_start, d2_end, i_start, i_end):
    """src/GROM.c:16357-16390 exactly: ratio_1 normalizes by the indel span,
    ratio_2 by the SV-del span (with one branch using a misindexed term that
    we reproduce via the same arithmetic)."""
    r1 = r2 = 0.0
    ilen = i_end - i_start
    dlen = d2_end - d2_start
    if i_start <= d2_start <= i_end:
        if d2_end >= i_end:
            r1 = (i_end - d2_start) / ilen if ilen else 0.0
            r2 = (i_end - d2_start) / dlen if dlen else 0.0
        else:
            r1 = dlen / ilen if ilen else 0.0
            # reference uses cdp_del_list2_end[a] - cdp_del_list2_start[b]
            # which with a==b is just dlen
            r2 = dlen / dlen if dlen else 0.0
    elif d2_start <= i_start <= d2_end:
        if d2_end >= i_end:
            r1 = ilen / ilen if ilen else 0.0
            r2 = ilen / dlen if dlen else 0.0
        else:
            r1 = (d2_end - i_start) / ilen if ilen else 0.0
            r2 = (d2_end - i_start) / dlen if dlen else 0.0
    return r1, r2
