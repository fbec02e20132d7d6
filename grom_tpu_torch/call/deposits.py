"""Full per-read evidence deposit engine (the dense+sparse half of the
reference's read loop, src/GROM.c:6408-11085) in GLOBAL chromosome
coordinates.

Two kinds of state:

* **commutative dense arrays** (rd, conc, ins, munmapped, soft-clip points,
  *_rd counters) — accumulated vectorized after the event pass;
* **ordered typed evidence** (del/dup/inv/ctx/indel families) — one primary
  slot per (position, type) plus a 50-deep shared per-position "other" table
  with tolerance keying, running-mean distances and dominant-swap
  (src/GROM.c:7190-10800). These are order-dependent, so events are generated
  per read in the reference's deposit order and replayed sequentially.

Window-relative clamps in the reference never bind for whole-chromosome runs
(backward reaches are < overlap_mult*insert_max behind the read and the scan
trails exactly that far — see call/scan.py), so everything is global.

Device-offload analysis (measured on the 4Mb/30x bench dataset, 2-vCPU
host): the deposit phase is 1.3-1.4s of a 24-40s end-to-end run (~4-6% of
wall; ~900k reads/s through the native ring engine). The COMMUTATIVE dense
channels are endpoint-delta + prefix-sum shaped and already run on device
where it pays: the mesh pipeline computes the caf_rd_* depth lists exactly
this way with an all_gather'd cross-cell carry (parallel/pipeline.py). The
ORDER-DEPENDENT typed state (primary running-mean dist with count-scaled
tolerance matching, first-come other-slot assignment, dominant-swap —
src/GROM.c:7190-10800) serializes on the arrival order of every deposit at
a position: a device formulation would accumulate per-(pos, type,
dist-bucket) partials and still need a host reconciliation pass whose
sequential work is the same order as the current native replay, while
shipping the per-read deposit stream to the device costs more transfer
than the entire phase costs today. By Amdahl the ceiling of a perfect
device offload is the ~5% the phase occupies, so the typed state stays in
the native streaming ring engine by design.

Reference bugs reproduced deliberately (parity depends on them):
  * sr_dup's aux split-loss temp uses the primary's end_adj_indel
    (src/GROM.c:7996-7999, :9379-9382);
  * sr_dup's first-set writes its read-end into the DEL_F read_end array
    (src/GROM.c:8037/8043, :9416/9421);
  * the ins-suppression reverse branch is nested unreachably inside the
    forward branch (src/GROM.c:8837-8849);
  * zero-weight (low-mapq) deposits still set distances/read-ranges.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from grom_tpu_torch.config import DerivedConfig, GromConfig
from grom_tpu_torch.ingest.batches import ReadBatch
from grom_tpu_torch.ingest.bam import (CDEL, CDIFF, CEQUAL, CHARD_CLIP, CINS, CMATCH,
                                 CREF_SKIP, CSOFT_CLIP, FMREVERSE, FMUNMAP,
                                 FPAIRED, FREVERSE)

# typed evidence ids (mirroring OTHER_* at src/GROM.c:663-676)
E_DEL_F, E_DEL_R, E_DUP_F, E_DUP_R = 1, 2, 3, 4
E_INV_F1, E_INV_R1, E_INV_F2, E_INV_R2 = 5, 6, 7, 8
E_CTX_F, E_CTX_R = 9, 10
E_INDEL_I, E_INDEL_D_F, E_INDEL_D_R = 11, 12, 13

OTHER_OF = {E_DEL_F: 1, E_DEL_R: 2, E_DUP_F: 3, E_DUP_R: 4, E_INV_F1: 5,
            E_INV_R1: 6, E_INV_F2: 7, E_INV_R2: 8, E_CTX_F: 9, E_CTX_R: 10,
            E_INDEL_I: 11, E_INDEL_D_F: 12, E_INDEL_D_R: 13}

EXACT_KEY = {E_INDEL_I, E_INDEL_D_F, E_INDEL_D_R}
CTX_TYPES = {E_CTX_F, E_CTX_R}


class Primary:
    __slots__ = ("count", "dist", "rs", "re", "mchr", "seq")

    def __init__(self):
        self.count = 0
        self.dist = 0.0
        self.rs = 0
        self.re = 0
        self.mchr = 0
        self.seq = None  # indel_i inserted sequence (first occurrence)


class OtherSlot:
    __slots__ = ("count", "type", "dist", "rs", "re", "mchr")

    def __init__(self):
        self.count = 0
        self.type = 0
        self.dist = 0.0
        self.rs = 0
        self.re = 0
        self.mchr = 0


@dataclass
class EvidenceState:
    """Sparse evidence store for one chromosome."""
    primary: Dict[Tuple[int, int], Primary] = field(default_factory=dict)   # (etype,pos)
    other: Dict[int, List[OtherSlot]] = field(default_factory=dict)         # pos → slots
    other_len_cap: int = 50

    def get_primary(self, etype: int, pos: int) -> Primary:
        key = (etype, pos)
        p = self.primary.get(key)
        if p is None:
            p = Primary()
            self.primary[key] = p
        return p

    def peek(self, etype: int, pos: int) -> Optional[Primary]:
        return self.primary.get((etype, pos))

    def other_slots(self, pos: int) -> List[OtherSlot]:
        sl = self.other.get(pos)
        if sl is None:
            sl = []
            self.other[pos] = sl
        return sl

    def other_len(self, pos: int) -> int:
        """#leading non-empty slots (src/GROM.c:11430-11441): the reference
        scans until the first EMPTY slot; overwritten slots are never EMPTY,
        appended slots are contiguous, so this equals len(slots) capped."""
        sl = self.other.get(pos)
        if not sl:
            return 0
        return min(len(sl), self.other_len_cap)


def _tol(tol_base: float, count: int) -> float:
    if count == 0:
        return float("inf")
    return tol_base * (1.0 + 1.0 / count)


def deposit_typed(st: EvidenceState, etype: int, pos: int, dist: float,
                  add: int, addf: float, range_val: int, cfg_other_len: int,
                  range_mode: str = "end", mchr: int = -1,
                  seq: Optional[bytes] = None, tol_base: float = 0.0,
                  indel_i_cap: int = 50) -> None:
    """One typed deposit with the reference's primary/other-slot semantics.

    range_mode: 'end'    — subsequent deposits set re = range_val (ascending)
                'minmax' — subsequent deposits extend [rs, re]
                'max'    — subsequent deposits only grow re
    For exact-keyed types (indels) dist must equal exactly; for ctx the key
    includes mchr and the sign of the stored mean mate position.
    """
    p = st.get_primary(etype, pos)
    exact = etype in EXACT_KEY
    is_ctx = etype in CTX_TYPES

    def match_primary() -> bool:
        if exact:
            return dist == float(p.dist)
        if is_ctx:
            if p.mchr != mchr:
                return False
            if dist >= 0:
                return p.dist > 0 and abs(p.dist - dist) <= _tol(tol_base, p.count)
            return p.dist < 0 and abs(abs(p.dist) - (-dist)) <= _tol(tol_base, p.count)
        return abs(p.dist - dist) <= _tol(tol_base, p.count)

    if p.count == 0:
        # the reference's first-set branch triggers on count==0 — including
        # after zero-weight deposits, whose dist/ranges get overwritten
        p.count = add
        p.dist = float(dist)
        p.rs = range_val
        p.re = range_val
        p.mchr = mchr
        if etype == E_INDEL_I and seq is not None and dist <= indel_i_cap:
            p.seq = seq
        return
    if match_primary():
        p.count += add
        if not exact:
            p.dist += addf * (float(dist) - p.dist) / p.count if p.count else 0.0
        if range_mode == "end":
            p.re = range_val
        elif range_mode == "max":
            if range_val > p.re:
                p.re = range_val
        else:
            if range_val < p.rs:
                p.rs = range_val
            if range_val > p.re:
                p.re = range_val
        return

    # --- other-slot path ---
    slots = st.other_slots(pos)
    oid = OTHER_OF[etype]
    found = False
    for s in slots:
        if s.type == oid:
            if exact:
                ok = dist == int(s.dist + 0.5)
            elif is_ctx:
                if dist >= 0:
                    ok = s.mchr == mchr and s.dist > 0 and \
                        abs(s.dist - dist) <= _tol(tol_base, s.count)
                else:
                    ok = s.mchr == mchr and s.dist < 0 and \
                        abs(abs(s.dist) - (-dist)) <= _tol(tol_base, s.count)
            else:
                ok = abs(s.dist - dist) <= _tol(tol_base, s.count)
            if ok:
                found = True
                s.count += add
                if not exact and s.count:
                    s.dist += addf * (float(dist) - s.dist) / s.count
                if range_mode == "end":
                    s.re = range_val
                elif range_mode == "max":
                    if range_val > s.re:
                        s.re = range_val
                else:
                    if range_val < s.rs:
                        s.rs = range_val
                    if range_val > s.re:
                        s.re = range_val
                if s.count > p.count:
                    # dominant swap: the slot takes the old primary verbatim;
                    # the primary takes the slot's dist rounded back to int
                    # for exact-keyed types (src/GROM.c:7315-7322 uint32 cast)
                    new_p_dist = float(int(s.dist + 0.5)) if exact else s.dist
                    s_count, s_rs, s_re, s_mchr = s.count, s.rs, s.re, s.mchr
                    s.count, s.dist, s.rs, s.re, s.mchr = \
                        p.count, p.dist, p.rs, p.re, p.mchr
                    p.count, p.dist, p.rs, p.re, p.mchr = \
                        s_count, new_p_dist, s_rs, s_re, s_mchr
                break
    if not found:
        if len(slots) < 50:
            s = OtherSlot()
            s.count = add
            s.type = oid
            s.dist = float(dist)
            s.rs = range_val
            s.re = range_val
            s.mchr = mchr
            slots.append(s)
        else:
            for s in slots:
                if s.count <= add:
                    s.count = add
                    s.type = oid
                    s.dist = float(dist)
                    s.rs = range_val
                    s.re = range_val
                    s.mchr = mchr
                    break


# ---------------------------------------------------------------------------
# Aux (SA/XP) split-read tag parsing
# ---------------------------------------------------------------------------

@dataclass
class AuxSplit:
    chrom: bytes
    pos: int          # AS PARSED from the tag (1-based in SA — the reference
                      # uses it without converting, an off-by-one kept for parity)
    strand: int       # 0 = '+', 1 = '-'
    mapq: int
    start_adj: int
    end_adj: int
    end_adj_indel: int


_AUX_NUM = re.compile(rb"(\d+)([A-Za-z])")


def parse_aux(tag: Optional[bytes], is_xp: bool = False) -> Optional[AuxSplit]:
    """Parse SA:Z 'chr,pos,strand,cigar,mq,...' (or XP 'chr,±pos,cigar,mq')
    per src/GROM.c:14891-14958 + the aux cigar walk :6690-6731."""
    if not tag:
        return None
    parts = tag.split(b",")
    try:
        if is_xp:
            chrom = parts[0]
            strand = 0 if parts[1][:1] == b"+" else 1
            pos = int(parts[1][1:])
            cigar = parts[2]
            mapq = int(parts[3])
        else:
            chrom = parts[0]
            pos = int(parts[1])
            strand = 0 if parts[2][:1] == b"+" else 1
            cigar = parts[3]
            mapq = int(parts[4])
    except (IndexError, ValueError):
        return None
    ops = _AUX_NUM.findall(cigar)
    if not ops:
        return None
    start_adj = end_adj = 0
    end_adj_indel = 0
    if ops[0][1] == b"S":
        start_adj = int(ops[0][0])
    if ops[-1][1] == b"S":
        end_adj = int(ops[-1][0])
    for ln, ch in ops:
        if ch == b"I":
            end_adj_indel += int(ln)
        elif ch == b"D":
            end_adj_indel -= int(ln)
    return AuxSplit(chrom, pos, strand, mapq, start_adj, end_adj, end_adj_indel)


# ---------------------------------------------------------------------------
# Dense accumulators
# ---------------------------------------------------------------------------

@dataclass
class DenseArrays:
    """Commutative per-base accumulators beyond ChromArrays.

    ``base`` is the absolute position of array index 0: whole-chromosome
    runs use 0; the windowed streaming drain produces chunk-local arrays
    covering [base, base + n + halo)."""
    chr_len: int
    rd: np.ndarray           # cdp_one_base_rd (ALL contributions)
    conc: np.ndarray
    ins: np.ndarray
    munmapped_f: np.ndarray
    munmapped_r: np.ndarray
    sc_left: np.ndarray
    sc_right: np.ndarray
    sc_left_rd: np.ndarray
    sc_right_rd: np.ndarray
    sc_rd: np.ndarray
    ctx_sc_left: np.ndarray
    ctx_sc_right: np.ndarray
    ctx_sc_left_rd: np.ndarray
    ctx_sc_right_rd: np.ndarray
    ctx_sc_rd: np.ndarray
    indel_sc_left: np.ndarray
    indel_sc_right: np.ndarray
    indel_sc_left_rd: np.ndarray
    indel_sc_right_rd: np.ndarray
    indel_sc_rd: np.ndarray
    indel_d_f_rd: np.ndarray
    indel_d_r_rd: np.ndarray
    base: int = 0

    @staticmethod
    def zeros(L: int) -> "DenseArrays":
        z = lambda: np.zeros(L, np.int32)
        return DenseArrays(L, z(), z(), z(), z(), z(), z(), z(), z(), z(), z(),
                           z(), z(), z(), z(), z(), z(), z(), z(), z(), z(),
                           z(), z())


def _apply_spans(dst, L, starts, ends, weights):
    if not starts:
        return
    d = np.zeros(L + 1, np.int32)
    np.add.at(d, np.array(starts), np.array(weights))
    np.subtract.at(d, np.array(ends), np.array(weights))
    dst += np.cumsum(d[:-1], dtype=np.int32)


# ---------------------------------------------------------------------------
# The main per-read deposit pass
# ---------------------------------------------------------------------------

def run_deposits(chrom_len: int, batch: ReadBatch, chr_name_lower: str,
                 cfg: GromConfig, drv: DerivedConfig,
                 scan_start: int) -> Tuple[DenseArrays, EvidenceState]:
    """Replay every kept read's deposits. Returns dense arrays + typed state.

    Dispatches to the native C engine (native/grom_deposits.c) when available
    — bit-identical by differential test — with this Python implementation as
    the reference fallback."""
    res = run_deposits_native(chrom_len, batch, chr_name_lower, cfg, drv,
                              scan_start)
    if res is not None:
        return res
    return run_deposits_py(chrom_len, batch, chr_name_lower, cfg, drv,
                           scan_start)


def _parse_aux_arrays(batch: ReadBatch, target_prefix: bytes,
                      eligible: np.ndarray, i0: int = 0,
                      i1: Optional[int] = None):
    """Per-read parsed SA-tag fields for the native engine (the aux fields of
    run_deposits_py's inner loop, hoisted). ``eligible`` indexes the
    [i0, i1) sub-range; outputs have that length."""
    i1 = len(batch.pos) if i1 is None else i1
    R = i1 - i0
    m = np.zeros(R, np.uint8)
    a_pos = np.zeros(R, np.int64)
    a_strand = np.zeros(R, np.uint8)
    a_mapq = np.zeros(R, np.int32)
    a_sadj = np.zeros(R, np.int32)
    a_eadj = np.zeros(R, np.int32)
    a_eadj_i = np.zeros(R, np.int32)
    tags = batch.reads.sa_tags
    if tags:
        for i in np.flatnonzero(eligible):
            aux = parse_aux(tags[i0 + i])
            if aux is not None and aux.chrom.lower().startswith(target_prefix):
                m[i] = 1
                a_pos[i] = aux.pos
                a_strand[i] = aux.strand
                a_mapq[i] = aux.mapq
                a_sadj[i] = aux.start_adj
                a_eadj[i] = aux.end_adj
                a_eadj_i[i] = aux.end_adj_indel
    return m, a_pos, a_strand, a_mapq, a_sadj, a_eadj, a_eadj_i


class DepositsSession:
    """Chunked deposit replay: ``feed`` coordinate-sorted read batches (in
    position order), ``finish`` once — the streaming form of
    :func:`run_deposits` that never needs the whole chromosome's reads in
    memory (the reference achieves the same with its read ring,
    src/GROM.c:82-324). Uses the native streaming engine
    (gn_deposits_init/feed/finish) when available, else the Python engine's
    window-less state accumulated per chunk (bit-identical either way).
    ``feed`` returning False means the native window cannot fit a read
    (freak CIGAR) — the caller must redo the chromosome non-chunked."""

    DRAIN_HALO = 8   # final point-channel positions exported past each drain

    def __init__(self, chrom_len: int, chr_name_lower: str, cfg: GromConfig,
                 drv: DerivedConfig, scan_start: int,
                 windowed: bool = False):
        self.L = chrom_len
        self.chr_name_lower = chr_name_lower
        self.cfg = cfg
        self.drv = drv
        self.scan_start = scan_start
        self.read_base = 0
        self.windowed = windowed
        self._mode: Optional[str] = None
        self._handle = None
        self._holds: List = []            # buffers the C engine points into
        self._diff = None
        self._point = None
        self._py_dense: Optional[DenseArrays] = None
        self._py_state: Optional[EvidenceState] = None
        self._refid = 0
        self._drained_to = 0
        self._ev_carry = None             # EvidenceChunk beyond last drain
        # windowed dense ring sizing (mirrors the C caps): the drain cadence
        # D must satisfy dspan >= 2*D + back + fwd
        self._max_lseq = max(4 * drv.read_len, 4096)
        self._max_ref_span = 1 << 16
        im = drv.insert_max
        self.back = im + 2 * self._max_lseq + 64
        self.fwd = im + self._max_lseq + self._max_ref_span + 64

    def dspan_for(self, d_chunk: int) -> int:
        need = 2 * d_chunk + self.back + self.fwd + self.DRAIN_HALO + 2
        v = 1
        while v < need:
            v <<= 1
        return v

    def _params(self, refid: int):
        L, cfg, drv = self.L, self.cfg, self.drv
        params_i = np.array([
            L, drv.insert_max, drv.insert_min, drv.insert_mean,
            cfg.sc_min, cfg.min_mapq, cfg.max_split_loss, cfg.min_sr_len,
            drv.read_len, cfg.indel_i_seq_len, 1 if cfg.splitread else 0,
            refid,
        ], np.int64)
        params_d = np.array([float(drv.insert_max - drv.insert_min)],
                            np.float64)
        self._holds += [params_i, params_d]
        return params_i, params_d

    def _start_native(self, refid: int, d_chunk: int = 0) -> bool:
        import ctypes

        from grom_tpu_torch.native import get_lib
        lib = get_lib()
        if lib is None or not hasattr(lib, "gn_deposits_init"):
            return False
        params_i, params_d = self._params(refid)
        if self.windowed:
            if not hasattr(lib, "gn_deposits_init_stream"):
                return False
            dspan = self.dspan_for(d_chunk)
            h = lib.gn_deposits_init_stream(
                params_i.ctypes.data_as(ctypes.c_void_p),
                params_d.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_long(self._max_lseq),
                ctypes.c_long(self._max_ref_span), ctypes.c_long(dspan))
        else:
            L = self.L
            self._diff = [np.zeros(L + 1, np.int32) for _ in range(5)]
            self._point = [np.zeros(L, np.int32) for _ in range(17)]
            dense_ptrs = (ctypes.c_void_p * 22)(
                *[a.ctypes.data_as(ctypes.c_void_p).value
                  for a in self._diff + self._point])
            self._holds.append(dense_ptrs)
            h = lib.gn_deposits_init(
                params_i.ctypes.data_as(ctypes.c_void_p),
                params_d.ctypes.data_as(ctypes.c_void_p),
                dense_ptrs, ctypes.c_long(self._max_lseq),
                ctypes.c_long(self._max_ref_span))
        if not h:
            return False
        self._handle = h
        self._lib = lib
        return True

    def feed(self, batch: ReadBatch, i0: int = 0, i1: Optional[int] = None,
             d_chunk: int = 0) -> bool:
        """Replay reads [i0, i1) of ``batch`` (whole batch by default).
        Batches/ranges must arrive in coordinate order."""
        import ctypes
        reads = batch.reads
        R_full = len(batch.pos)
        i1 = R_full if i1 is None else i1
        R = i1 - i0
        if self._mode is None:
            self._refid = int(reads.refid[0]) if R_full else 0
            self._mode = ("native"
                          if self._start_native(self._refid, d_chunk)
                          else "py")
        if R == 0:
            return True
        if self._mode == "py":
            dense, st = run_deposits_py(self.L, batch, self.chr_name_lower,
                                        self.cfg, self.drv, self.scan_start,
                                        dense=self._py_dense,
                                        st=self._py_state, i0=i0, i1=i1)
            self._py_dense, self._py_state = dense, st
            self.read_base += R
            return True

        sl = slice(i0, i1)
        eligible = (batch.keep[sl] & (batch.pos[sl] >= self.scan_start)) \
            .astype(np.uint8)
        aux = _parse_aux_arrays(batch, self.chr_name_lower.encode(),
                                eligible.astype(bool) if self.cfg.splitread
                                else np.zeros(R, bool), i0=i0, i1=i1)
        holds = []

        def p(a, dt):
            a = np.ascontiguousarray(a, dt)
            holds.append(a)
            return a.ctypes.data_as(ctypes.c_void_p)

        rc = self._lib.gn_deposits_feed(
            self._handle, ctypes.c_long(R), ctypes.c_long(self.read_base),
            p(batch.pos[sl], np.int64), p(batch.flag[sl], np.int32),
            p(batch.mapq[sl], np.int32), p(batch.mchr[sl], np.int32),
            p(batch.mpos[sl], np.int64), p(batch.tlen[sl], np.int64),
            p(batch.lseq[sl], np.int64), p(batch.start_adj[sl], np.int64),
            p(batch.end_adj[sl], np.int64),
            p(batch.end_adj_indel[sl], np.int64),
            p(batch.add[sl], np.int32), p(eligible, np.uint8),
            p(reads.cigar, np.uint32), p(reads.cigar_off[i0:], np.int64),
            p(aux[0], np.uint8), p(aux[1], np.int64), p(aux[2], np.uint8),
            p(aux[3], np.int32), p(aux[4], np.int32), p(aux[5], np.int32),
            p(aux[6], np.int32),
            p(reads.seq, np.uint8), p(reads.seq_off[i0:], np.int64))
        if rc != 0:
            self._lib.gn_deposits_abort(self._handle)
            self._handle = None
            return False
        self.read_base += R
        return True

    def drain(self, upto: int, final: bool = False):
        """Export finalized dense channels + typed evidence for
        [drained_to, upto) — (DenseArrays chunk with .base, EvidenceChunk) —
        or None on engine error. Safe once every read with pos < upto +
        ``self.back`` has been fed. Span-channel halo values are partial;
        only point-channel halo entries (and everything below ``upto``) are
        final."""
        import ctypes

        from grom_tpu_torch.call.evidence import EvidenceChunk
        from grom_tpu_torch.native import DepOut
        if final:
            upto = self.L
        p0 = self._drained_to
        n = upto - p0
        halo = self.DRAIN_HALO
        if self._mode == "py" or self._mode is None:
            dense, ev = self._py_drain(p0, upto, halo, final)
        else:
            if not self.windowed:
                raise RuntimeError("drain requires a windowed session")
            bufs = [np.zeros(n + halo, np.int32) for _ in range(22)]
            ptrs = (ctypes.c_void_p * 22)(
                *[b.ctypes.data_as(ctypes.c_void_p).value for b in bufs])
            out = ctypes.POINTER(DepOut)()
            rc = self._lib.gn_deposits_drain(
                self._handle, ctypes.c_long(upto),
                ctypes.c_int(1 if final else 0), ctypes.c_long(halo),
                ptrs, ctypes.byref(out))
            if rc != 0:
                if out:
                    self._lib.gn_deposits_free(out)
                self._lib.gn_deposits_abort(self._handle)
                self._handle = None
                self._mode = "dead"
                return None
            ev = EvidenceChunk.from_drain(
                _arrays_from_dep_out(self._lib, out))
            dense = _dense_from_buffers(self.L, bufs[:5], bufs[5:])
            dense.base = p0
        if self._ev_carry is not None:
            ev = EvidenceChunk.concat(self._ev_carry, ev)
            self._ev_carry = None
        if not final:
            ev, self._ev_carry = ev.split(upto)
        self._drained_to = upto
        return dense, ev

    def _py_drain(self, p0: int, upto: int, halo: int, final: bool):
        from grom_tpu_torch.call.evidence import EvidenceChunk
        if self._py_dense is None:
            self._py_dense = DenseArrays.zeros(self.L)
            self._py_state = EvidenceState()
        d = self._py_dense
        hi = min(upto + halo, self.L)
        pad = upto + halo - hi

        def cut(a):
            v = a[p0:hi].astype(np.int32, copy=True)
            return np.concatenate([v, np.zeros(pad, np.int32)]) if pad else v

        from dataclasses import fields as _fields
        vals = {}
        for f in _fields(DenseArrays):
            if f.name in ("chr_len", "base"):
                continue
            vals[f.name] = cut(getattr(d, f.name))
        dense = DenseArrays(chr_len=self.L, base=p0, **vals)
        st = self._py_state
        sub = EvidenceState()
        if final:
            sub.primary = st.primary
            sub.other = st.other
            st.primary, st.other = {}, {}
        else:
            for key in [k for k in st.primary if k[1] < upto]:
                sub.primary[key] = st.primary.pop(key)
            for pos_k in [k for k in st.other if k < upto]:
                sub.other[pos_k] = st.other.pop(pos_k)
        return dense, EvidenceChunk.from_state(sub)

    def close(self) -> None:
        if self._handle is not None:
            self._lib.gn_deposits_abort(self._handle)
            self._handle = None

    def finish(self) -> Tuple[DenseArrays, EvidenceState]:
        import ctypes

        from grom_tpu_torch.native import DepOut
        if self._mode == "py" or self._mode is None:
            if self._py_dense is None:
                self._py_dense = DenseArrays.zeros(self.L)
                self._py_state = EvidenceState()
            return self._py_dense, self._py_state
        out = ctypes.POINTER(DepOut)()
        rc = self._lib.gn_deposits_finish(self._handle, ctypes.byref(out))
        self._handle = None
        if rc != 0:
            raise RuntimeError("deposits finish failed rc=%d" % rc)
        st = _marshal_dep_out(self._lib, out)
        dense = _dense_from_buffers(self.L, self._diff, self._point)
        return dense, st


def _arrays_from_dep_out(lib, out):
    """Copy the C engine's sparse output into numpy arrays + the seq arena
    bytes, then free it. Entry order is the engine's flush order:
    position-ascending, etype-ascending within a position (oth entries keep
    per-position slot order)."""
    import numpy as np
    try:
        o = out.contents
        n_p, n_o = o.n_prim, o.n_other
        as_np = lambda ptr, n, dt: (np.ctypeslib.as_array(ptr, shape=(n,))
                                    .astype(dt, copy=True) if n else
                                    np.empty(0, dt))
        pso = as_np(o.prim_seq_off, n_p, np.int32)
        psl = as_np(o.prim_seq_len, n_p, np.int32)
        arena = b""
        if n_p and psl.max(initial=-1) >= 0:
            arena_len = int((pso + np.maximum(psl, 0)).max())
            arena = bytes(np.ctypeslib.as_array(o.seq_arena,
                                                shape=(arena_len,)))
        d = dict(
            pos=as_np(o.prim_pos, n_p, np.int64),
            etype=as_np(o.prim_etype, n_p, np.int32),
            count=as_np(o.prim_count, n_p, np.int32),
            dist=as_np(o.prim_dist, n_p, np.float64),
            rs=as_np(o.prim_rs, n_p, np.int64),
            re=as_np(o.prim_re, n_p, np.int64),
            mchr=as_np(o.prim_mchr, n_p, np.int32),
            seq_off=pso, seq_len=psl, seq_arena=arena,
            oth_pos=as_np(o.oth_pos, n_o, np.int64),
            oth_type=as_np(o.oth_type, n_o, np.int32),
            oth_count=as_np(o.oth_count, n_o, np.int32),
            oth_dist=as_np(o.oth_dist, n_o, np.float64),
            oth_rs=as_np(o.oth_rs, n_o, np.int64),
            oth_re=as_np(o.oth_re, n_o, np.int64),
            oth_mchr=as_np(o.oth_mchr, n_o, np.int32),
        )
    finally:
        lib.gn_deposits_free(out)
    return d


def _marshal_dep_out(lib, out) -> EvidenceState:
    """Convert the C engine's sparse output into an EvidenceState."""
    d = _arrays_from_dep_out(lib, out)
    n_p = len(d["pos"])
    n_o = len(d["oth_pos"])
    pp, pe, pc, pd = d["pos"], d["etype"], d["count"], d["dist"]
    prs, pre, pm = d["rs"], d["re"], d["mchr"]
    pso, psl, arena = d["seq_off"], d["seq_len"], d["seq_arena"]
    st = EvidenceState()
    primary = st.primary
    for i in range(n_p):
        p_ = Primary()
        p_.count = int(pc[i])
        p_.dist = float(pd[i])
        p_.rs = int(prs[i])
        p_.re = int(pre[i])
        p_.mchr = int(pm[i])
        if psl[i] >= 0:
            off = int(pso[i])
            p_.seq = arena[off:off + int(psl[i])]
        primary[(int(pe[i]), int(pp[i]))] = p_
    op_, ot, oc = d["oth_pos"], d["oth_type"], d["oth_count"]
    od, ors, ore, om = d["oth_dist"], d["oth_rs"], d["oth_re"], d["oth_mchr"]
    other = st.other
    for i in range(n_o):
        s_ = OtherSlot()
        s_.count = int(oc[i])
        s_.type = int(ot[i])
        s_.dist = float(od[i])
        s_.rs = int(ors[i])
        s_.re = int(ore[i])
        s_.mchr = int(om[i])
        pos_i = int(op_[i])
        sl = other.get(pos_i)
        if sl is None:
            other[pos_i] = [s_]
        else:
            sl.append(s_)
    return st


def _dense_from_buffers(L: int, diff, point) -> DenseArrays:
    d = diff
    return DenseArrays(
        chr_len=L, rd=d[0][:L], conc=d[1][:L], ins=d[2][:L],
        munmapped_f=d[3][:L], munmapped_r=d[4][:L],
        sc_left=point[0], sc_right=point[1], sc_left_rd=point[2],
        sc_right_rd=point[3], sc_rd=point[4],
        ctx_sc_left=point[5], ctx_sc_right=point[6], ctx_sc_left_rd=point[7],
        ctx_sc_right_rd=point[8], ctx_sc_rd=point[9],
        indel_sc_left=point[10], indel_sc_right=point[11],
        indel_sc_left_rd=point[12], indel_sc_right_rd=point[13],
        indel_sc_rd=point[14], indel_d_f_rd=point[15], indel_d_r_rd=point[16],
    )


def run_deposits_native(chrom_len: int, batch: ReadBatch,
                        chr_name_lower: str, cfg: GromConfig,
                        drv: DerivedConfig, scan_start: int
                        ) -> Optional[Tuple[DenseArrays, EvidenceState]]:
    """Native fast path; None when the library is unavailable or the engine
    bails (unsorted input / window overflow)."""
    import ctypes

    from grom_tpu_torch.native import DepOut, get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "gn_deposits_run"):
        return None
    reads = batch.reads
    R = len(batch.pos)
    eligible = (batch.keep & (batch.pos >= scan_start)).astype(np.uint8)
    aux = _parse_aux_arrays(batch, chr_name_lower.encode(),
                            eligible.astype(bool) if cfg.splitread
                            else np.zeros(R, bool))

    L = chrom_len
    # span-diff arrays are length L+1 (C applies ±diffs then prefix-sums)
    diff = [np.zeros(L + 1, np.int32) for _ in range(5)]
    point = [np.zeros(L, np.int32) for _ in range(17)]
    dense_arrays = diff + point
    dense_ptrs = (ctypes.c_void_p * 22)(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in dense_arrays])

    params_i = np.array([
        chrom_len, drv.insert_max, drv.insert_min, drv.insert_mean,
        cfg.sc_min, cfg.min_mapq, cfg.max_split_loss, cfg.min_sr_len,
        drv.read_len, cfg.indel_i_seq_len, 1 if cfg.splitread else 0,
        int(reads.refid[0]) if R else 0,
    ], np.int64)
    params_d = np.array([float(drv.insert_max - drv.insert_min)], np.float64)

    def P(a, dt):
        a = np.ascontiguousarray(a, dt)
        return a, a.ctypes.data_as(ctypes.c_void_p)

    holds = []

    def p(a, dt):
        arr, ptr = P(a, dt)
        holds.append(arr)
        return ptr

    out = ctypes.POINTER(DepOut)()
    rc = lib.gn_deposits_run(
        ctypes.c_long(R),
        p(batch.pos, np.int64), p(batch.flag, np.int32),
        p(batch.mapq, np.int32), p(batch.mchr, np.int32),
        p(batch.mpos, np.int64), p(batch.tlen, np.int64),
        p(batch.lseq, np.int64), p(batch.start_adj, np.int64),
        p(batch.end_adj, np.int64), p(batch.end_adj_indel, np.int64),
        p(batch.add, np.int32), p(eligible, np.uint8),
        p(reads.cigar, np.uint32), p(reads.cigar_off, np.int64),
        p(aux[0], np.uint8), p(aux[1], np.int64), p(aux[2], np.uint8),
        p(aux[3], np.int32), p(aux[4], np.int32), p(aux[5], np.int32),
        p(aux[6], np.int32),
        p(reads.seq, np.uint8), p(reads.seq_off, np.int64),
        params_i.ctypes.data_as(ctypes.c_void_p),
        params_d.ctypes.data_as(ctypes.c_void_p),
        dense_ptrs, ctypes.byref(out))
    if rc != 0:
        return None

    st = _marshal_dep_out(lib, out)
    dense = _dense_from_buffers(L, diff, point)
    return dense, st


def run_deposits_py(chrom_len: int, batch: ReadBatch, chr_name_lower: str,
                    cfg: GromConfig, drv: DerivedConfig,
                    scan_start: int, dense: Optional[DenseArrays] = None,
                    st: Optional[EvidenceState] = None,
                    i0: int = 0, i1: Optional[int] = None
                    ) -> Tuple[DenseArrays, EvidenceState]:
    """Replay every kept read's deposits. Returns dense arrays + typed state.

    ``dense``/``st`` may be passed in to accumulate across coordinate-sorted
    read chunks (the Python engine's typed state has no window, so chunked
    replay in record order is identical to one pass). ``i0``/``i1`` restrict
    the replay to a read-index sub-range of the batch."""
    dense = dense if dense is not None else DenseArrays.zeros(chrom_len)
    st = st if st is not None else EvidenceState()

    im = drv.insert_max
    imin = drv.insert_min
    imean = drv.insert_mean
    tol_base = float(im - imin)
    add_factor = cfg.add_factor
    reads = batch.reads
    refid = int(reads.refid[0]) if len(reads) else 0
    target_prefix = chr_name_lower.encode()

    # span collectors for dense arrays
    rd_s: List[int] = []
    rd_e: List[int] = []
    rd_w: List[int] = []
    conc_s: List[int] = []
    conc_e: List[int] = []
    ins_s: List[int] = []
    ins_e: List[int] = []
    ins_w: List[int] = []
    mf_s: List[int] = []
    mf_e: List[int] = []
    mf_w: List[int] = []
    mr_s: List[int] = []
    mr_e: List[int] = []
    mr_w: List[int] = []

    def rd_span(s, e, w=1):
        s0 = max(s, 0)
        e0 = min(e, chrom_len)
        if e0 > s0:
            rd_s.append(s0)
            rd_e.append(e0)
            rd_w.append(w)

    def rd_point(p):
        if 0 <= p < chrom_len:
            rd_s.append(p)
            rd_e.append(p + 1)
            rd_w.append(1)

    eligible = np.flatnonzero(batch.keep & (batch.pos >= scan_start))
    if i0 > 0 or i1 is not None:
        i1 = len(batch.pos) if i1 is None else i1
        eligible = eligible[(eligible >= i0) & (eligible < i1)]
    splitread = cfg.splitread

    for ri in eligible:
        i = int(ri)
        pos = int(batch.pos[i])
        flag = int(batch.flag[i])
        mq = int(batch.mapq[i])
        mchr = int(batch.mchr[i])
        mpos = int(batch.mpos[i])
        tlen = int(batch.tlen[i])
        lseq = int(batch.lseq[i])
        sadj = int(batch.start_adj[i])
        eadj = int(batch.end_adj[i])
        eadj_i = int(batch.end_adj_indel[i])
        add = add_factor if mq >= cfg.min_mapq else 0
        addf = float(add)
        rev = (flag & FREVERSE) != 0
        mrev = (flag & FMREVERSE) != 0
        paired = (flag & FPAIRED) != 0
        munmap = (flag & FMUNMAP) != 0
        same_chr = mchr == refid

        read_end = pos - sadj + lseq - eadj - eadj_i
        expected_end = pos - sadj - eadj_i + im - lseq

        aux = None
        if splitread:
            aux = parse_aux(reads.sa_tags[i])
        aux_match = (aux is not None and
                     aux.chrom.lower().startswith(target_prefix))

        # ---- soft-clip point deposits (src/GROM.c:7105-7170) ----
        if sadj >= cfg.sc_min:
            lp = pos - 1
            if (not paired) or ((not rev) and (munmap or ((not munmap) and same_chr and mpos > pos))):
                if 0 <= lp < chrom_len:
                    dense.sc_left[lp] += add
                    dense.sc_left_rd[lp] += 1
                    dense.sc_rd[lp] += 1
            if paired and not munmap and not same_chr and rev:
                if 0 <= lp < chrom_len:
                    dense.ctx_sc_left[lp] += add
                    dense.ctx_sc_left_rd[lp] += 1
                    dense.ctx_sc_rd[lp] += 1
            if paired and not munmap and same_chr and rev and abs(tlen) <= im and mpos < pos:
                if 0 <= lp < chrom_len:
                    dense.indel_sc_left[lp] += add
                    dense.indel_sc_left_rd[lp] += 1
                    dense.indel_sc_rd[lp] += 1
        if eadj >= cfg.sc_min:
            rp = read_end  # pos - sadj + lseq - eadj - eadj_i
            if (not paired) or (rev and (munmap or ((not munmap) and same_chr and mpos < pos))):
                if 0 <= rp < chrom_len:
                    dense.sc_right[rp] += add
                    dense.sc_right_rd[rp] += 1
                    dense.sc_rd[rp] += 1
            if paired and not munmap and not same_chr and not rev:
                if 0 <= rp < chrom_len:
                    dense.ctx_sc_right[rp] += add
                    dense.ctx_sc_right_rd[rp] += 1
                    dense.ctx_sc_rd[rp] += 1
            if paired and not munmap and same_chr and not rev and abs(tlen) <= im and mpos > pos:
                if 0 <= rp < chrom_len:
                    dense.indel_sc_right[rp] += add
                    dense.indel_sc_right_rd[rp] += 1
                    dense.indel_sc_rd[rp] += 1

        # ---- physical rd over clipped aligned span (src/GROM.c:7172-7181) ----
        span_end = pos - sadj + lseq - eadj - eadj_i
        if span_end > pos:
            rd_span(pos, span_end)

        # ---- cigar walk: indel_i / indel_d (src/GROM.c:7190-7430) ----
        cig = reads.cigar_of(i)
        if len(cig):
            tpos = pos
            rbase = 0
            for c in cig:
                op = int(c) & 0xF
                ln = int(c) >> 4
                if op == CSOFT_CLIP:
                    rbase += ln
                elif op in (CMATCH, CREF_SKIP, CEQUAL, CDIFF):
                    tpos += ln
                    if op != CREF_SKIP:
                        rbase += ln
                elif op == CINS:
                    if 0 <= tpos < chrom_len:
                        seq = reads.seq_of(i)[rbase:rbase + ln] if ln <= cfg.indel_i_seq_len else None
                        deposit_typed(st, E_INDEL_I, tpos, float(ln), add, addf,
                                      0, cfg.other_len, seq=seq,
                                      indel_i_cap=cfg.indel_i_seq_len)
                    rbase += ln
                elif op == CDEL:
                    if 0 <= tpos < chrom_len:
                        dense.indel_d_f_rd[tpos] += 1
                        deposit_typed(st, E_INDEL_D_F, tpos, float(ln), add, addf, 0,
                                      cfg.other_len)
                    dend = tpos + ln - 1
                    if 0 <= dend < chrom_len:
                        dense.indel_d_r_rd[dend] += 1
                        deposit_typed(st, E_INDEL_D_R, dend, float(ln), add, addf, 0,
                                      cfg.other_len)
                    tpos += ln

        # ---- split-read deletion evidence (src/GROM.c:7431-7947) ----
        sr_del = False
        lp_s = lp_e = 0
        if aux_match and aux.mapq >= cfg.min_mapq and mq >= cfg.min_mapq:
            same_strand = (not rev and aux.strand == 0) or (rev and aux.strand == 1)
            if same_strand:
                aux_end = aux.pos - aux.start_adj + lseq - aux.end_adj - aux.end_adj_indel
                if paired and not munmap and same_chr:
                    if not rev and aux.strand == 0:
                        if pos < aux.pos and tlen <= im and aux.pos < mpos:
                            gap = aux.pos - read_end
                            if 0 < gap < im:
                                if (abs(lseq - eadj - aux.start_adj) <= cfg.max_split_loss
                                        and lseq - sadj - eadj - eadj_i >= cfg.min_sr_len
                                        and lseq - aux.start_adj - aux.end_adj - aux.end_adj_indel >= cfg.min_sr_len):
                                    sr_del = True
                                    lp_s, lp_e = read_end, aux.pos
                    elif rev and aux.strand == 1:
                        if aux.pos < pos and abs(tlen) < im and mpos < aux.pos:
                            if (abs(lseq - sadj - aux.end_adj) <= cfg.max_split_loss
                                    and lseq - sadj - eadj - eadj_i >= cfg.min_sr_len
                                    and lseq - aux.start_adj - aux.end_adj - aux.end_adj_indel >= cfg.min_sr_len):
                                if aux_end < pos:
                                    sr_del = True
                                    lp_s, lp_e = aux_end, pos
                else:
                    if not rev and aux.strand == 0:
                        if pos < aux.pos:
                            gap = aux.pos - read_end
                            if 0 < gap < im:
                                sr_del = True
                                lp_s, lp_e = read_end, aux.pos
                    elif rev and aux.strand == 1:
                        if aux.pos < pos and pos - aux_end < im:
                            if aux_end < pos:
                                sr_del = True
                                lp_s, lp_e = aux_end, pos
        if sr_del:
            gap = lp_e - lp_s
            if gap < drv.read_len and gap < im - imean:
                if 0 <= lp_s < chrom_len:
                    dense.indel_d_f_rd[lp_s] += 1
                    deposit_typed(st, E_INDEL_D_F, lp_s, float(gap), add, addf, 0,
                                  cfg.other_len)
                if 0 <= lp_e - 1 < chrom_len:
                    dense.indel_d_r_rd[lp_e - 1] += 1
                    deposit_typed(st, E_INDEL_D_R, lp_e - 1, float(gap), add, addf, 0,
                                  cfg.other_len)
            rd_point(lp_s)
            lo_read = min(pos, aux.pos)
            hi_read = max(pos, aux.pos)
            if 0 <= lp_s < chrom_len:
                deposit_typed(st, E_DEL_F, lp_s, float(gap + imean), add, addf,
                              lo_read, cfg.other_len, range_mode="max",
                              tol_base=tol_base)
            rd_point(lp_e - 1)
            if 0 <= lp_e - 1 < chrom_len:
                deposit_typed(st, E_DEL_R, lp_e - 1, float(gap + imean), add, addf,
                              hi_read, cfg.other_len, range_mode="minmax",
                              tol_base=tol_base)

        # ---- orientation-based discordant-pair deposits (src/GROM.c:7947+) ----
        insert_temp = imean - 2 * lseq if imean - 2 * lseq > 0 else 0
        inv_tol = float(im - imin + insert_temp)

        if paired and not munmap:
            if same_chr:
                if mpos > pos:
                    if not rev and mrev:  # FR
                        if imin <= tlen <= im:
                            # split-read duplication? (src/GROM.c:7980-8343)
                            sr_dup = False
                            if (splitread and aux_match and aux.mapq >= cfg.min_mapq
                                    and mq >= cfg.min_mapq and not rev
                                    and aux.strand == 0 and pos < aux.pos and aux.pos < mpos):
                                eai_t = eadj_i if eadj_i > 0 else 0
                                # reference bug: aux temp uses the PRIMARY's value
                                aux_eai_t = eadj_i if aux.end_adj_indel > 0 else 0
                                if (abs(lseq - sadj - aux.end_adj) <= cfg.max_split_loss
                                        and lseq - sadj - eadj - eai_t >= cfg.min_sr_len
                                        and lseq - aux.start_adj - aux.end_adj - aux_eai_t >= cfg.min_sr_len):
                                    sr_dup = True
                                    dlp_s = pos
                                    dlp_e = aux.pos - aux.start_adj + lseq - aux.end_adj - aux.end_adj_indel
                            if sr_dup:
                                _sr_dup_deposit(st, dense, dlp_s, dlp_e, pos,
                                                aux.pos, add, addf, imean,
                                                tol_base, cfg, chrom_len,
                                                rd_point)
                            else:
                                s0, e0 = read_end, mpos
                                s0c, e0c = max(s0, 0), min(e0, chrom_len)
                                if e0c > s0c:
                                    conc_s.append(s0c)
                                    conc_e.append(e0c)
                                    rd_span(s0, e0)
                        elif tlen > 2 * im:
                            lo = read_end
                            hi = min(expected_end, mpos)
                            rd_span(lo, hi)
                            for x in range(max(lo, 0), min(hi, chrom_len)):
                                full = (eadj < cfg.sc_min) or (x == lo)
                                deposit_typed(st, E_DEL_F, x, float(tlen),
                                              add if full else add // 2, addf if full else addf / 2.0,
                                              pos, cfg.other_len, range_mode="end",
                                              tol_base=tol_base)
                        elif tlen > im:
                            lo = read_end
                            hi = min(mpos, chrom_len)
                            rd_span(lo, hi)
                            f_limit = pos - sadj - eadj_i + im - lseq
                            r_limit = pos - sadj + tlen - im + lseq
                            for x in range(max(lo, 0), hi):
                                if x < f_limit:
                                    full = (eadj < cfg.sc_min) or (x == lo)
                                    deposit_typed(st, E_DEL_F, x, float(tlen),
                                                  add if full else add // 2,
                                                  addf if full else addf / 2.0,
                                                  pos, cfg.other_len, range_mode="end",
                                                  tol_base=tol_base)
                                elif abs(tlen) <= 2 * im and x > r_limit:
                                    full = (sadj < cfg.sc_min) or (x == hi - 1)
                                    deposit_typed(st, E_DEL_R, x, float(tlen),
                                                  add if full else add // 2,
                                                  addf if full else addf / 2.0,
                                                  mpos, cfg.other_len, range_mode="minmax",
                                                  tol_base=tol_base)
                        elif tlen < imin:
                            no_ins = False
                            if (splitread and aux_match and
                                    ((not rev and aux.strand == 0) or (rev and aux.strand == 1)) and
                                    paired and not munmap and same_chr and
                                    (not rev and aux.strand == 0) and
                                    aux.pos < pos < mpos):
                                no_ins = True
                            if not no_ins:
                                s0, e0 = read_end, mpos
                                s0c, e0c = max(s0, 0), min(e0, chrom_len)
                                if e0c > s0c:
                                    ins_s.append(s0c)
                                    ins_e.append(e0c)
                                    ins_w.append(add)
                                    rd_span(s0, e0)
                    elif not rev and not mrev:  # FF → INV_F1
                        if mpos - pos >= 10:
                            lo = read_end
                            hi = min(expected_end, mpos)
                            rd_span(lo, hi)
                            for x in range(max(lo, 0), min(hi, chrom_len)):
                                full = (eadj < cfg.sc_min) or (x == lo)
                                deposit_typed(st, E_INV_F1, x, float(tlen),
                                              add if full else add // 2,
                                              addf if full else addf / 2.0,
                                              pos, cfg.other_len, range_mode="end",
                                              tol_base=inv_tol)
                    elif rev:
                        if mpos - pos >= 10:
                            lo = pos - sadj - im + 2 * lseq
                            hi = pos
                            rd_span(lo, hi)
                            etype = E_INV_R1 if mrev else E_DUP_R
                            tb = inv_tol if mrev else tol_base
                            for x in range(max(lo, 0), min(hi, chrom_len)):
                                full = (sadj < cfg.sc_min) or (x == hi - 1)
                                deposit_typed(st, etype, x, float(tlen),
                                              add if full else add // 2,
                                              addf if full else addf / 2.0,
                                              pos, cfg.other_len, range_mode="end",
                                              tol_base=tb)
                else:  # mpos <= pos
                    if rev and not mrev:  # RF
                        if imin <= abs(tlen) <= im:
                            sr_dup = False
                            if (splitread and aux_match and aux.mapq >= cfg.min_mapq
                                    and mq >= cfg.min_mapq and rev and aux.strand == 1
                                    and paired and not munmap and same_chr
                                    and aux.pos < pos and mpos < aux.pos):
                                eai_t = eadj_i if eadj_i > 0 else 0
                                aux_eai_t = eadj_i if aux.end_adj_indel > 0 else 0
                                if (abs(lseq - aux.start_adj - eadj) <= cfg.max_split_loss
                                        and lseq - sadj - eadj - eai_t >= cfg.min_sr_len
                                        and lseq - aux.start_adj - aux.end_adj - aux_eai_t >= cfg.min_sr_len):
                                    sr_dup = True
                                    dlp_s = aux.pos
                                    dlp_e = read_end
                            if sr_dup:
                                _sr_dup_deposit(st, dense, dlp_s, dlp_e, pos,
                                                aux.pos, add, addf, imean,
                                                tol_base, cfg, chrom_len,
                                                rd_point)
                        elif abs(tlen) > 2 * im:
                            lo = pos - sadj - im + 2 * lseq
                            hi = pos
                            rd_span(lo, hi)
                            for x in range(max(lo, 0), min(hi, chrom_len)):
                                full = (sadj < cfg.sc_min) or (x == hi - 1)
                                deposit_typed(st, E_DEL_R, x, float(abs(tlen)),
                                              add if full else add // 2,
                                              addf if full else addf / 2.0,
                                              pos, cfg.other_len, range_mode="end",
                                              tol_base=tol_base)
                    elif not rev and not mrev:  # FF → INV_F2
                        if pos - mpos >= 10:
                            lo = read_end
                            hi = expected_end
                            rd_span(lo, hi)
                            for x in range(max(lo, 0), min(hi, chrom_len)):
                                full = (eadj < cfg.sc_min) or (x == lo)
                                deposit_typed(st, E_INV_F2, x, float(abs(tlen)),
                                              add if full else add // 2,
                                              addf if full else addf / 2.0,
                                              pos, cfg.other_len, range_mode="end",
                                              tol_base=inv_tol)
                    elif mrev:
                        if pos - mpos >= 10:
                            if not rev:  # RR?? no: fwd read, mate rev, mpos<pos → DUP_F
                                lo = read_end
                                hi = expected_end
                                rd_span(lo, hi)
                                for x in range(max(lo, 0), min(hi, chrom_len)):
                                    full = (eadj < cfg.sc_min) or (x == lo)
                                    deposit_typed(st, E_DUP_F, x, float(abs(tlen)),
                                                  add if full else add // 2,
                                                  addf if full else addf / 2.0,
                                                  pos, cfg.other_len, range_mode="end",
                                                  tol_base=tol_base)
                            else:  # rev+mrev → INV_R2
                                lo = pos - sadj - im + 2 * lseq
                                if lo < mpos + lseq:
                                    lo = mpos + lseq
                                hi = pos
                                rd_span(lo, hi)
                                for x in range(max(lo, 0), min(hi, chrom_len)):
                                    full = (sadj < cfg.sc_min) or (x == hi - 1)
                                    deposit_typed(st, E_INV_R2, x, float(abs(tlen)),
                                                  add if full else add // 2,
                                                  addf if full else addf / 2.0,
                                                  pos, cfg.other_len, range_mode="end",
                                                  tol_base=inv_tol)
            else:  # mate on another chromosome → CTX
                if not rev:
                    lo = read_end
                    hi = expected_end
                    rd_span(lo, hi)
                    key_mpos = float(mpos) if not mrev else float(-mpos)
                    for x in range(max(lo, 0), min(hi, chrom_len)):
                        full = (eadj < cfg.sc_min) or (x == lo)
                        deposit_typed(st, E_CTX_F, x, key_mpos,
                                      add if full else add // 2,
                                      addf if full else addf / 2.0,
                                      pos, cfg.other_len, range_mode="end",
                                      mchr=mchr, tol_base=tol_base)
                else:
                    lo = pos - sadj + lseq - im + lseq
                    hi = pos
                    rd_span(lo, hi)
                    key_mpos = float(mpos) if not mrev else float(-mpos)
                    for x in range(max(lo, 0), min(hi, chrom_len)):
                        full = (sadj < cfg.sc_min) or (x == hi - 1)
                        deposit_typed(st, E_CTX_R, x, key_mpos,
                                      add if full else add // 2,
                                      addf if full else addf / 2.0,
                                      pos, cfg.other_len, range_mode="end",
                                      mchr=mchr, tol_base=tol_base)
        elif paired and munmap:
            if not rev:
                s0, e0 = read_end, expected_end
                s0c, e0c = max(s0, 0), min(e0, chrom_len)
                if e0c > s0c:
                    mf_s.append(s0c)
                    mf_e.append(e0c)
                    mf_w.append(add)
                    rd_span(s0, e0)
            else:
                s0 = pos - sadj + lseq + eadj_i - im + lseq
                e0 = pos
                s0c, e0c = max(s0, 0), min(e0, chrom_len)
                if e0c > s0c:
                    mr_s.append(s0c)
                    mr_e.append(e0c)
                    mr_w.append(add)
                    rd_span(s0, e0)

    # apply dense spans
    _apply_spans(dense.rd, chrom_len, rd_s, rd_e, rd_w)
    _apply_spans(dense.conc, chrom_len, conc_s, conc_e, [1] * len(conc_s))
    _apply_spans(dense.ins, chrom_len, ins_s, ins_e, ins_w)
    _apply_spans(dense.munmapped_f, chrom_len, mf_s, mf_e, mf_w)
    _apply_spans(dense.munmapped_r, chrom_len, mr_s, mr_e, mr_w)
    return dense, st


def _sr_dup_deposit(st, dense, lp_s, lp_e, pos, aux_pos, add, addf, imean,
                    tol_base, cfg, chrom_len, rd_point):
    """Split-read duplication deposit (src/GROM.c:8016-8343, :9402-9728):
    dup_f at lp_e, dup_r at lp_s-1, dist = lp_e - lp_s - insert_mean.
    The reference's first-set also stamps the DEL_F read_end array at the
    dup_f position (src/GROM.c:8037-8046) — reproduced."""
    dist = float(lp_e - lp_s - imean)
    hi_read = max(pos, aux_pos)
    lo_read = min(pos, aux_pos)
    rd_point(lp_e)
    if 0 <= lp_e < chrom_len:
        first_set = st.peek(E_DUP_F, lp_e) is None or st.peek(E_DUP_F, lp_e).count == 0
        deposit_typed(st, E_DUP_F, lp_e, dist, add, addf, hi_read,
                      cfg.other_len, range_mode="minmax", tol_base=tol_base)
        if first_set:
            delf = st.get_primary(E_DEL_F, lp_e)
            delf.re = hi_read
    rd_point(lp_s - 1)
    if 0 <= lp_s - 1 < chrom_len:
        deposit_typed(st, E_DUP_R, lp_s - 1, dist, add, addf, lo_read,
                      cfg.other_len, range_mode="minmax", tol_base=tol_base)
