"""BAM container codec: header, record decode to struct-of-arrays, writer.

Replaces the reference's vendored samtools/htslib usage (src/GROM.c:26-27,
:214-261). Decoding is two-phase: a single cheap pass collects record
boundaries, then all fixed-width fields are gathered **vectorized** with
numpy — the per-read Python work is O(1) appends only. Sequences, quals and
cigars are stored flat + offsets (ragged), ready to be padded into fixed-width
device tensors by ingest/batches.py.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from grom_tpu_torch.ingest import bgzf

BAM_MAGIC = b"BAM\x01"

# CIGAR op codes (SAM spec)
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)
CIGAR_CHARS = "MIDNSHP=X"

# 4-bit encoded bases → ASCII (SAM nt16 table)
NT16 = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)

# flags
FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800


@dataclass
class BamHeader:
    text: str
    ref_names: List[str]
    ref_lengths: List[int]

    @property
    def n_ref(self) -> int:
        return len(self.ref_names)

    def encode(self) -> bytes:
        out = [BAM_MAGIC, struct.pack("<i", len(self.text)), self.text.encode()]
        out.append(struct.pack("<i", self.n_ref))
        for name, length in zip(self.ref_names, self.ref_lengths):
            nb = name.encode() + b"\x00"
            out.append(struct.pack("<i", len(nb)))
            out.append(nb)
            out.append(struct.pack("<i", length))
        return b"".join(out)


class LazyNames:
    """Read-name list backed by the decoder's flat (buf, off) arrays.

    Materializing 10M+ bytes objects per chromosome costs seconds; the
    native scan only needs the interned ``name_id``/``name_len`` arrays, so
    names are sliced out of the flat buffer on demand. Supports the list
    operations the pipeline uses: ``len``, truthiness, integer indexing
    (-> bytes, NUL stripped) and slice indexing (-> LazyNames view)."""

    __slots__ = ("buf", "off")

    def __init__(self, buf: np.ndarray, off: np.ndarray):
        self.buf = buf      # uint8 flat, each name NUL-terminated
        self.off = off      # int64 [R+1]

    def __len__(self) -> int:
        return len(self.off) - 1

    def __bool__(self) -> bool:
        return len(self.off) > 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            start, stop, step = i.indices(len(self))
            if step != 1:
                return [self[j] for j in range(start, stop, step)]
            o = self.off[start:stop + 1]
            return LazyNames(self.buf, o)
        o0, o1 = int(self.off[i]), int(self.off[i + 1])
        return self.buf[o0:o1 - 1].tobytes()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def tolist(self) -> List[bytes]:
        return list(self)

    def __eq__(self, other) -> bool:
        try:
            if len(other) != len(self):
                return False
            return all(a == b for a, b in zip(self, other))
        except TypeError:
            return NotImplemented


@dataclass
class RawReads:
    """Struct-of-arrays of decoded BAM records (one BAM fetch worth)."""

    refid: np.ndarray       # int32 [R]
    pos: np.ndarray         # int32 [R] 0-based leftmost
    mapq: np.ndarray        # uint8 [R]
    flag: np.ndarray        # uint16 [R]
    mrefid: np.ndarray      # int32 [R]
    mpos: np.ndarray        # int32 [R]
    tlen: np.ndarray        # int32 [R]
    lseq: np.ndarray        # int32 [R]
    # ragged payloads
    cigar: np.ndarray       # uint32 flat
    cigar_off: np.ndarray   # int64 [R+1]
    seq: np.ndarray         # uint8 flat, ASCII bases
    qual: np.ndarray        # uint8 flat
    seq_off: np.ndarray     # int64 [R+1]
    names: List[bytes] = field(default_factory=list)
    sa_tags: List[Optional[bytes]] = field(default_factory=list)  # SA:Z or XP:Z payloads
    name_id: Optional[np.ndarray] = None   # int32 [R] interned name ids
    name_len: Optional[np.ndarray] = None  # uint8 [R] min(len, 255)

    def __len__(self) -> int:
        return len(self.pos)

    def cigar_of(self, i: int) -> np.ndarray:
        return self.cigar[self.cigar_off[i]:self.cigar_off[i + 1]]

    def seq_of(self, i: int) -> bytes:
        return self.seq[self.seq_off[i]:self.seq_off[i + 1]].tobytes()

    def qual_of(self, i: int) -> np.ndarray:
        return self.qual[self.seq_off[i]:self.seq_off[i + 1]]


def _parse_aux_sa(aux: memoryview) -> Optional[bytes]:
    """Extract the SA:Z (split alignment, BWA-mem) or XP:Z (older BWA) payload
    from a record's aux block. The reference prefers XP and falls back to SA
    (src/GROM.c:5757-5824); both carry (chr,pos,strand,CIGAR,mapq[,...])."""
    i = 0
    n = len(aux)
    xp = sa = None
    while i + 3 <= n:
        tag = bytes(aux[i:i + 2])
        typ = aux[i + 2]
        i += 3
        if typ in (ord("A"), ord("c"), ord("C")):
            i += 1
        elif typ in (ord("s"), ord("S")):
            i += 2
        elif typ in (ord("i"), ord("I"), ord("f")):
            i += 4
        elif typ in (ord("Z"), ord("H")):
            j = i
            while j < n and aux[j] != 0:
                j += 1
            if tag == b"SA":
                sa = bytes(aux[i:j])
            elif tag == b"XP":
                xp = bytes(aux[i:j])
            i = j + 1
        elif typ == ord("B"):
            sub = aux[i]
            cnt = struct.unpack_from("<I", aux, i + 1)[0]
            size = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
                    ord("i"): 4, ord("I"): 4, ord("f"): 4}[sub]
            i += 5 + cnt * size
        else:
            break
    return xp if xp is not None else sa


def decode_header(data) -> Tuple[BamHeader, int]:
    """``data``: bytes or uint8 ndarray (buffer-protocol agnostic)."""
    if bytes(memoryview(data)[:4]) != BAM_MAGIC:
        raise ValueError("not a BAM file")
    l_text = struct.unpack_from("<i", data, 4)[0]
    text = bytes(memoryview(data)[8:8 + l_text]).decode(errors="replace")
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", data, off)[0]
    off += 4
    names: List[str] = []
    lengths: List[int] = []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", data, off)[0]
        off += 4
        names.append(bytes(memoryview(data)[off:off + l_name - 1]).decode())
        off += l_name
        lengths.append(struct.unpack_from("<i", data, off)[0])
        off += 4
    return BamHeader(text, names, lengths), off


def _decode_records_native(data, start: int, end: int,
                           want_names: bool, want_sa: bool
                           ) -> Optional[RawReads]:
    """Native two-pass record decode (native/grom_native.c); returns None
    when the native library is unavailable. ``data`` may be bytes or a
    uint8 ndarray (zero-copy path from the pooled BGZF inflater)."""
    from grom_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None:
        return None
    import ctypes
    if isinstance(data, np.ndarray):
        data = data.ctypes.data_as(ctypes.c_void_p)
    v = ctypes.c_void_p
    if hasattr(lib, "gn_bam_offsets"):
        # one offsets walk + a THREADED payload fill: the first-touch page
        # faults of the seq/qual outputs dominate decode on this kernel
        # (~5s/GiB of sys time) and parallelize across fill workers
        cap = max((end - start) // 40, 64)
        while True:
            rec_off = np.empty(cap + 1, np.int64)
            nc_a = np.empty(cap, np.int32)
            ls_a = np.empty(cap, np.int32)
            lrn_a = np.empty(cap, np.uint8)
            sa_len = np.empty(cap, np.int32)
            R = lib.gn_bam_offsets(data, start, end,
                                   rec_off.ctypes.data_as(v),
                                   nc_a.ctypes.data_as(v),
                                   ls_a.ctypes.data_as(v),
                                   lrn_a.ctypes.data_as(v),
                                   sa_len.ctypes.data_as(v),
                                   1 if want_sa else 0, cap)
            if R == -2:
                cap *= 2
                continue
            if R < 0:
                return None
            break
        R = int(R)
        rec_off = rec_off[:R + 1]
        nc_a, ls_a, lrn_a, sa_len = (nc_a[:R], ls_a[:R], lrn_a[:R],
                                     sa_len[:R])
        cigar_off = np.zeros(R + 1, np.int64)
        np.cumsum(nc_a, out=cigar_off[1:])
        seq_off = np.zeros(R + 1, np.int64)
        np.cumsum(ls_a, out=seq_off[1:])
        name_off = np.zeros(R + 1, np.int64)
        if want_names:
            np.cumsum(lrn_a, out=name_off[1:], dtype=np.int64)
        sa_off = np.zeros(R + 1, np.int64)
        np.cumsum(np.maximum(sa_len, 0), out=sa_off[1:], dtype=np.int64)
        tc, ts = int(cigar_off[-1]), int(seq_off[-1])
        tn, tsa = int(name_off[-1]), int(sa_off[-1])
        lseq = ls_a
        refid = np.empty(R, np.int32)
        pos = np.empty(R, np.int32)
        mapq = np.empty(R, np.uint8)
        flag = np.empty(R, np.uint16)
        mrefid = np.empty(R, np.int32)
        mpos = np.empty(R, np.int32)
        tlen = np.empty(R, np.int32)
        lseq_o = np.empty(R, np.int32)
        cigar = np.empty(tc, np.uint32)
        seq = np.empty(ts, np.uint8)
        qual = np.empty(ts, np.uint8)
        names_buf = np.empty(tn if want_names else 0, np.uint8)
        sa_buf = np.empty(tsa, np.uint8)
        nthreads = min(os.cpu_count() or 1, 8)
        lib.gn_bam_fill_mt(
            data, rec_off.ctypes.data_as(v), ctypes.c_long(R),
            cigar_off.ctypes.data_as(v), seq_off.ctypes.data_as(v),
            name_off.ctypes.data_as(v), sa_off.ctypes.data_as(v),
            sa_len.ctypes.data_as(v),
            refid.ctypes.data_as(v), pos.ctypes.data_as(v),
            mapq.ctypes.data_as(v), flag.ctypes.data_as(v),
            mrefid.ctypes.data_as(v), mpos.ctypes.data_as(v),
            tlen.ctypes.data_as(v), lseq_o.ctypes.data_as(v),
            cigar.ctypes.data_as(v), seq.ctypes.data_as(v),
            qual.ctypes.data_as(v), names_buf.ctypes.data_as(v),
            sa_buf.ctypes.data_as(v),
            1 if want_names else 0, 1 if want_sa else 0, nthreads)
        lseq = lseq_o
    else:
        totals = np.zeros(4, np.int64)
        R = lib.gn_bam_count(data, start, end,
                             totals.ctypes.data_as(ctypes.c_void_p),
                             1 if want_sa else 0)
        if R < 0:
            return None
        R = int(R)
        tc, ts, tn, tsa = (int(x) for x in totals)
        refid = np.empty(R, np.int32)
        pos = np.empty(R, np.int32)
        mapq = np.empty(R, np.uint8)
        flag = np.empty(R, np.uint16)
        mrefid = np.empty(R, np.int32)
        mpos = np.empty(R, np.int32)
        tlen = np.empty(R, np.int32)
        lseq = np.empty(R, np.int32)
        cigar = np.empty(tc, np.uint32)
        cigar_off = np.empty(R + 1, np.int64)
        seq = np.empty(ts, np.uint8)
        qual = np.empty(ts, np.uint8)
        seq_off = np.empty(R + 1, np.int64)
        names_buf = np.empty(tn if want_names else 0, np.uint8)
        name_off = np.empty(R + 1, np.int64)
        sa_buf = np.empty(tsa, np.uint8)
        sa_off = np.empty(R + 1, np.int64)
        sa_len = np.empty(R, np.int32)
        arrs = [refid, pos, mapq, flag, mrefid, mpos, tlen, lseq, cigar,
                cigar_off, seq, qual, seq_off, names_buf, name_off]
        r2 = lib.gn_bam_fill(data, start, end,
                             *[a.ctypes.data_as(v) for a in arrs],
                             sa_buf.ctypes.data_as(v),
                             sa_off.ctypes.data_as(v),
                             sa_len.ctypes.data_as(v),
                             1 if want_names else 0, 1 if want_sa else 0)
        if int(r2) != R:
            return None
    name_id = name_len_a = None
    if want_names and R:
        # names stay in the flat buffer (LazyNames); materializing R bytes
        # objects per decode costs seconds on WGS-scale inputs
        names = LazyNames(names_buf, name_off) if tn else [b""] * R
        if tn and hasattr(lib, "gn_intern_names"):
            name_id = np.empty(R, np.int32)
            name_len_a = np.empty(R, np.uint8)
            nu = lib.gn_intern_names(names_buf.ctypes.data_as(v),
                                     name_off.ctypes.data_as(v),
                                     ctypes.c_long(R),
                                     name_id.ctypes.data_as(v),
                                     name_len_a.ctypes.data_as(v))
            if nu < 0:
                name_id = name_len_a = None
    else:
        names = []
    sa_tags: List[Optional[bytes]] = [None] * R
    if want_sa and tsa:
        sab = sa_buf.tobytes()
        for i in np.flatnonzero(sa_len >= 0):
            sa_tags[i] = sab[sa_off[i]:sa_off[i + 1]]
    return RawReads(refid, pos, mapq, flag, mrefid, mpos, tlen, lseq,
                    cigar, cigar_off, seq, qual, seq_off, names, sa_tags,
                    name_id=name_id, name_len=name_len_a)


def decode_records_fixed(data, start: int, end: Optional[int] = None
                         ) -> RawReads:
    """Fixed-fields-only decode: refid/pos/mapq/flag/mrefid/mpos/tlen/lseq,
    with every ragged payload left empty. This is all the insert-size
    estimator reads (src/GROM.c:1205-1318) at ~5x less memory traffic than
    a full decode. Falls back to the full decode without the native lib."""
    end = len(data) if end is None else end
    from grom_tpu_torch.native import get_lib
    lib = get_lib()
    if lib is None or not hasattr(lib, "gn_bam_fixed"):
        return decode_records(data, start, end, want_names=False,
                              want_sa=False)
    import ctypes
    ptr = data.ctypes.data_as(ctypes.c_void_p) \
        if isinstance(data, np.ndarray) else data
    v = ctypes.c_void_p
    cap = max((end - start) // 40, 64)
    while True:
        refid = np.empty(cap, np.int32)
        pos = np.empty(cap, np.int32)
        mapq = np.empty(cap, np.uint8)
        flag = np.empty(cap, np.uint16)
        mrefid = np.empty(cap, np.int32)
        mpos = np.empty(cap, np.int32)
        tlen = np.empty(cap, np.int32)
        lseq = np.empty(cap, np.int32)
        R = lib.gn_bam_fixed(ptr, start, end,
                             refid.ctypes.data_as(v), pos.ctypes.data_as(v),
                             mapq.ctypes.data_as(v), flag.ctypes.data_as(v),
                             mrefid.ctypes.data_as(v), mpos.ctypes.data_as(v),
                             tlen.ctypes.data_as(v), lseq.ctypes.data_as(v),
                             cap)
        if R == -2:
            cap *= 2
            continue
        if R < 0:
            return decode_records(data, start, end, want_names=False,
                                  want_sa=False)
        break
    R = int(R)
    e = np.empty
    return RawReads(refid[:R], pos[:R], mapq[:R], flag[:R], mrefid[:R],
                    mpos[:R], tlen[:R], lseq[:R],
                    e(0, np.uint32), np.zeros(R + 1, np.int64),
                    e(0, np.uint8), e(0, np.uint8), np.zeros(R + 1, np.int64),
                    [], [None] * R)


def decode_records(data: bytes, start: int, end: Optional[int] = None,
                   want_names: bool = True, want_sa: bool = True) -> RawReads:
    """Decode records from flat decompressed BAM bytes in [start, end)."""
    end = len(data) if end is None else end
    native = _decode_records_native(data, start, end, want_names, want_sa)
    if native is not None:
        return native
    mv = memoryview(data)
    offsets: List[int] = []
    off = start
    while off + 4 <= end:
        bs = int.from_bytes(mv[off:off + 4], "little")
        offsets.append(off)
        off += 4 + bs
    offsets_np = np.array(offsets, dtype=np.int64)
    R = len(offsets_np)
    if R == 0:
        e = np.empty
        return RawReads(e(0, np.int32), e(0, np.int32), e(0, np.uint8), e(0, np.uint16),
                        e(0, np.int32), e(0, np.int32), e(0, np.int32), e(0, np.int32),
                        e(0, np.uint32), np.zeros(1, np.int64), e(0, np.uint8),
                        e(0, np.uint8), np.zeros(1, np.int64), [], [])

    buf = np.frombuffer(data, dtype=np.uint8)

    def gather_i32(field_off: int) -> np.ndarray:
        idx = offsets_np + field_off
        b = (buf[idx].astype(np.uint32) | (buf[idx + 1].astype(np.uint32) << 8)
             | (buf[idx + 2].astype(np.uint32) << 16) | (buf[idx + 3].astype(np.uint32) << 24))
        return b.astype(np.int32)

    refid = gather_i32(4)
    pos = gather_i32(8)
    l_read_name = buf[offsets_np + 12].astype(np.int32)
    mapq = buf[offsets_np + 13]
    n_cigar = (buf[offsets_np + 16].astype(np.uint16)
               | (buf[offsets_np + 17].astype(np.uint16) << 8)).astype(np.int32)
    flag = (buf[offsets_np + 18].astype(np.uint16)
            | (buf[offsets_np + 19].astype(np.uint16) << 8))
    lseq = gather_i32(20)
    mrefid = gather_i32(24)
    mpos = gather_i32(28)
    tlen = gather_i32(32)

    cigar_off = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(n_cigar, out=cigar_off[1:])
    seq_off = np.zeros(R + 1, dtype=np.int64)
    np.cumsum(lseq, out=seq_off[1:])

    cigar = np.empty(int(cigar_off[-1]), dtype=np.uint32)
    seq = np.empty(int(seq_off[-1]), dtype=np.uint8)
    qual = np.empty(int(seq_off[-1]), dtype=np.uint8)
    names: List[bytes] = []
    sa_tags: List[Optional[bytes]] = []

    for i in range(R):
        o = int(offsets_np[i])
        bs = int.from_bytes(mv[o:o + 4], "little")
        lrn = int(l_read_name[i])
        nc = int(n_cigar[i])
        ls = int(lseq[i])
        p = o + 36
        if want_names:
            names.append(bytes(mv[p:p + lrn - 1]))
        p += lrn
        if nc:
            cigar[cigar_off[i]:cigar_off[i + 1]] = np.frombuffer(mv[p:p + 4 * nc], dtype=np.uint32)
        p += 4 * nc
        if ls:
            packed = np.frombuffer(mv[p:p + (ls + 1) // 2], dtype=np.uint8)
            hi = packed >> 4
            lo = packed & 0xF
            inter = np.empty(2 * len(packed), dtype=np.uint8)
            inter[0::2] = hi
            inter[1::2] = lo
            seq[seq_off[i]:seq_off[i + 1]] = NT16[inter[:ls]]
            p += (ls + 1) // 2
            qual[seq_off[i]:seq_off[i + 1]] = np.frombuffer(mv[p:p + ls], dtype=np.uint8)
            p += ls
        if want_sa:
            sa_tags.append(_parse_aux_sa(mv[p:o + 4 + bs]))
        else:
            sa_tags.append(None)

    return RawReads(refid, pos, mapq, flag, mrefid, mpos, tlen, lseq,
                    cigar, cigar_off, seq, qual, seq_off, names, sa_tags)


def read_bam(path: str, want_names: bool = True) -> Tuple[BamHeader, RawReads]:
    """Decode an entire BAM file (all references)."""
    data, _ = bgzf.read_bgzf(path, as_array=True)
    try:
        header, off = decode_header(data)
        return header, decode_records(data, off, want_names=want_names)
    finally:
        if isinstance(data, np.ndarray):
            from grom_tpu_torch.utils.bufpool import POOL
            POOL.release(data)


def alignment_ends(reads: RawReads) -> np.ndarray:
    """Per-record reference end position (pos + ref-consuming cigar span),
    the htslib bam_calend equivalent used for fetch overlap tests."""
    ops = reads.cigar & 0xF
    lens = (reads.cigar >> 4).astype(np.int64)
    consume = ((ops == 0) | (ops == 2) | (ops == 3) | (ops == 7)
               | (ops == 8))
    cs = np.concatenate([[0], np.cumsum(np.where(consume, lens, 0))])
    span = cs[reads.cigar_off[1:]] - cs[reads.cigar_off[:-1]]
    return reads.pos.astype(np.int64) + span


def read_bam_header(path: str) -> BamHeader:
    """Decode just the BAM header (inflates only the leading blocks)."""
    rdr = bgzf.BgzfRandomReader(path)
    nb = 1
    while True:
        head = rdr.inflate_blocks(0, nb)
        try:
            header, _ = decode_header(head)
            return header
        except (ValueError, struct.error, IndexError):
            if nb >= rdr.n_blocks:
                raise
            nb *= 2


def concat_raw(parts: List[RawReads]) -> RawReads:
    """Concatenate RawReads structs (record order = list order)."""
    parts = [p for p in parts if len(p)]
    if not parts:
        return decode_records(b"", 0, 0)
    if len(parts) == 1:
        return parts[0]

    def cat(field):
        return np.concatenate([getattr(p, field) for p in parts])

    def cat_off(field):
        offs = [parts[0].__getattribute__(field)]
        base = int(offs[0][-1])
        for p in parts[1:]:
            o = getattr(p, field)
            offs.append(o[1:] + base)
            base += int(o[-1])
        return np.concatenate(offs)

    sa: List[Optional[bytes]] = []
    for p in parts:
        sa.extend(p.sa_tags)

    # names: keep the flat-buffer form and re-intern GLOBALLY (per-part
    # name_id spaces are local; the SNV dedup needs one id space)
    names = []
    name_id = name_len = None
    if all(isinstance(p.names, LazyNames) for p in parts):
        nbuf = np.concatenate([p.names.buf for p in parts])
        offs = [parts[0].names.off]
        base = int(offs[0][-1])
        for p in parts[1:]:
            offs.append(p.names.off[1:] + base)
            base += int(p.names.off[-1])
        noff = np.concatenate(offs)
        names = LazyNames(nbuf, noff)
        from grom_tpu_torch.native import get_lib
        lib = get_lib()
        if lib is not None and hasattr(lib, "gn_intern_names"):
            import ctypes
            R = len(names)
            v = ctypes.c_void_p
            name_id = np.empty(R, np.int32)
            name_len = np.empty(R, np.uint8)
            nu = lib.gn_intern_names(nbuf.ctypes.data_as(v),
                                     noff.ctypes.data_as(v), ctypes.c_long(R),
                                     name_id.ctypes.data_as(v),
                                     name_len.ctypes.data_as(v))
            if nu < 0:
                name_id = name_len = None
    else:
        for p in parts:
            names.extend(p.names)
    return RawReads(cat("refid"), cat("pos"), cat("mapq"), cat("flag"),
                    cat("mrefid"), cat("mpos"), cat("tlen"), cat("lseq"),
                    cat("cigar"), cat_off("cigar_off"), cat("seq"),
                    cat("qual"), cat_off("seq_off"), names, sa,
                    name_id=name_id, name_len=name_len)


def find_bai(path: str) -> Optional[str]:
    for cand in (path + ".bai", path[:-4] + ".bai" if path.endswith(".bam")
                 else path + ".bai"):
        if os.path.exists(cand):
            return cand
    return None


# (path, mtime, size) -> (BgzfRandomReader, BamHeader, bai refs) — the
# streaming driver fetches regions of the same BAM once per chromosome;
# re-reading + re-scanning the compressed source each call costs ~1s per
# fetch on WGS-scale files. One entry: pipelines work one BAM at a time.
_READER_CACHE: Dict[Tuple[str, float, int], tuple] = {}
import threading as _threading  # noqa: E402
_READER_LOCK = _threading.Lock()


def _cached_reader(path: str, bai_path: str):
    with _READER_LOCK:
        return _cached_reader_locked(path, bai_path)


def _cached_reader_locked(path: str, bai_path: str):
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime, st.st_size)
    hit = _READER_CACHE.get(key)
    if hit is not None:
        return hit
    rdr = bgzf.BgzfRandomReader(path)
    # header: inflate leading blocks until it parses completely
    nb = 1
    while True:
        head = rdr.inflate_blocks(0, nb)
        try:
            header, _ = decode_header(head)
            break
        except (ValueError, struct.error, IndexError):
            if nb >= rdr.n_blocks:
                raise
            nb *= 2
    from grom_tpu_torch.ingest.bai import read_bai
    refs = read_bai(bai_path)
    _READER_CACHE.clear()
    _READER_CACHE[key] = (rdr, header, refs)
    return rdr, header, refs


def read_bam_region(path: str, refid: int, beg: int = 0,
                    end: Optional[int] = None, want_names: bool = True,
                    fields_only: bool = False
                    ) -> Tuple[BamHeader, RawReads]:
    """Decode only the records overlapping [beg, end) of one reference,
    using the BAI index for fetch planning — the equivalent of the
    reference's per-chromosome ``bam_fetch`` (src/GROM.c:981-992). Falls
    back to a full-file read (filtered) when no index is present.
    ``fields_only`` skips every ragged payload (see decode_records_fixed)."""
    from grom_tpu_torch.ingest.bai import region_chunks

    bai_path = find_bai(path)
    if bai_path is None:
        header, reads = read_bam(path, want_names=want_names)
        sel = np.flatnonzero(reads.refid == refid)
        from grom_tpu_torch.driver import _subset_reads
        return header, _subset_reads(reads, sel)

    rdr, header, refs = _cached_reader(path, bai_path)
    if end is None:
        end = header.ref_lengths[refid] if refid < header.n_ref else 1 << 29
    chunks = region_chunks(refs, refid, beg, max(end, beg + 1))
    parts: List[RawReads] = []
    for vs, ve in chunks:
        flat, s_off, e_off = rdr.span(vs, ve, as_array=True)
        try:
            parts.append(decode_records_fixed(flat, s_off, e_off)
                         if fields_only else
                         decode_records(flat, s_off, e_off,
                                        want_names=want_names))
        finally:
            if isinstance(flat, np.ndarray):
                from grom_tpu_torch.utils.bufpool import POOL
                POOL.release(flat)
    # release the compressed pages this fetch faulted in: streamed WGS
    # chromosomes otherwise accumulate the whole compressed BAM resident
    # per process (the pages stay in the shared OS page cache)
    rdr.drop_src_residency()
    reads = concat_raw(parts)
    keep = np.flatnonzero(reads.refid == refid)
    if len(keep) != len(reads):
        from grom_tpu_torch.driver import _subset_reads
        reads = _subset_reads(reads, keep)
    return header, reads


# ---------------------------------------------------------------------------
# Writer (tests + synthetic-data tooling)
# ---------------------------------------------------------------------------

def encode_cigar(ops: List[Tuple[int, int]]) -> bytes:
    return b"".join(struct.pack("<I", (length << 4) | op) for op, length in ops)


_SEQ_CODE: Dict[int, int] = {ord(c): i for i, c in enumerate("=ACMGRSVTWYHKDBN")}


def encode_record(name: bytes, flag: int, refid: int, pos: int, mapq: int,
                  cigar_ops: List[Tuple[int, int]], mrefid: int, mpos: int,
                  tlen: int, seq: bytes, qual: bytes,
                  aux: bytes = b"") -> bytes:
    n_cigar = len(cigar_ops)
    lseq = len(seq)
    # bin field: use reg2bin over the aligned span
    from grom_tpu_torch.ingest.bai import reg2bin
    ref_span = sum(l for op, l in cigar_ops if op in (CMATCH, CDEL, CREF_SKIP, CEQUAL, CDIFF))
    end = pos + max(ref_span, 1)
    bin_ = reg2bin(pos, end) if refid >= 0 and pos >= 0 else 4680
    packed = bytearray((lseq + 1) // 2)
    for i, b in enumerate(seq):
        code = _SEQ_CODE.get(b, 15)
        if i % 2 == 0:
            packed[i // 2] = code << 4
        else:
            packed[i // 2] |= code
    body = (
        struct.pack("<iiBBHHHiiii", refid, pos, len(name) + 1, mapq, bin_,
                    n_cigar, flag, lseq, mrefid, mpos, tlen)
        + name + b"\x00"
        + encode_cigar(cigar_ops)
        + bytes(packed)
        + bytes(qual)
        + aux
    )
    return struct.pack("<i", len(body)) + body


class BamWriter:
    """Write a coordinate-sorted BAM + BAI. Records must be appended in
    coordinate order; ``close`` emits both files."""

    def __init__(self, path: str, header: BamHeader):
        self._path = path
        self._header = header
        self._f = open(path, "wb")
        self._w = bgzf.BgzfWriter(self._f)
        self._w.write(header.encode())
        self._w.flush()  # header ends on block boundary → clean virtual offsets
        from grom_tpu_torch.ingest.bai import BaiBuilder
        self._bai = BaiBuilder(header.n_ref)

    def write_record(self, refid: int, pos: int, end: int, record: bytes) -> None:
        vstart = self._w.virtual_offset
        self._w.write(record)
        vend = self._w.virtual_offset
        if refid >= 0:
            self._bai.add(refid, pos, end, vstart, vend)

    def close(self) -> None:
        self._w.close()
        self._f.close()
        self._bai.write(self._path + ".bai")
