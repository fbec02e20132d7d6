"""BAI (BAM index) reader/writer using the standard UCSC R-tree binning.

The reference consumes indexes via htslib's ``bam_index_load``/``bam_fetch``
(src/GROM.c:22116-22143, :200-261). We read them to support region fetches
(sub-chromosome sharding) and write them so synthetic test BAMs are usable by
both engines.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

BAI_MAGIC = b"BAI\x01"


def reg2bin(beg: int, end: int) -> int:
    """Standard SAM-spec bin for a [beg, end) interval."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end)."""
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


class BaiBuilder:
    def __init__(self, n_ref: int):
        self.n_ref = n_ref
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = [dict() for _ in range(n_ref)]
        self.linear: List[Dict[int, int]] = [dict() for _ in range(n_ref)]

    def add(self, refid: int, beg: int, end: int, vstart: int, vend: int) -> None:
        b = reg2bin(beg, max(end, beg + 1))
        chunks = self.bins[refid].setdefault(b, [])
        if chunks and chunks[-1][1] == vstart:
            chunks[-1] = (chunks[-1][0], vend)
        else:
            chunks.append((vstart, vend))
        lin = self.linear[refid]
        for win in range(beg >> 14, ((max(end, beg + 1) - 1) >> 14) + 1):
            if win not in lin or lin[win] > vstart:
                lin[win] = vstart

    def write(self, path: str) -> None:
        out = [BAI_MAGIC, struct.pack("<i", self.n_ref)]
        for refid in range(self.n_ref):
            bins = self.bins[refid]
            out.append(struct.pack("<i", len(bins)))
            for b in sorted(bins):
                chunks = bins[b]
                out.append(struct.pack("<Ii", b, len(chunks)))
                for s, e in chunks:
                    out.append(struct.pack("<QQ", s, e))
            lin = self.linear[refid]
            n_intv = (max(lin) + 1) if lin else 0
            ioff = np.zeros(n_intv, dtype=np.uint64)
            last = 0
            for i in range(n_intv):
                if i in lin:
                    last = lin[i]
                ioff[i] = last
            out.append(struct.pack("<i", n_intv))
            out.append(ioff.tobytes())
        with open(path, "wb") as f:
            f.write(b"".join(out))


def read_bai(path: str) -> List[Tuple[Dict[int, List[Tuple[int, int]]], np.ndarray]]:
    """Returns per-reference (bins → chunk list, linear index)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != BAI_MAGIC:
        raise ValueError("not a BAI index")
    n_ref = struct.unpack_from("<i", data, 4)[0]
    off = 8
    refs = []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", data, off)[0]
        off += 4
        bins: Dict[int, List[Tuple[int, int]]] = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            chunks = []
            for _ in range(n_chunk):
                s, e = struct.unpack_from("<QQ", data, off)
                off += 16
                chunks.append((s, e))
            bins[b] = chunks
        n_intv = struct.unpack_from("<i", data, off)[0]
        off += 4
        ioff = np.frombuffer(data, dtype=np.uint64, count=n_intv, offset=off).copy()
        off += 8 * n_intv
        refs.append((bins, ioff))
    return refs


def region_chunks(refs, refid: int, beg: int, end: int) -> List[Tuple[int, int]]:
    """Candidate (vstart, vend) chunks overlapping a region, linear-index
    filtered and merged — the equivalent of htslib's fetch planning."""
    bins, ioff = refs[refid]
    min_voff = int(ioff[beg >> 14]) if (beg >> 14) < len(ioff) else 0
    chunks = []
    for b in reg2bins(beg, end):
        for s, e in bins.get(b, ()):
            if e > min_voff:
                chunks.append((max(s, min_voff), e))
    chunks.sort()
    merged: List[Tuple[int, int]] = []
    # Coalesce across small compressed gaps too, not just overlaps: every
    # extra span becomes a separate decode + a per-field concatenation of
    # ~100MB arrays whose fresh first-touch pages cost far more than
    # inflating and decoding the gap's few records (records in a gap are
    # position-filtered by the caller like any other fetch slack). 1MB
    # compressed ~= 4MB of records; a 1Mb dense-coverage fetch typically
    # collapses from ~7 spans to 1.
    GAP = 1 << 20
    for s, e in chunks:
        if merged and (s >> 16) - (merged[-1][1] >> 16) <= GAP:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged
