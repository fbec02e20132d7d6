"""FASTA indexing and chromosome loading.

Equivalent of the reference's ``find_genome_length`` (src/GROM.c:1321-1428:
chromosome names, file offsets, lengths, mappable (non-N) genome length) and
its per-chromosome loader (src/GROM.c:21009-21045), plus the ``<fasta>.info``
cache (src/GROM.c:1028-1081) re-expressed as a JSON sidecar.

Chromosomes load as uint8 ASCII arrays (case preserved — the reference emits
REF columns in original FASTA case, see SURVEY §4).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class GenomeInfo:
    names: List[str]            # as they appear in the FASTA
    lengths: List[int]
    offsets: List[int]          # file offset of first sequence byte
    line_bases: List[int]       # bases per line (0 = irregular)
    mappable_length: int        # non-N bases across the genome

    def to_json(self) -> str:
        return json.dumps(self.__dict__, indent=1)

    @staticmethod
    def from_json(s: str) -> "GenomeInfo":
        return GenomeInfo(**json.loads(s))


def index_fasta(path: str, use_cache: bool = True) -> GenomeInfo:
    cache = path + ".grom_tpu.info.json"
    if use_cache and os.path.exists(cache) and os.path.getmtime(cache) >= os.path.getmtime(path):
        with open(cache) as f:
            return GenomeInfo.from_json(f.read())

    names: List[str] = []
    lengths: List[int] = []
    offsets: List[int] = []
    line_bases: List[int] = []
    mappable = 0

    with open(path, "rb") as f:
        data = f.read()
    n = len(data)
    i = 0
    cur_len = 0
    cur_line = -1
    irregular = False

    def close_contig():
        nonlocal cur_len, cur_line, irregular
        if names:
            lengths.append(cur_len)
            line_bases.append(0 if irregular or cur_line < 0 else cur_line)
        cur_len = 0
        cur_line = -1
        irregular = False

    while i < n:
        if data[i] == ord(">"):
            close_contig()
            j = data.find(b"\n", i)
            if j < 0:
                j = n
            hdr = data[i + 1:j].split()
            names.append(hdr[0].decode() if hdr else "")
            offsets.append(j + 1)
            i = j + 1
        else:
            j = data.find(b"\n", i)
            if j < 0:
                j = n
            ll = j - i
            if ll:
                if cur_line < 0:
                    cur_line = ll
                elif ll != cur_line and j < n and (j + 1 >= n or data[j + 1] != ord(">")):
                    irregular = True
                cur_len += ll
                line = np.frombuffer(data, dtype=np.uint8, count=ll, offset=i)
                mappable += int(np.count_nonzero((line != ord("N")) & (line != ord("n"))))
            i = j + 1
    close_contig()

    info = GenomeInfo(names, lengths, offsets, line_bases, mappable)
    try:
        with open(cache, "w") as f:
            f.write(info.to_json())
    except OSError:
        pass
    return info


def load_chromosome(path: str, info: GenomeInfo, name: str) -> np.ndarray:
    """One chromosome as uint8 ASCII, case preserved."""
    idx = info.names.index(name)
    with open(path, "rb") as f:
        f.seek(info.offsets[idx])
        # read until next '>' or EOF
        end = info.offsets[idx + 1] if idx + 1 < len(info.offsets) else None
        raw = f.read((end - info.offsets[idx]) if end else -1)
    stop = raw.find(b">")
    if stop >= 0:
        raw = raw[:stop]
    arr = np.frombuffer(raw, dtype=np.uint8)
    return arr[(arr != ord("\n")) & (arr != ord("\r"))].copy()


def match_chromosome(bam_name: str, fasta_names: List[str]) -> Optional[str]:
    """BAM↔FASTA chromosome name matching with optional 'chr' prefix on
    either side, case-insensitive (src/GROM.c:1916-1977)."""
    bl = bam_name.lower()
    lower = {fn.lower(): fn for fn in fasta_names}
    if bl in lower:
        return lower[bl]
    if bl.startswith("chr") and bl[3:] in lower:
        return lower[bl[3:]]
    if "chr" + bl in lower:
        return lower["chr" + bl]
    return None


def is_chrx(name: str) -> bool:
    n = name.lower()
    return n in ("chrx", "x")


def is_chry(name: str) -> bool:
    n = name.lower()
    return n in ("chry", "y")


def n_blocks(chrom: np.ndarray, min_n_size: int = 100) -> np.ndarray:
    """Spans of >=min_n_size consecutive N/n (src/GROM.c:1684-1723).
    Returns int64 [K, 2] of [start, end) pairs."""
    is_n = (chrom == ord("N")) | (chrom == ord("n"))
    if not is_n.any():
        return np.empty((0, 2), dtype=np.int64)
    d = np.diff(is_n.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if is_n[0]:
        starts = np.concatenate([[0], starts])
    if is_n[-1]:
        ends = np.concatenate([ends, [len(chrom)]])
    spans = np.stack([starts, ends], axis=1)
    return spans[(spans[:, 1] - spans[:, 0]) >= min_n_size]
