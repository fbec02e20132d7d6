"""Insert-size estimation with the reference's exact semantics
(src/GROM.c:1205-1318) plus the ``<bam>.mean``-style cache re-expressed as a
JSON sidecar (src/GROM.c:994-1026).

Sampling: stream records in order until ``insert_sample_size`` samples;
unpaired reads contribute their read length, paired reads contribute isize
when (mate mapped, same tid, pos<mpos, proper pair, isize>0); FUNMAP/FDUP
records are excluded. ``mapped_read_bases`` counts l_qseq over sampled records
with mapq >= min_mapq.

Statistics: sort → median → drop inserts > 5*median → median again;
min/max are quantile picks with the reference's exact index arithmetic —
including ``max_index = end - min_index`` which reads one element PAST the
truncation point when min_index is 0 (an off-by-one we reproduce).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

from grom_tpu_torch.config import GromConfig
from grom_tpu_torch.ingest.bam import FDUP, FMUNMAP, FPAIRED, FPROPER_PAIR, FUNMAP, RawReads


@dataclass
class InsertStats:
    insert_mean: int
    insert_min: int
    insert_max: int
    read_len: int          # g_lseq (median sampled read length)
    mapped_read_bases: int  # g_mapped_reads

    def to_json(self) -> str:
        return json.dumps(self.__dict__)

    @staticmethod
    def from_json(s: str) -> "InsertStats":
        return InsertStats(**json.loads(s))


def estimate_insert_stats(reads: RawReads, cfg: GromConfig) -> InsertStats:
    flag = reads.flag
    usable = ((flag & FUNMAP) == 0) & ((flag & FDUP) == 0)
    unpaired = usable & ((flag & FPAIRED) == 0)
    paired_ok = (usable & ((flag & FPAIRED) != 0) & ((flag & FMUNMAP) == 0)
                 & (reads.refid == reads.mrefid)
                 & (reads.pos < reads.mpos)
                 & ((flag & FPROPER_PAIR) != 0)
                 & (reads.tlen > 0))
    contributes = unpaired | paired_ok
    # cap at sample size in record order
    idx = np.flatnonzero(contributes)
    # mapped_read_bases counts records examined while sampling (i.e. all
    # records until the sample fills); with fewer than sample_size samples
    # that's every record.
    if len(idx) > cfg.insert_sample_size:
        last = idx[cfg.insert_sample_size - 1]
        idx = idx[:cfg.insert_sample_size]
        examined = slice(0, last + 1)
    else:
        examined = slice(None)
    inserts = np.where(unpaired[idx], reads.lseq[idx], reads.tlen[idx]).astype(np.int64)
    lseqs = reads.lseq[idx].astype(np.int64)

    ex_flag = flag[examined]
    ex_ok = ((ex_flag & FUNMAP) == 0) & ((ex_flag & FDUP) == 0) & \
        (reads.mapq[examined] >= cfg.min_mapq)
    mapped_read_bases = int(reads.lseq[examined][ex_ok].sum())

    return stats_from_samples(inserts, lseqs, mapped_read_bases, cfg)


def stats_from_samples(inserts: np.ndarray, lseqs: np.ndarray,
                       mapped_read_bases: int, cfg: GromConfig) -> InsertStats:
    """The statistics tail shared by the in-memory and streaming samplers:
    sort → median → 5x-median truncation → quantile min/max with the
    reference's exact index arithmetic (src/GROM.c:1272-1297)."""
    count = len(inserts)
    if count == 0:
        return InsertStats(0, 0, 0, 0, mapped_read_bases)
    inserts = inserts.astype(np.int64, copy=False)
    lseqs = lseqs.astype(np.int64, copy=False)
    s = np.sort(inserts, kind="stable")
    median = int(s[count // 2])
    max_insert = median * cfg.insert_max_mult
    # index of last element <= max_insert, +1 (src/GROM.c:1284-1292)
    end = int(np.searchsorted(s, max_insert, side="right"))
    # (the reference scans from the top and breaks at the first <=; with all
    # elements > max_insert it leaves end=0+1 after the loop default fim_end=0)
    if end == 0:
        end = 1
    insert_mean = int(s[end // 2])
    prob2 = cfg.prob2
    min_index = int(prob2 * end / 2)
    max_index = end - min_index
    insert_min = int(s[min_index])
    # NOTE: when min_index == 0, max_index == end indexes one past the
    # truncation boundary (the smallest discarded insert, or garbage in the
    # reference when nothing was discarded). We clamp to the last element in
    # that case — the reference reads uninitialized memory there.
    insert_max = int(s[max_index]) if max_index < count else int(s[count - 1])

    sl = np.sort(lseqs, kind="stable")
    read_len = int(sl[count // 2])
    return InsertStats(insert_mean, insert_min, insert_max, read_len, mapped_read_bases)


def estimate_insert_stats_streaming(bam_path: str, cfg: GromConfig
                                    ) -> Optional[InsertStats]:
    """Single streaming pass over the BAM in bounded (~48MB uncompressed)
    block windows: the native gn_insert_scan collects samples record by
    record and the pass stops as soon as the reference's 10M-record sample
    fills (src/GROM.c:1205-1318) — no whole-file inflate, no per-read
    arrays. Returns None when the native library is unavailable."""
    import ctypes

    from grom_tpu_torch.ingest import bam as bam_mod
    from grom_tpu_torch.native import get_lib
    from grom_tpu_torch.utils.bufpool import POOL
    lib = get_lib()
    if lib is None or not hasattr(lib, "gn_insert_scan"):
        return None
    from grom_tpu_torch.ingest.bgzf import BgzfRandomReader
    bai = bam_mod.find_bai(bam_path)
    if bai is not None:
        # share the driver's cached reader (one compressed-source read and
        # block scan for the whole pipeline)
        rdr = bam_mod._cached_reader(bam_path, bai)[0]
    else:
        rdr = BgzfRandomReader(bam_path)
    # header end = first record's flat offset
    nb = 1
    while True:
        head = rdr.inflate_blocks(0, nb)
        try:
            _, first_off = bam_mod.decode_header(head)
            break
        except Exception:
            if nb >= rdr.n_blocks:
                return None
            nb *= 2
    cap = cfg.insert_sample_size
    inserts = np.empty(cap, np.int32)
    lseqs = np.empty(cap, np.int32)
    io = np.zeros(4, np.int64)
    v = ctypes.c_void_p
    cur = first_off
    uoff = rdr._uoff
    K = max(1, (48 << 20) // 65280)          # blocks per ~48MB window
    n_blocks = rdr.n_blocks
    while io[3] == 0:
        b = int(np.searchsorted(uoff, cur, side="right")) - 1
        if b >= n_blocks:
            break
        e = min(b + K, n_blocks)
        flat = rdr.inflate_blocks(b, e, as_array=True)
        try:
            start_in = cur - int(uoff[b])
            end_in = int(uoff[e] - uoff[b])
            nxt = lib.gn_insert_scan(
                flat.ctypes.data_as(v) if isinstance(flat, np.ndarray)
                else flat, start_in, end_in,
                inserts.ctypes.data_as(v), lseqs.ctypes.data_as(v),
                cap, cfg.min_mapq, io.ctypes.data_as(v))
        finally:
            if isinstance(flat, np.ndarray):
                POOL.release(flat)
        new_cur = int(uoff[b]) + int(nxt)
        if new_cur <= cur:
            if e >= n_blocks:
                break
            K *= 2                            # record longer than the window
            continue
        cur = new_cur
        if e >= n_blocks and cur >= int(uoff[n_blocks]) - 4:
            break
    n = int(io[0])
    return stats_from_samples(inserts[:n], lseqs[:n], int(io[1] + io[2]
                              if io[3] == 0 else io[1]), cfg)


def load_or_estimate(bam_path: str, reads: Optional[RawReads],
                     cfg: GromConfig, use_cache: bool = True) -> InsertStats:
    """``reads`` may be None: the full BAM is then decoded lazily, but only
    on a cache miss (regional workers normally hit the cache written by the
    parent — mirroring the reference's <bam>.mean cache, src/GROM.c:994)."""
    cache = bam_path + ".grom_tpu.mean.json"
    if use_cache and os.path.exists(cache):
        try:
            with open(cache) as f:
                return InsertStats.from_json(f.read())
        except (ValueError, KeyError):
            pass
    # the reference binary's own cache ("mean lseq min max mapped",
    # src/GROM.c:994-1026) is honored too, so a GROM user's working
    # directory drops in unchanged
    ref_cache = bam_path + ".mean"
    if use_cache and os.path.exists(ref_cache):
        try:
            with open(ref_cache) as f:
                v = f.read().split()
            if len(v) == 5:
                return InsertStats(int(v[0]), int(v[2]), int(v[3]),
                                   int(v[1]), int(v[4]))
        except (ValueError, OSError):
            pass
    if reads is None:
        from grom_tpu_torch.ingest.bam import read_bam
        _, reads = read_bam(bam_path, want_names=False)
    st = estimate_insert_stats(reads, cfg)
    try:
        with open(cache, "w") as f:
            f.write(st.to_json())
    except OSError:
        pass
    return st
