"""Vectorized WGS-scale dataset generator.

The variant-planting simulator (testing/simulate.py) builds each read
through a per-read Python mapping pipeline — perfect for golden-parity
fixtures, hopeless for the multi-hundred-megabase scale runs (hours for a
250Mb chromosome). This generator trades variant richness for speed: every
read is a full-match proper FR pair sampled from the reference with
substitution errors, so all records share one fixed layout and the whole
BAM (records, BGZF frames, BAI bins + linear index) is assembled as numpy
matrix operations. Throughput is compression-bound (~100-200 MB BAM/s).

Depth hotspots (``hotspots=[(start, end, extra_cov)]``) stress int32
accumulator margins; substitution errors still exercise the SNV caller.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from grom_tpu_torch.ingest import bam as bam_mod
from grom_tpu_torch.ingest.bgzf import BGZF_EOF

_READ_LEN = 100
_BLOCK = 60000
_BASES = np.frombuffer(b"ACGT", np.uint8)
_NT16_OF = np.zeros(256, np.uint8)
for _b, _c in zip(b"ACGT", (1, 2, 4, 8)):
    _NT16_OF[_b] = _c


def _write_fasta(path: str, name: str, genome: np.ndarray) -> None:
    width = 70
    L = len(genome)
    rows = -(-L // width)
    padded = np.full(rows * width, ord(" "), np.uint8)
    padded[:L] = genome
    mat = np.empty((rows, width + 1), np.uint8)
    mat[:, :width] = padded.reshape(rows, width)
    mat[:, width] = ord("\n")
    body = mat.tobytes().replace(b" ", b"")
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(body)


def _vec_reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    e = end - 1
    out = np.zeros(len(beg), np.uint16)
    done = np.zeros(len(beg), bool)
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = (~done) & ((beg >> shift) == (e >> shift))
        out[hit] = (off + (beg[hit] >> shift)).astype(np.uint16)
        done |= hit
    return out


def _bgzf_compress_stream(f, flat: np.ndarray, level: int = 1,
                          ) -> np.ndarray:
    """Write ``flat`` as BGZF blocks of <= _BLOCK payload bytes; returns the
    compressed offset of each block (relative to stream start)."""
    n = len(flat)
    nblk = -(-n // _BLOCK) if n else 0
    coffs = np.zeros(nblk + 1, np.int64)
    mv = memoryview(flat)
    pos = 0
    for b in range(nblk):
        payload = bytes(mv[b * _BLOCK:min((b + 1) * _BLOCK, n)])
        comp = zlib.compressobj(level, zlib.DEFLATED, -15)
        cdata = comp.compress(payload) + comp.flush()
        bsize = len(cdata) + 26
        out = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
               + struct.pack("<H", 6)
               + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize - 1)
               + cdata
               + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                             len(payload)))
        f.write(out)
        coffs[b] = pos
        pos += len(out)
    coffs[nblk] = pos
    return coffs


def bulk_dataset(prefix: str, length: int, coverage: float = 30.0,
                 seed: int = 0, err: float = 0.002,
                 insert_mean: int = 300, insert_sd: int = 30,
                 low_mapq_frac: float = 0.02,
                 hotspots: Optional[List[Tuple[int, int, float]]] = None,
                 snp_rate: float = 1e-3,
                 depressions: Optional[List[Tuple[int, int, float]]] = None,
                 repeats: Optional[List[Tuple[int, int, bytes]]] = None,
                 gc_blocks: Optional[List[Tuple[int, int, float]]] = None,
                 level: int = 1,
                 chrom_name: str = "chrbulk") -> Tuple[str, str]:
    """Generate <prefix>.fa / .bam / .bam.bai. Returns (fa, bam) paths.

    ``snp_rate`` plants het (2/3) and hom (1/3) substitution SNPs.
    ``gc_blocks=[(s, e, gc_frac)]`` rewrite reference spans with a biased
    GC composition (exercises the per-GC-bin CNV distributions).
    ``depressions=[(s, e, keep_frac)]`` thin fragments overlapping a
    window (deletion-like CNV signal). ``repeats=[(s, e, dimer)]`` plant
    dinucleotide repeat runs in the reference (the CNV engine's
    repeat-bias machinery, src/GROM.c:1727-1764 + :19018-19180).
    ``level`` is the BGZF deflate level (1 = fast for scale runs,
    6 = small for committed fixtures)."""
    rng = np.random.default_rng(seed)
    RL = _READ_LEN
    genome = rng.choice(_BASES, size=length).astype(np.uint8)
    # GC-composition blocks (``gc_blocks=[(s, e, gc_frac)]``): spread the
    # depth samples across the CNV engine's 101 GC bins (triangular GC
    # window, src/GROM.c:1766-1861; per-bin distributions :18385-18453)
    for (gs, ge, frac) in (gc_blocks or []):
        n = ge - gs
        is_gc = rng.random(n) < frac
        gc_pick = rng.choice(np.frombuffer(b"GC", np.uint8), size=n)
        at_pick = rng.choice(np.frombuffer(b"AT", np.uint8), size=n)
        genome[gs:ge] = np.where(is_gc, gc_pick, at_pick)
    # a couple of N blocks like real assemblies
    if length > 400_000:
        genome[1000:1600] = ord("N")
        genome[length // 2:length // 2 + 800] = ord("N")
    for (rs, re_, dimer) in (repeats or []):
        pat = np.frombuffer(dimer * ((re_ - rs) // 2 + 1), np.uint8)
        genome[rs:re_] = pat[:re_ - rs]
    fa = prefix + ".fa"
    _write_fasta(fa, chrom_name, genome)

    def fragments(n, lo, hi):
        isz = np.clip(rng.normal(insert_mean, insert_sd, n), 2 * RL + 10,
                      2 * insert_mean).astype(np.int64)
        p = rng.integers(lo, max(hi - int(isz.max()) - 1, lo + 1), n)
        return p, isz

    n_frag = int(length * coverage / (2 * RL))
    p, isz = fragments(n_frag, 0, length)
    if hotspots:
        for (hs, he, xc) in hotspots:
            nh = int((he - hs) * xc / (2 * RL))
            ph, ih = fragments(nh, hs, he)
            p = np.concatenate([p, ph])
            isz = np.concatenate([isz, ih])
    for (ds_, de_, keep) in (depressions or []):
        hit = (p + isz > ds_) & (p < de_)
        drop = hit & (rng.random(len(p)) >= keep)
        p, isz = p[~drop], isz[~drop]
    nf = len(p)

    # two records per fragment (read1 fwd at p, read2 rev at p+isz-RL)
    pos = np.concatenate([p, p + isz - RL])
    mpos = np.concatenate([p + isz - RL, p])
    tlen = np.concatenate([isz, -isz]).astype(np.int32)
    flag = np.concatenate([np.full(nf, 0x63, np.uint16),
                           np.full(nf, 0x93, np.uint16)])
    frag_id = np.concatenate([np.arange(nf), np.arange(nf)])
    mapq = np.where(rng.random(2 * nf) < low_mapq_frac, 10, 60) \
        .astype(np.uint8)

    order = np.argsort(pos, kind="stable")
    pos = pos[order].astype(np.int32)
    mpos = mpos[order].astype(np.int32)
    tlen = tlen[order]
    flag = flag[order]
    frag_id = frag_id[order]
    mapq = mapq[order]
    R = len(pos)

    # two haplotypes: hap1 = reference + hom SNPs; hap0 additionally
    # carries the het SNPs. Each FRAGMENT samples one haplotype.
    n_snp = int(length * snp_rate)
    hap1 = genome.copy()
    hap0 = None
    if n_snp:
        sp = rng.choice(length, size=n_snp, replace=False)
        alt = _BASES[(np.searchsorted(_BASES, genome[sp]) % 4
                      + rng.integers(1, 4, n_snp)) % 4]
        hom = rng.random(n_snp) < (1.0 / 3.0)
        hap1[sp[hom]] = alt[hom]
        hap0 = hap1.copy()
        hap0[sp[~hom]] = alt[~hom]
    haps = np.stack([hap0 if hap0 is not None else hap1, hap1])
    hap_of = (frag_id % 2).astype(np.int64)

    name_len = 10                     # "r" + 8 digits + NUL
    rec_sz = 4 + 32 + name_len + 4 + RL // 2 + RL

    header = bam_mod.BamHeader(
        "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:%s\tLN:%d\n"
        % (chrom_name, length), [chrom_name], [length])
    hdr_bytes = header.encode()
    bam = prefix + ".bam"

    # SLICED record assembly + compression: peak memory stays one slice
    # (~1GB) however long the chromosome — a 250Mb/30x run is ~75M records
    # and would otherwise materialize ~30GB of matrices at once.
    SLICE = 1_000_000
    coff_parts: List[np.ndarray] = []
    with open(bam, "wb") as f:
        hdr_coffs = _bgzf_compress_stream(
            f, np.frombuffer(hdr_bytes, np.uint8))
        base = int(hdr_coffs[-1])
        carry = np.zeros(0, np.uint8)   # partial BGZF block tail
        for s0 in range(0, R, SLICE):
            s1 = min(s0 + SLICE, R)
            n = s1 - s0
            p_s = pos[s0:s1]
            seq = haps[hap_of[s0:s1, None],
                       p_s[:, None].astype(np.int64) + np.arange(RL)]
            emask = rng.random(seq.shape) < err
            seq = np.where(emask, _BASES[rng.integers(0, 4, seq.shape)],
                           seq)
            seq = np.where(seq == ord("N"), ord("A"), seq)
            qual = rng.integers(30, 41, seq.shape).astype(np.uint8)

            rec = np.zeros((n, rec_sz), np.uint8)

            def put_i32(col, vals, n=n, rec=rec):
                rec[:, col:col + 4] = np.ascontiguousarray(
                    vals.astype("<i4")).view(np.uint8).reshape(n, 4)

            def put_u16(col, vals, n=n, rec=rec):
                rec[:, col:col + 2] = np.ascontiguousarray(
                    vals.astype("<u2")).view(np.uint8).reshape(n, 2)

            put_i32(0, np.full(n, rec_sz - 4, np.int32))
            put_i32(4, np.zeros(n, np.int32))
            put_i32(8, p_s)
            rec[:, 12] = name_len
            rec[:, 13] = mapq[s0:s1]
            put_u16(14, _vec_reg2bin(p_s.astype(np.int64),
                                     p_s.astype(np.int64) + RL))
            put_u16(16, np.ones(n, np.uint16))
            put_u16(18, flag[s0:s1])
            put_i32(20, np.full(n, RL, np.int32))
            put_i32(24, np.zeros(n, np.int32))
            put_i32(28, mpos[s0:s1])
            put_i32(32, tlen[s0:s1])
            digits = np.empty((n, 8), np.uint8)
            fid = frag_id[s0:s1].copy()
            for d in range(7, -1, -1):
                digits[:, d] = ord("0") + (fid % 10)
                fid //= 10
            rec[:, 36] = ord("r")
            rec[:, 37:45] = digits
            rec[:, 45] = 0
            put_i32(46, np.full(n, (RL << 4) | 0, np.int32))
            codes = _NT16_OF[seq]
            rec[:, 50:50 + RL // 2] = (codes[:, 0::2] << 4) \
                | codes[:, 1::2]
            rec[:, 100:100 + RL] = qual

            flat = np.concatenate([carry, rec.reshape(-1)])
            if s1 < R:
                cut = (len(flat) // _BLOCK) * _BLOCK
                carry = flat[cut:].copy()
                flat = flat[:cut]
            else:
                carry = np.zeros(0, np.uint8)
            co = _bgzf_compress_stream(f, flat, level)
            coff_parts.append(co[:-1] + base)
            base += int(co[-1])
        if len(carry):
            co = _bgzf_compress_stream(f, carry, level)
            coff_parts.append(co[:-1] + base)
            base += int(co[-1])
        f.write(BGZF_EOF)
    coffs = np.append(np.concatenate(coff_parts)
                      if coff_parts else np.zeros(0, np.int64), base)

    # ---- vectorized BAI ----
    off = np.arange(R, dtype=np.int64) * rec_sz
    blk = off // _BLOCK
    voff = (coffs[blk].astype(np.uint64) << np.uint64(16)) \
        | (off - blk * _BLOCK).astype(np.uint64)
    off_e = off + rec_sz
    blk_e = np.minimum(off_e // _BLOCK, len(coffs) - 2)
    vend = (coffs[blk_e].astype(np.uint64) << np.uint64(16)) \
        | (off_e - blk_e * _BLOCK).astype(np.uint64)
    bins = _vec_reg2bin(pos.astype(np.int64), pos.astype(np.int64) + RL)
    out = [b"BAI\x01", struct.pack("<i", 1)]
    ub = np.unique(bins)
    out.append(struct.pack("<i", len(ub)))
    bo = np.argsort(bins, kind="stable")
    bs = bins[bo]
    bounds = np.searchsorted(bs, ub)
    bounds = np.append(bounds, R)
    for i, b in enumerate(ub):
        sel = bo[bounds[i]:bounds[i + 1]]
        if int(b) >= 4681:
            # 16kb-level bin: its reads occupy one contiguous region of the
            # coordinate-sorted stream — a single min..max chunk is tight
            out.append(struct.pack("<Ii", int(b), 1))
            out.append(struct.pack("<QQ", int(voff[sel].min()),
                                   int(vend[sel].max())))
        else:
            # coarse bin (window straddlers, ~0.6% of reads): per-record
            # chunks — a min..max span here would cover most of the file
            # and every regional fetch would degenerate to a full decode
            vs = np.sort(voff[sel])
            ve = vend[sel][np.argsort(voff[sel], kind="stable")]
            out.append(struct.pack("<Ii", int(b), len(sel)))
            out.append(np.stack([vs, ve], axis=1).astype("<u8").tobytes())
    # linear index: a window's ioffset is the min voffset over reads
    # OVERLAPPING it (the BAI spec / samtools semantics) — registering only
    # the start window loses window-crossing reads from regional fetches
    win = (pos >> 14).astype(np.int64)
    win_end = ((pos + RL - 1) >> 14).astype(np.int64)
    n_intv = int(win_end.max()) + 1 if R else 0
    ioff = np.full(n_intv, np.iinfo(np.uint64).max, np.uint64)
    np.minimum.at(ioff, win, voff)
    np.minimum.at(ioff, win_end, voff)
    # forward-fill gaps with the previous value (0 before first)
    filled = np.minimum.accumulate(ioff) if n_intv else ioff
    have = ioff != np.iinfo(np.uint64).max
    last = np.where(have, ioff, np.uint64(0))
    for i in range(1, n_intv):
        if not have[i]:
            last[i] = last[i - 1]
    out.append(struct.pack("<i", n_intv))
    out.append(last.astype("<u8").tobytes())
    with open(bam + ".bai", "wb") as f:
        f.write(b"".join(out))
    return fa, bam


def bulk_genome(prefix: str, chrom_specs: List[dict],
                level: int = 1) -> Tuple[str, str]:
    """Multi-chromosome WGS-scale generator: one coordinate-sorted BAM (+BAI)
    and a multi-sequence FASTA. ``chrom_specs`` entries:
    ``{"name", "length", "coverage", "seed"}`` plus optional per-chromosome
    ``hotspots`` / ``depressions`` / ``repeats`` / ``snp_rate`` / ``err`` /
    ``insert_mean`` / ``insert_sd`` / ``low_mapq_frac`` (bulk_dataset
    semantics). This is the -P / whole-genome bench input (the reference's
    multi-chromosome regime, src/GROM.c:549-624)."""
    RL = _READ_LEN
    name_len = 10
    rec_sz = 4 + 32 + name_len + 4 + RL // 2 + RL
    names = [s["name"] for s in chrom_specs]
    lengths = [int(s["length"]) for s in chrom_specs]

    fa = prefix + ".fa"
    with open(fa, "wb") as ffa:
        pass
    header_txt = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        "@SQ\tSN:%s\tLN:%d\n" % (n, L) for n, L in zip(names, lengths))
    header = bam_mod.BamHeader(header_txt, names, lengths)
    bam = prefix + ".bam"

    bai_refs = []       # per ref: (pos, voff, vend) int/uint arrays
    with open(bam, "wb") as f:
        hdr_coffs = _bgzf_compress_stream(
            f, np.frombuffer(header.encode(), np.uint8))
        base = int(hdr_coffs[-1])
        for refid, spec in enumerate(chrom_specs):
            length = int(spec["length"])
            rng = np.random.default_rng(spec.get("seed", refid))
            genome = rng.choice(_BASES, size=length).astype(np.uint8)
            if length > 400_000:
                genome[1000:1600] = ord("N")
                genome[length // 2:length // 2 + 800] = ord("N")
            for (rs, re_, dimer) in spec.get("repeats", []) or []:
                pat = np.frombuffer(dimer * ((re_ - rs) // 2 + 1), np.uint8)
                genome[rs:re_] = pat[:re_ - rs]
            with open(fa, "ab") as ffa:
                width = 70
                rows = -(-length // width)
                padded = np.full(rows * width, ord(" "), np.uint8)
                padded[:length] = genome
                mat = np.empty((rows, width + 1), np.uint8)
                mat[:, :width] = padded.reshape(rows, width)
                mat[:, width] = ord("\n")
                ffa.write(b">" + spec["name"].encode() + b"\n")
                ffa.write(mat.tobytes().replace(b" ", b""))

            insert_mean = spec.get("insert_mean", 300)
            insert_sd = spec.get("insert_sd", 30)
            coverage = float(spec.get("coverage", 30.0))
            err = spec.get("err", 0.002)
            low_mapq_frac = spec.get("low_mapq_frac", 0.02)
            snp_rate = spec.get("snp_rate", 1e-3)

            def fragments(n, lo, hi):
                isz = np.clip(rng.normal(insert_mean, insert_sd, n),
                              2 * RL + 10, 2 * insert_mean).astype(np.int64)
                p = rng.integers(lo, max(hi - int(isz.max()) - 1, lo + 1), n)
                return p, isz

            n_frag = int(length * coverage / (2 * RL))
            p, isz = fragments(n_frag, 0, length)
            for (hs, he, xc) in spec.get("hotspots", []) or []:
                nh = int((he - hs) * xc / (2 * RL))
                ph, ih = fragments(nh, hs, he)
                p = np.concatenate([p, ph])
                isz = np.concatenate([isz, ih])
            for (ds_, de_, keep) in spec.get("depressions", []) or []:
                hit = (p + isz > ds_) & (p < de_)
                drop = hit & (rng.random(len(p)) >= keep)
                p, isz = p[~drop], isz[~drop]
            nf = len(p)
            pos = np.concatenate([p, p + isz - RL])
            mpos = np.concatenate([p + isz - RL, p])
            tlen = np.concatenate([isz, -isz]).astype(np.int32)
            flag = np.concatenate([np.full(nf, 0x63, np.uint16),
                                   np.full(nf, 0x93, np.uint16)])
            frag_id = np.concatenate([np.arange(nf), np.arange(nf)])
            mapq = np.where(rng.random(2 * nf) < low_mapq_frac, 10, 60) \
                .astype(np.uint8)
            order = np.argsort(pos, kind="stable")
            pos = pos[order].astype(np.int32)
            mpos = mpos[order].astype(np.int32)
            tlen, flag = tlen[order], flag[order]
            frag_id, mapq = frag_id[order], mapq[order]
            R = len(pos)

            n_snp = int(length * snp_rate)
            hap1 = genome.copy()
            hap0 = None
            if n_snp:
                sp = rng.choice(length, size=n_snp, replace=False)
                alt = _BASES[(np.searchsorted(_BASES, genome[sp]) % 4
                              + rng.integers(1, 4, n_snp)) % 4]
                hom = rng.random(n_snp) < (1.0 / 3.0)
                hap1[sp[hom]] = alt[hom]
                hap0 = hap1.copy()
                hap0[sp[~hom]] = alt[~hom]
            haps = np.stack([hap0 if hap0 is not None else hap1, hap1])
            hap_of = (frag_id % 2).astype(np.int64)
            del genome, hap0

            # record stream for this chromosome: fresh BGZF blocks per ref
            # (carry flushed at the end) so per-ref BAI offsets are local
            SLICE = 1_000_000
            coff_parts: List[np.ndarray] = []
            ref_base = base
            carry = np.zeros(0, np.uint8)
            for s0 in range(0, R, SLICE):
                s1 = min(s0 + SLICE, R)
                n = s1 - s0
                p_s = pos[s0:s1]
                seq = haps[hap_of[s0:s1, None],
                           p_s[:, None].astype(np.int64) + np.arange(RL)]
                emask = rng.random(seq.shape) < err
                seq = np.where(emask,
                               _BASES[rng.integers(0, 4, seq.shape)], seq)
                seq = np.where(seq == ord("N"), ord("A"), seq)
                qual = rng.integers(30, 41, seq.shape).astype(np.uint8)
                rec = np.zeros((n, rec_sz), np.uint8)

                def put_i32(col, vals, n=n, rec=rec):
                    rec[:, col:col + 4] = np.ascontiguousarray(
                        vals.astype("<i4")).view(np.uint8).reshape(n, 4)

                def put_u16(col, vals, n=n, rec=rec):
                    rec[:, col:col + 2] = np.ascontiguousarray(
                        vals.astype("<u2")).view(np.uint8).reshape(n, 2)

                put_i32(0, np.full(n, rec_sz - 4, np.int32))
                put_i32(4, np.full(n, refid, np.int32))
                put_i32(8, p_s)
                rec[:, 12] = name_len
                rec[:, 13] = mapq[s0:s1]
                put_u16(14, _vec_reg2bin(p_s.astype(np.int64),
                                         p_s.astype(np.int64) + RL))
                put_u16(16, np.ones(n, np.uint16))
                put_u16(18, flag[s0:s1])
                put_i32(20, np.full(n, RL, np.int32))
                put_i32(24, np.full(n, refid, np.int32))
                put_i32(28, mpos[s0:s1])
                put_i32(32, tlen[s0:s1])
                digits = np.empty((n, 8), np.uint8)
                fid = frag_id[s0:s1].copy()
                for d in range(7, -1, -1):
                    digits[:, d] = ord("0") + (fid % 10)
                    fid //= 10
                rec[:, 36] = ord("c") if refid % 2 else ord("r")
                rec[:, 37:45] = digits
                rec[:, 45] = 0
                put_i32(46, np.full(n, (RL << 4) | 0, np.int32))
                codes = _NT16_OF[seq]
                rec[:, 50:50 + RL // 2] = (codes[:, 0::2] << 4) \
                    | codes[:, 1::2]
                rec[:, 100:100 + RL] = qual
                flat = np.concatenate([carry, rec.reshape(-1)])
                if s1 < R:
                    cut = (len(flat) // _BLOCK) * _BLOCK
                    carry = flat[cut:].copy()
                    flat = flat[:cut]
                else:
                    carry = np.zeros(0, np.uint8)
                co = _bgzf_compress_stream(f, flat, level)
                coff_parts.append(co[:-1] + base)
                base += int(co[-1])
            if len(carry):
                co = _bgzf_compress_stream(f, carry, level)
                coff_parts.append(co[:-1] + base)
                base += int(co[-1])
            coffs = np.append(np.concatenate(coff_parts)
                              if coff_parts else np.zeros(0, np.int64), base)
            off = np.arange(R, dtype=np.int64) * rec_sz
            blk = off // _BLOCK
            voff = (coffs[blk].astype(np.uint64) << np.uint64(16)) \
                | (off - blk * _BLOCK).astype(np.uint64)
            off_e = off + rec_sz
            blk_e = np.minimum(off_e // _BLOCK, len(coffs) - 2)
            vend = (coffs[blk_e].astype(np.uint64) << np.uint64(16)) \
                | (off_e - blk_e * _BLOCK).astype(np.uint64)
            bai_refs.append((pos, voff, vend))
            del haps
        f.write(BGZF_EOF)

    # ---- vectorized BAI, one section per reference ----
    out = [b"BAI\x01", struct.pack("<i", len(chrom_specs))]
    for (pos, voff, vend) in bai_refs:
        R = len(pos)
        bins = _vec_reg2bin(pos.astype(np.int64), pos.astype(np.int64) + RL)
        ub = np.unique(bins)
        out.append(struct.pack("<i", len(ub)))
        bo = np.argsort(bins, kind="stable")
        bs = bins[bo]
        bounds = np.searchsorted(bs, ub)
        bounds = np.append(bounds, R)
        for i, b in enumerate(ub):
            sel = bo[bounds[i]:bounds[i + 1]]
            if int(b) >= 4681:
                out.append(struct.pack("<Ii", int(b), 1))
                out.append(struct.pack("<QQ", int(voff[sel].min()),
                                       int(vend[sel].max())))
            else:
                vs = np.sort(voff[sel])
                ve = vend[sel][np.argsort(voff[sel], kind="stable")]
                out.append(struct.pack("<Ii", int(b), len(sel)))
                out.append(np.stack([vs, ve], axis=1).astype("<u8").tobytes())
        win = (pos >> 14).astype(np.int64)
        win_end = ((pos + RL - 1) >> 14).astype(np.int64)
        n_intv = int(win_end.max()) + 1 if R else 0
        ioff = np.full(n_intv, np.iinfo(np.uint64).max, np.uint64)
        np.minimum.at(ioff, win, voff)
        np.minimum.at(ioff, win_end, voff)
        have = ioff != np.iinfo(np.uint64).max
        last = np.where(have, ioff, np.uint64(0))
        for i in range(1, n_intv):
            if not have[i]:
                last[i] = last[i - 1]
        out.append(struct.pack("<i", n_intv))
        out.append(last.astype("<u8").tobytes())
    with open(bam + ".bai", "wb") as fb:
        fb.write(b"".join(out))
    return fa, bam
