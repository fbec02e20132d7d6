"""The benchmark's own genome generator: a frozen copy of the port's
``testing/bulk_sim.py bulk_genome`` that imports nothing of the port.

Every read is a full-match proper FR pair (``read_len`` bases, 100 unless
a spec says otherwise) sampled from one of two haplotypes with substitution
errors; SNPs (``hom_share`` of them homozygous, a third unless a spec says
otherwise), depth hotspots, depressions and dinucleotide repeats are
planted per contig. It plants no indel, clip, discordant pair or SV: a
spec that asks for one (``indel_rate`` or ``sv_count`` above 0) is
refused. The BAM header
and records are written by this file's own encoder, and the BGZF blocks are
deflated on a thread pool (zlib releases the GIL); each block is deflated
on its own, so the bytes equal the serial result for the same specs.

``contig_stream`` is the one source of a contig's reads: the BAM writer
consumes it, and the plain reference (``plainref.py``) replays it from the
same seed after the measured window, so no read array is kept on disk or
in the measured process.
"""

from __future__ import annotations

import json
import os
import queue
import struct
import sys
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Tuple

import numpy as np

READ_LEN = 100                    # bulk_sim's, when a spec names none
NAME_LEN = 10                     # "r" + 8 digits + NUL
SEQ_AT = 4 + 32 + NAME_LEN + 4    # a record's packed bases start here
SLICE = 1_000_000                 # records assembled at a time
_BLOCK = 60000                    # BGZF payload bytes a block
_BASES = np.frombuffer(b"ACGT", np.uint8)
_NT16_OF = np.zeros(256, np.uint8)
for _b, _c in zip(b"ACGT", (1, 2, 4, 8)):
    _NT16_OF[_b] = _c
BAM_MAGIC = b"BAM\x01"
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def rec_size(rl: int) -> int:
    """Bytes of one record of ``rl`` bases (block size included)."""
    return SEQ_AT + rl // 2 + rl


def bam_header(names: List[str], lengths: List[int]) -> bytes:
    """The BAM header of a coordinate-sorted file over these references."""
    text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        "@SQ\tSN:%s\tLN:%d\n" % (n, L) for n, L in zip(names, lengths))
    out = [BAM_MAGIC, struct.pack("<i", len(text)), text.encode(),
           struct.pack("<i", len(names))]
    for name, length in zip(names, lengths):
        nb = name.encode() + b"\x00"
        out += [struct.pack("<i", len(nb)), nb, struct.pack("<i", length)]
    return b"".join(out)


def reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    e = end - 1
    out = np.zeros(len(beg), np.uint16)
    done = np.zeros(len(beg), bool)
    for shift, off in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        hit = (~done) & ((beg >> shift) == (e >> shift))
        out[hit] = (off + (beg[hit] >> shift)).astype(np.uint16)
        done |= hit
    return out


def _deflate_block(payload: bytes, level: int) -> bytes:
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    cdata = comp.compress(payload) + comp.flush()
    bsize = len(cdata) + 26
    return (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
            + struct.pack("<H", 6)
            + b"BC" + struct.pack("<H", 2) + struct.pack("<H", bsize - 1)
            + cdata
            + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                          len(payload)))


def contig_stream(spec: dict, refid: int) -> Iterator[dict]:
    """A contig's genome and reads, in the order ``bulk_genome`` draws them
    from ``np.random.default_rng(spec["seed"])``: first a dict with the
    genome (uint8, with N blocks and repeats), the coordinate-sorted record
    arrays (pos, mpos, tlen, flag, frag_id, mapq), the two haplotypes and
    each record's (``haps``, ``hap_of``); then one dict a slice of at most
    ``SLICE`` records with what is drawn for them: the error mask, the
    error bases and the qualities (``slice_bases`` makes the bases)."""
    RL = int(spec.get("read_len", READ_LEN))
    if RL % 2 or RL < 2:
        raise ValueError("read_len must be even, not %d" % RL)
    if spec.get("indel_rate", 0) or spec.get("sv_count", 0):
        raise ValueError("this generator plants no indels or SVs")
    length = int(spec["length"])
    rng = np.random.default_rng(spec.get("seed", refid))
    genome = rng.choice(_BASES, size=length).astype(np.uint8)
    if length > 400_000:
        genome[1000:1600] = ord("N")
        genome[length // 2:length // 2 + 800] = ord("N")
    for (rs, re_, dimer) in spec.get("repeats", []) or []:
        dimer = dimer.encode() if isinstance(dimer, str) else dimer
        pat = np.frombuffer(dimer * ((re_ - rs) // 2 + 1), np.uint8)
        genome[rs:re_] = pat[:re_ - rs]
    genome_out = genome.copy()

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

    n_snp = int(length * snp_rate)
    hap1 = genome.copy()
    hap0 = None
    if n_snp:
        sp = rng.choice(length, size=n_snp, replace=False)
        alt = _BASES[(np.searchsorted(_BASES, genome[sp]) % 4
                      + rng.integers(1, 4, n_snp)) % 4]
        hom = rng.random(n_snp) < spec.get("hom_share", 1.0 / 3.0)
        hap1[sp[hom]] = alt[hom]
        hap0 = hap1.copy()
        hap0[sp[~hom]] = alt[~hom]
    haps = np.stack([hap0 if hap0 is not None else hap1, hap1])
    hap_of = (frag_id % 2).astype(np.int64)
    del genome, hap0
    yield dict(genome=genome_out, pos=pos, mpos=mpos, tlen=tlen, flag=flag,
               frag_id=frag_id, mapq=mapq, haps=haps, hap_of=hap_of,
               read_len=RL)

    R = len(pos)
    for s0 in range(0, R, SLICE):
        s1 = min(s0 + SLICE, R)
        shape = (s1 - s0, RL)
        emask = rng.random(shape) < err
        err_base = rng.integers(0, 4, shape).astype(np.uint8)
        qual = rng.integers(30, 41, shape).astype(np.uint8)
        yield dict(s0=s0, s1=s1, emask=emask, err_base=err_base, qual=qual)


def slice_bases(head: dict, sl: dict) -> np.ndarray:
    """A slice's read bases: its fragments' haplotype, substitution errors
    where drawn, N read as A."""
    p_s = head["pos"][sl["s0"]:sl["s1"]]
    seq = head["haps"][head["hap_of"][sl["s0"]:sl["s1"], None],
                       p_s[:, None].astype(np.int64)
                       + np.arange(head["read_len"])]
    seq = np.where(sl["emask"], _BASES[sl["err_base"]], seq)
    return np.where(seq == ord("N"), ord("A"), seq).astype(np.uint8)


def _records(refid: int, head: dict, sl: dict) -> np.ndarray:
    """The BAM records of one slice as a [n, rec_size] byte matrix."""
    RL = head["read_len"]
    size = rec_size(RL)
    s0, s1 = sl["s0"], sl["s1"]
    n = s1 - s0
    p_s = head["pos"][s0:s1]
    rec = np.zeros((n, size), np.uint8)

    def put_i32(col, vals):
        rec[:, col:col + 4] = np.ascontiguousarray(
            vals.astype("<i4")).view(np.uint8).reshape(n, 4)

    def put_u16(col, vals):
        rec[:, col:col + 2] = np.ascontiguousarray(
            vals.astype("<u2")).view(np.uint8).reshape(n, 2)

    put_i32(0, np.full(n, size - 4, np.int32))
    put_i32(4, np.full(n, refid, np.int32))
    put_i32(8, p_s)
    rec[:, 12] = NAME_LEN
    rec[:, 13] = head["mapq"][s0:s1]
    put_u16(14, reg2bin(p_s.astype(np.int64), p_s.astype(np.int64) + RL))
    put_u16(16, np.ones(n, np.uint16))
    put_u16(18, head["flag"][s0:s1])
    put_i32(20, np.full(n, RL, np.int32))
    put_i32(24, np.full(n, refid, np.int32))
    put_i32(28, head["mpos"][s0:s1])
    put_i32(32, head["tlen"][s0:s1])
    digits = np.empty((n, 8), np.uint8)
    fid = head["frag_id"][s0:s1].copy()
    for d in range(7, -1, -1):
        digits[:, d] = ord("0") + (fid % 10)
        fid //= 10
    rec[:, 36] = ord("c") if refid % 2 else ord("r")
    rec[:, 37:45] = digits
    rec[:, 45] = 0
    put_i32(46, np.full(n, (RL << 4) | 0, np.int32))
    codes = _NT16_OF[slice_bases(head, sl)]
    rec[:, SEQ_AT:SEQ_AT + RL // 2] = (codes[:, 0::2] << 4) | codes[:, 1::2]
    rec[:, SEQ_AT + RL // 2:size] = sl["qual"]
    return rec


def _fasta_record(name: str, genome: np.ndarray) -> bytes:
    width = 70
    length = len(genome)
    rows = -(-length // width)
    padded = np.full(rows * width, ord(" "), np.uint8)
    padded[:length] = genome
    mat = np.empty((rows, width + 1), np.uint8)
    mat[:, :width] = padded.reshape(rows, width)
    mat[:, width] = ord("\n")
    return b">" + name.encode() + b"\n" + mat.tobytes().replace(b" ", b"")


def _bai_section(pos: np.ndarray, voff: np.ndarray, vend: np.ndarray,
                 RL: int) -> List[bytes]:
    R = len(pos)
    out = []
    bins = reg2bin(pos.astype(np.int64), pos.astype(np.int64) + RL)
    ub = np.unique(bins)
    out.append(struct.pack("<i", len(ub)))
    bo = np.argsort(bins, kind="stable")
    bounds = np.append(np.searchsorted(bins[bo], ub), R)
    for i, b in enumerate(ub):
        sel = bo[bounds[i]:bounds[i + 1]]
        if int(b) >= 4681:
            # a 16 kb bin: its reads are one contiguous run of the stream
            out.append(struct.pack("<Ii", int(b), 1))
            out.append(struct.pack("<QQ", int(voff[sel].min()),
                                   int(vend[sel].max())))
        else:
            # a coarse bin (window straddlers): one chunk a record
            vs = np.sort(voff[sel])
            ve = vend[sel][np.argsort(voff[sel], kind="stable")]
            out.append(struct.pack("<Ii", int(b), len(sel)))
            out.append(np.stack([vs, ve], axis=1).astype("<u8").tobytes())
    # linear index: a window's offset is the least over reads overlapping it
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
    return out


def _contig_blocks(spec: dict, refid: int, level: int,
                   deflate: ThreadPoolExecutor) -> dict:
    """One contig's FASTA record and its BAM records as deflated BGZF
    blocks: a helper thread draws the slices (the rng stream is sequential)
    while this one assembles each slice's records and hands its blocks to
    the ``deflate`` pool."""
    stream = contig_stream(spec, refid)
    head = next(stream)
    slices: queue.Queue = queue.Queue(maxsize=2)

    def draw():
        try:
            for sl in stream:
                slices.put(sl)
            slices.put(None)
        except BaseException as exc:  # surfaced to the assembling thread
            slices.put(exc)

    t = threading.Thread(target=draw, daemon=True)
    t.start()
    R = len(head["pos"])
    futures = []
    carry = np.zeros(0, np.uint8)
    while True:
        sl = slices.get()
        if isinstance(sl, BaseException):
            raise sl
        if sl is None:
            break
        flat = np.concatenate([carry, _records(refid, head, sl).reshape(-1)])
        if sl["s1"] < R:
            cut = (len(flat) // _BLOCK) * _BLOCK
            carry = flat[cut:].copy()
            flat = flat[:cut]
        else:
            carry = np.zeros(0, np.uint8)
        futures += _submit_blocks(deflate, flat, level)
    t.join()
    futures += _submit_blocks(deflate, carry, level)
    return dict(fasta=_fasta_record(spec["name"], head["genome"]),
                pos=head["pos"], read_len=head["read_len"],
                blocks=[f.result() for f in futures])


def _submit_blocks(pool: ThreadPoolExecutor, flat: np.ndarray, level: int):
    mv = memoryview(np.ascontiguousarray(flat))
    n = len(flat)
    return [pool.submit(_deflate_block, bytes(mv[b0:min(b0 + _BLOCK, n)]),
                        level) for b0 in range(0, n, _BLOCK)]


def bulk_genome(prefix: str, chrom_specs: List[dict], level: int = 1,
                threads: int = 0) -> Tuple[str, str, List[dict]]:
    """Write <prefix>.fa, <prefix>.bam and <prefix>.bam.bai for the contigs
    of ``chrom_specs`` (``{"name", "length", "seed"}`` and optionally
    ``coverage``, ``hotspots``, ``depressions``, ``repeats``, ``snp_rate``,
    ``err``, ``insert_mean``, ``insert_sd``, ``low_mapq_frac``,
    ``read_len``, ``hom_share``). Contigs are made up to four at a time and
    written in order. Returns (fasta, bam, per-contig {"name", "length",
    "reads", "read_len"})."""
    names = [s["name"] for s in chrom_specs]
    lengths = [int(s["length"]) for s in chrom_specs]
    fa, bam = prefix + ".fa", prefix + ".bam"
    threads = threads or min(8, os.cpu_count() or 1)
    bai_refs = []
    info = []
    with open(fa, "wb") as ffa, open(bam, "wb") as f, \
            ThreadPoolExecutor(threads) as deflate, \
            ThreadPoolExecutor(min(4, threads)) as contigs:
        # the header's blocks are deflated at level 1 whatever ``level``
        hdr = np.frombuffer(bam_header(names, lengths), np.uint8)
        for fut in _submit_blocks(deflate, hdr, 1):
            f.write(fut.result())
        base = f.tell()
        jobs = [contigs.submit(_contig_blocks, spec, refid, level, deflate)
                for refid, spec in enumerate(chrom_specs)]
        for spec, job in zip(chrom_specs, jobs):
            got = job.result()
            ffa.write(got["fasta"])
            pos = got["pos"]
            R = len(pos)
            sizes = np.array([len(b) for b in got["blocks"]], np.int64)
            for blk_bytes in got["blocks"]:
                f.write(blk_bytes)
            co = base + np.concatenate([[0], np.cumsum(sizes)])
            base = int(co[-1])
            size = rec_size(got["read_len"])
            off = np.arange(R, dtype=np.int64) * size
            blk = off // _BLOCK
            voff = (co[blk].astype(np.uint64) << np.uint64(16)) \
                | (off - blk * _BLOCK).astype(np.uint64)
            off_e = off + size
            blk_e = np.minimum(off_e // _BLOCK, len(co) - 2)
            vend = (co[blk_e].astype(np.uint64) << np.uint64(16)) \
                | (off_e - blk_e * _BLOCK).astype(np.uint64)
            bai_refs.append((pos, voff, vend, got["read_len"]))
            info.append(dict(name=spec["name"], length=int(spec["length"]),
                             reads=R, read_len=got["read_len"]))
        f.write(BGZF_EOF)
    out = [b"BAI\x01", struct.pack("<i", len(chrom_specs))]
    for (pos, voff, vend, rl) in bai_refs:
        out += _bai_section(pos, voff, vend, rl)
    with open(bam + ".bai", "wb") as fb:
        fb.write(b"".join(out))
    return fa, bam, info


def main(argv: List[str]) -> int:
    """``python3 synth.py <prefix> <specs.json>``: write the genome and
    print the per-contig list as JSON (the harness makes its inputs in
    this child process, so the measured one holds none of its memory)."""
    with open(argv[1]) as f:
        specs = json.load(f)
    fa, bam, info = bulk_genome(argv[0], specs)
    print(json.dumps(dict(fasta=fa, bam=bam, contigs=info)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
