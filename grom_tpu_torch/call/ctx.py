"""Cross-chromosome translocation (CTX) merge and BND VCF output.

Re-expresses the reference's post-pass in main (src/GROM.c:22400-22770):
per-chromosome CTX_F/CTX_R candidate records are reciprocally mate-matched,
deduplicated (worse p-value loses; ties favor the earlier record), and
written as VCF BND rows with bracket notation. The record ID is the row's
index in the concatenated candidate order and MATEID is the mate's index —
exactly as the reference numbers them.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional

from grom_tpu_torch.config import DerivedConfig, GromConfig

CTX_F_TYPE, CTX_R_TYPE = 6, 7  # g_sv_types indexes (src/GROM.c:867-868)


@dataclass
class CtxRecord:
    type: int          # 6 = CTX_F, 7 = CTX_R
    chrom: int         # BAM target index
    pos: int
    binom: float
    ev: float          # evidence/add_factor (already divided)
    rd: int
    conc: int
    other_len: int
    mchr: int
    mpos: int          # sign encodes mate strand
    read_start: int
    read_end: int
    hez: float
    # merge state
    matched: bool = False
    mateid: int = -1


def parse_ctx_records(lines: List[str], chr_name_to_idx) -> List[CtxRecord]:
    """Parse the intermediate 'CTX_F\\tchr\\tpos\\t...' records
    (format written at src/GROM.c:16168/16244)."""
    out = []
    for line in lines:
        t = line.rstrip("\n").split("\t")
        typ = CTX_F_TYPE if t[0] == "CTX_F" else CTX_R_TYPE
        out.append(CtxRecord(
            type=typ, chrom=chr_name_to_idx.get(t[1].lower(), -1),
            pos=int(t[2]), binom=float(t[3]), ev=float(t[4]), rd=int(t[5]),
            conc=int(t[6]), other_len=int(t[7]), mchr=int(t[8]),
            mpos=int(t[9]), read_start=int(t[10]), read_end=int(t[11]),
            hez=float(t[12])))
    return out


def merge_ctx(records: List[CtxRecord], cfg: GromConfig,
              drv: DerivedConfig) -> None:
    """Reciprocal mate matching (src/GROM.c:22575-22599) then duplicate
    suppression (src/GROM.c:22600-22619), mutating records in place."""
    lim = drv.insert_max - 2 * drv.read_len
    n = len(records)
    for b in range(n):
        rb = records[b]
        for c in range(n):
            rc = records[c]
            if rb.chrom == rc.mchr and rc.chrom == rb.mchr:
                if (abs(rb.pos - abs(rc.mpos)) < lim
                        and abs(rc.pos - abs(rb.mpos)) < lim):
                    if (((rb.type == CTX_F_TYPE and rc.mpos >= 0)
                         or (rb.type == CTX_R_TYPE and rc.mpos < 0))
                            and ((rc.type == CTX_F_TYPE and rb.mpos >= 0)
                                 or (rc.type == CTX_R_TYPE and rb.mpos < 0))):
                        rb.matched = True
                        rb.mateid = c
                        rb.mpos = -rc.pos if rb.mpos < 0 else rc.pos
    for b in range(n):
        rb = records[b]
        for c in range(n):
            rc = records[c]
            if b != c and rb.chrom == rc.chrom and rb.mchr == rc.mchr:
                if (abs(rb.pos - rc.pos) < lim
                        and abs(abs(rb.mpos) - abs(rc.mpos)) < lim):
                    if rb.matched and rc.matched and \
                            (rb.binom > rc.binom or (rb.binom == rc.binom and b > c)):
                        rb.matched = False
                        if rb.mateid >= 0:
                            records[rb.mateid].matched = False


_CTX_HEADER_TAIL = """##ALT=<ID=DEL,Description="Deletion">
##ALT=<ID=DUP,Description="Duplication">
##ALT=<ID=INS,Description="Insertion">
##ALT=<ID=INV,Description="Inversion">
##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the structural variant">
##FORMAT=<ID=SPR,Number=1,Type=Float,Description="Probability of start breakpoint evidence occurring by chance">
##FORMAT=<ID=EPR,Number=1,Type=Float,Description="Probability of end breakpoint evidence occurring by chance">
##FORMAT=<ID=SEV,Number=1,Type=Integer,Description="Evidence supporting variant at start breakpoint">
##FORMAT=<ID=EEV,Number=1,Type=Integer,Description="Evidence supporting variant at end breakpoint">
##FORMAT=<ID=SRD,Number=1,Type=Integer,Description="Physical read depth at start breakpoint">
##FORMAT=<ID=ERD,Number=1,Type=Integer,Description="Physical read depth at end breakpoint">
##FORMAT=<ID=SCO,Number=1,Type=Integer,Description="Concordant pairs at start breakpoint">
##FORMAT=<ID=ECO,Number=1,Type=Integer,Description="Concordant pairs at end breakpoint">
##FORMAT=<ID=SOT,Number=1,Type=Integer,Description="Count of distinct SVs with evidence at start breakpoint">
##FORMAT=<ID=EOT,Number=1,Type=Integer,Description="Count of distinct SVs with evidence at end breakpoint">
##FORMAT=<ID=SSC,Number=1,Type=Integer,Description="Soft-clipped reads at start breakpoint">
##FORMAT=<ID=ESC,Number=1,Type=Integer,Description="Soft-clipped at end breakpoint">
##FORMAT=<ID=SFR,Number=1,Type=Integer,Description="Position of first read supporting start breakpoint">
##FORMAT=<ID=SLR,Number=1,Type=Integer,Description="Position of last read supporting start breakpoint">
##FORMAT=<ID=EFR,Number=1,Type=Integer,Description="Position of first read supporting end breakpoint">
##FORMAT=<ID=ELR,Number=1,Type=Integer,Description="Position of last read supporting end breakpoint">
##FORMAT=<ID=AF,Number=1,Type=Float,Description="Allele frequency (high mapping quality reads)">
##FORMAT=<ID=PR,Number=1,Type=Float,Description="Probability of SNV evidence occurring by chance">
##FORMAT=<ID=A,Number=1,Type=Integer,Description="A nucleotides (high mapping quality reads)">
##FORMAT=<ID=C,Number=1,Type=Integer,Description="C nucleotides (high mapping quality reads)">
##FORMAT=<ID=G,Number=1,Type=Integer,Description="G nucleotides (high mapping quality reads)">
##FORMAT=<ID=T,Number=1,Type=Integer,Description="T nucleotides (high mapping quality reads)">
##FORMAT=<ID=AL,Number=1,Type=Integer,Description="A nucleotides (low mapping quality reads)">
##FORMAT=<ID=CL,Number=1,Type=Integer,Description="C nucleotides (low mapping quality reads)">
##FORMAT=<ID=GL,Number=1,Type=Integer,Description="G nucleotides (low mapping quality reads)">
##FORMAT=<ID=TL,Number=1,Type=Integer,Description="T nucleotides (low mapping quality reads)">
##FORMAT=<ID=BQ,Number=1,Type=Float,Description="Average base quality (all reads)">
##FORMAT=<ID=MQ,Number=1,Type=Float,Description="Average mapping quality (all reads)">
##FORMAT=<ID=PIR,Number=1,Type=Float,Description="Average distance of SNV from DNA fragment end)">
##FORMAT=<ID=FS,Number=1,Type=Integer,Description="SNV reads mapped to forward strand)">
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT
"""


def ctx_vcf_header(reference_path: str, file_date: Optional[str] = None) -> str:
    """The ctx.vcf header (src/GROM.c:22639-22677) — note it has no GT line
    and no CNV FORMAT lines, unlike the main header."""
    if file_date is None:
        t = time.localtime()
        file_date = f"{t.tm_year}{t.tm_mon}{t.tm_mday}"
    return (f"##fileformat=VCFv4.2\n##fileDate={file_date}\n"
            f"##reference={reference_path}\n"
            + _CTX_HEADER_TAIL.replace("\\t", "\t"))


def bnd_alt(rec: CtxRecord, chr_names_lower: List[str]) -> str:
    """Bracket notation (src/GROM.c:22712-22729); mate position is printed
    0-based (no +1)."""
    mname = chr_names_lower[rec.mchr] if 0 <= rec.mchr < len(chr_names_lower) else "?"
    mp = abs(rec.mpos)
    if rec.type == CTX_F_TYPE:
        return f"N[{mname}:{mp}[" if rec.mpos < 0 else f"N]{mname}:{mp}]"
    return f"[{mname}:{mp}[N" if rec.mpos < 0 else f"]{mname}:{mp}]N"


def write_ctx_vcf(path: str, ctx_lines: List[str], bam_chr_names: List[str],
                  cfg: GromConfig, drv: Optional[DerivedConfig],
                  file_date: Optional[str] = None,
                  reference_path: Optional[str] = None) -> int:
    """Merge candidate records and write the final .ctx.vcf. Returns the
    number of emitted BND rows."""
    names_lower = [n.lower() for n in bam_chr_names]
    idx = {n: i for i, n in enumerate(names_lower)}
    records = parse_ctx_records(ctx_lines, idx)
    if drv is not None:
        merge_ctx(records, cfg, drv)
    with open(path, "w") as f:
        if cfg.vcf_output:
            f.write(ctx_vcf_header(reference_path or cfg.ref_fasta, file_date))
        else:
            from grom_tpu_torch.vcfio.tabular import CTX_HEADER
            f.write(CTX_HEADER + "\n")
        count = 0
        for b, rec in enumerate(records):
            if not rec.matched:
                continue
            count += 1
            if cfg.vcf_output:
                f.write("%s\t%d\t%d\tN\t%s\t.\t.\tSVTYPE=BND;MATEID=%d\t"
                        "SPR:SEV:SRD:SCO:SOT:SFR:SLR:SHPR\t"
                        "%e:%.1f:%d:%d:%d:%d:%d:%e\n"
                        % (names_lower[rec.chrom], rec.pos + 1, b,
                           bnd_alt(rec, names_lower), rec.mateid, rec.binom,
                           rec.ev, rec.rd, rec.conc, rec.other_len,
                           rec.read_start + 1, rec.read_end + 1, rec.hez))
            else:
                # tabular final row (src/GROM.c:22734): 0-based, signed mpos
                f.write("%s\t%s\t%d\t%d\t%d\t%e\t%.1f\t%d\t%d\t%d\t%s\t%d\t"
                        "%d\t%d\t%e\n"
                        % ("CTX_F" if rec.type == CTX_F_TYPE else "CTX_R",
                           names_lower[rec.chrom], rec.pos, b, rec.mateid,
                           rec.binom, rec.ev, rec.rd, rec.conc,
                           rec.other_len, names_lower[rec.mchr], rec.mpos,
                           rec.read_start, rec.read_end, rec.hez))
    return count
