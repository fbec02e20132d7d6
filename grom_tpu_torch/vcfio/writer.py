"""VCF output in the reference's exact formats.

Header text reproduces src/GROM.c:20517-20564 verbatim (including the
unpadded ##fileDate, the CLI-path ##reference line, and the four CNV FORMAT
lines that are missing their closing '>'); record emitters live with their
callers (call/snv.py etc.) since each variant class has its own quirks
(SURVEY §4).
"""

from __future__ import annotations

import time
from typing import List, Optional

_HEADER_BODY = """##ALT=<ID=DEL,Description="Deletion">
##ALT=<ID=DUP,Description="Duplication">
##ALT=<ID=INS,Description="Insertion">
##ALT=<ID=INV,Description="Inversion">
##INFO=<ID=END,Number=1,Type=Integer,Description="End position of the structural variant">
##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">
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
##FORMAT=<ID=SD,Number=1,Type=Float,Description="CNV standard deviation"
##FORMAT=<ID=Z,Number=1,Type=Float,Description="CNV probability score"
##FORMAT=<ID=CN,Number=1,Type=Float,Description="CNV copy number"
##FORMAT=<ID=CS,Number=1,Type=Float,Description="CNV copy number standard deviation"
#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT
"""


def vcf_header(reference_path: str, file_date: Optional[str] = None) -> str:
    """Main VCF header (src/GROM.c:20517-20564). ``##fileDate`` is
    year-month-day with NO zero padding, exactly as the reference's
    %d%d%d printf."""
    if file_date is None:
        t = time.localtime()
        file_date = f"{t.tm_year}{t.tm_mon}{t.tm_mday}"
    head = (f"##fileformat=VCFv4.2\n##fileDate={file_date}\n"
            f"##reference={reference_path}\n")
    return head + _HEADER_BODY.replace("\\t", "\t")


class VcfWriter:
    def __init__(self, path: str, reference_path: str,
                 file_date: Optional[str] = None,
                 prelude: Optional[str] = None):
        """``prelude`` overrides the VCF header — used by the tabular (-f)
        mode, whose files start with the insert-stats line + column header
        instead (src/GROM.c:20569-20665)."""
        self._f = open(path, "w")
        self._f.write(prelude if prelude is not None
                      else vcf_header(reference_path, file_date))

    def write_rows(self, rows: List[str]) -> None:
        for r in rows:
            self._f.write(r)
            if not r.endswith("\n"):
                self._f.write("\n")

    def append_file(self, path: str) -> None:
        """Append a headerless partial-row file (the -P workers' on-disk
        results — the reference's ``cat part >> out`` merge,
        src/GROM.c:612-622) without loading it into memory."""
        import shutil
        self._f.flush()
        with open(path, "r") as src:
            shutil.copyfileobj(src, self._f)

    def close(self) -> None:
        self._f.close()
