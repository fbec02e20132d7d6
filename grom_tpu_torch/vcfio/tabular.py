"""Tabular (-f) output mode constants: the reference's non-VCF format
(src/GROM.c:20569-20665 main header; per-type row formats at the ``else``
branches of each ``g_vcf == 1`` emitter — SNV :11271, DUP :15347,
INV_F/R :15947/:16003, INS :16091, INDEL_INS :16342, INDEL_DEL :16490,
DEL :16564, CNV :17285/:17419, final CTX :22734)."""

from __future__ import annotations

# Column labels of the main-output header line (printed once after the
# insert-stats line, src/GROM.c:20571-20665). The trailing "" reproduces the
# reference's trailing tab. Most "Tumor" columns belong to the vestigial
# tumor/normal mode (SURVEY 2.15) and stay empty in practice.
MAIN_HEADER_COLS = [
    "SV", "Chromosome", "Start (Tumor)", "End (Tumor)", "Length (Tumor)",
    "P-val (Start, Tumor)", "P-val (End, Tumor)",
    "Concordant Pairs (Start, Tumor)", "Concordant Pairs (End, Tumor)",
    "Start or End?", "Read Depth (High MapQ, Normal)",
    "Read Depth (Low MapQ, Normal)", "Concordant Pairs (Normal)",
    "INS (Normal)", "DEL (For, Normal)", "DEL (Rev, Normal)",
    "DEL (For, Length, Normal)", "DEL (Rev, Length, Normal)",
    "DUP (Rev, Normal)", "DUP (For, Normal)", "DUP (Rev, Length, Normal)",
    "DUP (For, Length, Normal)", "INV (For, Start, Normal)",
    "INV (Rev, Start, Normal)", "INV (For, End, Normal)",
    "INV (Rev, End, Normal)", "INV (For, Start, Length, Normal)",
    "INV (Rev, Start, Length, Normal)", "INV (For, End, Length, Normal)",
    "INV (Rev, End, Length, Normal)", "Unmapped Mate (For, Normal)",
    "Unmapped Mate (Rev, Normal)", "Soft-clipping (Left, Normal)",
    "Soft-clipping (Right, Normal)", "Soft-clipping Read Depth (Left, Normal)",
    "Soft-clipping Read Depth (Right, Normal)",
    "Soft-clipping Read Depth (Left+Right, Normal)", "INS Indel (Normal)",
    "DEL Indel (Start, Normal)", "DEL Indel (End, Normal)",
    "DEL Indel (Start, Length, Normal)", "DEL Indel (End, Length, Normal)",
    "CTX Soft-clipping (Left, Normal)", "CTX Soft-clipping (Right, Normal)",
    "CTX Soft-clipping Read Depth (Left, Normal)",
    "CTX Soft-clipping Read Depth (Right, Normal)",
    "CTX Soft-clipping Read Depth (Left+Right, Normal)",
    "Indel Soft-clipping (Left, Normal)", "Indel Soft-clipping (Right, Normal)",
    "Indel Soft-clipping Read Depth (Left, Normal)",
    "Indel Soft-clipping Read Depth (Right, Normal)",
    "Indel Soft-clipping Read Depth (Left+Right, Normal)",
    "Soft-clipping (Left Max including CTX, Normal)",
    "Soft-clipping (Right Max including CTX, Normal)",
    "Other (Number of Non-Empty, Normal)", "CTX (For, Normal)",
    "CTX (Rev, Normal)", "SV Overlap (Normal)",
    "Other (Number of Non-Empty, Tumor)", "Read Start (Start, Tumor)",
    "Read End (Start, Tumor)", "Read Start (End, Tumor)",
    "Read End (End, Tumor)", "DEL Read Start (For/Rev, Normal)",
    "DEL Read End (For/Rev, Normal)", "DUP Read Start (Rev/For, Normal)",
    "DUP Read End (Rev/For, Normal)", "INV Read Start (For, Normal)",
    "INV Read End (For, Normal)", "INV Read Start (Rev, Normal)",
    "INV Read End (Rev, Normal)", "CTX Read Start (For, Normal)",
    "CTX Read End (For, Normal)", "CTX Read Start (Rev, Normal)",
    "CTX Read End (Rev, Normal)", "Mate Chr (CTX only, Tumor)",
    "Mate Pos (CTX only, Tumor)", "Mate Chr (For, Normal)",
    "Mate Pos (For, Normal)", "Mate Chr (Rev, Normal)",
    "Mate Pos (Rev, Normal)", "Reference Base", "SNV Base (Tumor)",
    "SNV Ratio (Tumor)", "SNV Count (A, Tumor)", "SNV Count (C, Tumor)",
    "SNV Count (G, Tumor)", "SNV Count (T, Tumor)", "SNV Count (A, Normal)",
    "SNV Count (C, Normal)", "SNV Count (G, Normal)", "SNV Count (T, Normal)",
    "",
]

MAIN_HEADER = "\t".join(MAIN_HEADER_COLS)

# CNV section header, printed before the DEL section and again before the DUP
# section of every chromosome (src/GROM.c:17247, :17380)
CNV_HEADER = "SV Type\tChromosome\tStart\tEnd\tStdev from mean\tP Value\tCopy Number"

# .ctx file header (src/GROM.c:22651-22667 tabular branch)
CTX_HEADER = ("SV\tChromosome\tStart\tID\tMate ID\tBinom Prob (Start)\t"
              "CTX evidence\tRead Depth (High MapQ)\tConcordant Pairs\t"
              "Other (Number of Non-Empty)\tMate Chr\tMate Pos\tRead Start\t"
              "Read End\tHez binom prob")


def main_prelude(insert_mean: int, insert_min: int, insert_max: int,
                 lseq: int) -> str:
    """Insert-stats line + column header (src/GROM.c:20569-20665)."""
    return "%d\t%d\t%d\t%d\n%s\n" % (insert_mean, insert_min, insert_max,
                                     lseq, MAIN_HEADER)
