"""Share of its memory roofline (``devtrace.roofline_share``) of the CNV
z-scores (csrc/cnv.cu ``zs_table``, ``zs_onepass``) and null model
(``null_prefix``, ``null_carry``, ``null_accum``): a contig position's
depth (int32), mean mapq (int16), GC bin and ACGT gate (a byte each) read
and its z (float64) written, then z and the gate read again, over every
pass of the window."""

import devtrace

KERNELS = ("zs_table", "zs_onepass", "null_prefix", "null_carry",
           "null_accum")
BYTES_PER_BASE = 4 + 2 + 1 + 1 + 8 + 8 + 1


def read(ctx):
    per_pass = sum(BYTES_PER_BASE * c["length"] for c in ctx["contigs"])
    return devtrace.roofline_share(ctx, KERNELS, per_pass * ctx["passes"])
