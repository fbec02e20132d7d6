"""Share of its memory roofline (``devtrace.roofline_share``) of the tile
kernel (csrc/tile_accumulate.cu ``tile_window`` and ``tile_compact``):
each aligned base's read base and quality byte read once, and the int32
per-base total written once a contig position, over every pass of the
window."""

import devtrace

KERNELS = ("tile_window", "tile_compact")


def read(ctx):
    per_pass = sum(2 * c["reads"] * c["read_len"] + 4 * c["length"]
                   for c in ctx["contigs"])
    return devtrace.roofline_share(ctx, KERNELS, per_pass * ctx["passes"])
