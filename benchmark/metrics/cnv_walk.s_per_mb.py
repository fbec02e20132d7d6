"""Seconds a called megabase of the CNV stage's host walk over the card's
per-seed results, span ``cnv.winscan_dev``."""

LABELS = ("cnv.winscan_dev",)


def read(ctx):
    got = [ctx["spans"][k] for k in LABELS if k in ctx["spans"]]
    return sum(got) / ctx["mb"] if got else None
