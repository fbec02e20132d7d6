"""Seconds a called megabase of the CNV stage, span ``call.cnv``."""

LABELS = ("call.cnv",)


def read(ctx):
    got = [ctx["spans"][k] for k in LABELS if k in ctx["spans"]]
    return sum(got) / ctx["mb"] if got else None
