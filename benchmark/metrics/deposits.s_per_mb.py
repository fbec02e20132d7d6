"""Seconds a called megabase of ``scan.deposits`` (call/deposits.py)."""

LABELS = ("scan.deposits",)


def read(ctx):
    got = [ctx["spans"][k] for k in LABELS if k in ctx["spans"]]
    return sum(got) / ctx["mb"] if got else None
