"""Seconds a called megabase of the device scan: ``scan.device`` (tile
inputs, launches, copies back), ``scan.accumulate`` (depth lists on the
card) and ``scan.rd_to_host`` (the lists copied back after the scan)."""

LABELS = ("scan.device", "scan.accumulate", "scan.rd_to_host")


def read(ctx):
    got = [ctx["spans"][k] for k in LABELS if k in ctx["spans"]]
    return sum(got) / ctx["mb"] if got else None
