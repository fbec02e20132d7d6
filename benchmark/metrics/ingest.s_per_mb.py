"""Seconds a called megabase of the port's ingest span ``ingest.read_bam``
(BAI fetch, BGZF inflate and BAM decode; on the producer thread, so it
overlaps compute)."""

LABELS = ("ingest.read_bam",)


def read(ctx):
    got = [ctx["spans"][k] for k in LABELS if k in ctx["spans"]]
    return sum(got) / ctx["mb"] if got else None
