"""Seconds a called contig of fixed cost: each ``run`` span's time outside
its ``contig`` spans (index, insert statistics, tables, the VCF's open and
close, the translocation merge) plus every ``contig.setup`` (the wait for
the contig's sequence and its stages' set-up before the first ingest
chunk), over the contigs called. None where the program records no span
events."""

import spantree


def read(ctx):
    evs = ctx["events"] or []
    contigs = spantree.labelled(evs, "contig")
    if not contigs:
        return None
    runs = {(e.get("pid"), e["id"]): spantree.seconds(e)
            for e in spantree.labelled(evs, "run")}
    outside = sum(runs.values()) - sum(
        spantree.seconds(c) for c in contigs
        if (c.get("pid"), c["parent"]) in runs)
    setup = sum(spantree.seconds(e)
                for e in spantree.labelled(evs, "contig.setup"))
    return (outside + setup) / len(contigs)
