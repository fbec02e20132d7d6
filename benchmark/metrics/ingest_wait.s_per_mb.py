"""Seconds a called megabase in which the main thread waited for the ingest
producer's next chunk (span ``ingest.wait``): the part of ingest on the
critical path. None where the program records no span events."""

import spantree


def read(ctx):
    evs = ctx["events"] or []
    if not spantree.labelled(evs, "contig"):
        return None
    return sum(spantree.seconds(e) for e in spantree.labelled(
        evs, "ingest.wait")) / ctx["mb"]
