"""MiB a run by which the process's anonymous resident memory grows from
one pass to the next: the least-squares slope of the ``run`` spans'
``anon_bytes`` (read as each ``cli.main`` ends) over the window's passes,
in order. None under three passes, or where the program records no span
events."""

import spantree


def read(ctx):
    runs = sorted((e for e in ctx["events"] or [] if e["label"] == "run"
                   and e["attrs"].get("anon_bytes") is not None),
                  key=lambda e: e["start_ns"])
    if len(runs) < 3:
        return None
    return spantree.least_squares_slope(
        [e["attrs"]["anon_bytes"] / float(1 << 20) for e in runs])
