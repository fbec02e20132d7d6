"""Per cent of the traced window in which a card ran no kernel, copy or
memset (the union of the profiler's device intervals of every process on
it), averaged over the cell's cards."""

import devtrace


def read(ctx):
    if not ctx["intervals"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - devtrace.mean_busy_seconds(ctx["cards"])
                    / ctx["window_s"])
