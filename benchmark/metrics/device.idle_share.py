"""Per cent of the traced window in which the card ran no kernel, copy or
memset (the union of the profiler's device intervals)."""

import devtrace


def read(ctx):
    if not ctx["intervals"] or ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - devtrace.busy_seconds(ctx["intervals"])
                    / ctx["window_s"])
