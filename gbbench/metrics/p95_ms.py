"""p95_ms: the 95th percentile of every call of the window, each timed
by the host clock and ended by a device synchronize."""

import statistics


def read(ctx):
    d = ctx["durations"]
    if len(d) == 1:
        return 1e3 * d[0]
    return 1e3 * statistics.quantiles(d, n=20, method="inclusive")[18]
