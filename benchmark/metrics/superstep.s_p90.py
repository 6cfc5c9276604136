"""90th percentile of the host-clock span around each superstep call,
outside the profiled slice."""

import statistics


def read(ctx):
    d = [t1 - t0 for name, t0, t1, traced in ctx["spans"]
         if name == "superstep" and not traced]
    if len(d) < 2:
        return None
    return statistics.quantiles(d, n=10)[8]
