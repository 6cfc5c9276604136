"""The host loop's bookkeeping (`stats.t_host`) as a share of the window,
over the part of the window before the profiled slice."""


def read(ctx):
    snap = ctx["snapshot"]
    c, t = (snap["counters"], snap["elapsed"]) if snap else \
        (ctx["counters"], ctx["window_s"])
    if "t_host" not in c or t <= 0:
        return None
    return 100.0 * c["t_host"] / t
