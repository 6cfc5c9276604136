"""K1's share of its roofline over the profiled slice: the frozen bound of
each call through the seam `engines.ipm.spd_inverse` (its shape and
dtype), summed, over the device time of K1's kernels (`spd_inverse_*`) in
the profiler's trace."""

from benchmark.harness.roofline import k1_bound


def read(ctx):
    tr, calls = ctx["trace"], ctx["calls"]
    if not tr or not calls:
        return None
    t = sum(s for name, s in tr["kernel_s"].items()
            if "spd_inverse_" in name)
    bound_ms = sum(k1_bound(c["B"], c["k"], c["itemsize"])[0]
                   for kind, c in calls if kind == "k1")
    if t <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / (1e3 * t)
