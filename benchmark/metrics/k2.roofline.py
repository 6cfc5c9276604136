"""K2's share of its roofline over the profiled slice: the frozen bound of
each call through the seam `engines.ipm.spd_solve` (its shape, element
sizes, refinement steps and right-hand sides), summed, over the device
time of K2's kernels (`spd_solve_*`) in the profiler's trace."""

from benchmark.harness.roofline import k2_bound_rhs


def read(ctx):
    tr, calls = ctx["trace"], ctx["calls"]
    if not tr or not calls:
        return None
    t = sum(s for name, s in tr["kernel_s"].items() if "spd_solve_" in name)
    bound_ms = sum(k2_bound_rhs(c["B"], c["k"], c["sf"], c["sm"], c["steps"],
                                c["R"])[0]
                   for kind, c in calls if kind == "k2")
    if t <= 0 or bound_ms <= 0:
        return None
    return 100.0 * bound_ms / (1e3 * t)
