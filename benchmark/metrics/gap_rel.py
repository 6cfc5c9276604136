"""(ub - lb) / max(1, |ub|) of the window's last search when it closed;
nothing before an incumbent exists."""

import math


def read(ctx):
    lb, ub = ctx["final"]["lb"], ctx["final"]["ub"]
    if not (math.isfinite(lb) and math.isfinite(ub)):
        return None
    return (ub - lb) / max(1.0, abs(ub))
