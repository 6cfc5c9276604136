"""Median duration of the program's `ipm.iter` span, one batched IPM
iteration with its host read, in the profiled slice."""

import statistics


def read(ctx):
    try:
        from minotaur_tpu_torch.utils import trace
    except ImportError:
        return None
    if not ctx["trace"]:
        return None
    d = [r.t1 - r.t0 for r in trace.spans() if r.name == "ipm.iter" and r.t1]
    if not d:
        return None
    return statistics.median(d) / 1e6
