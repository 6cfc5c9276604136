"""The share of a batch's lane-iterations that do work: the active lanes
summed over the IPM's batched iterations (`lane_iters` of `ipm.solve`)
over the sum of `iters` times `lanes`, in the profiled slice."""


def read(ctx):
    try:
        from minotaur_tpu_torch.utils import trace
    except ImportError:
        return None
    if not ctx["trace"]:
        return None
    solves = [r.counts for r in trace.spans()
              if r.name == "ipm.solve" and r.t1]
    slots = sum(c.get("iters", 0) * c["lanes"] for c in solves)
    if slots <= 0:
        return None
    return 100.0 * sum(c.get("lane_iters", 0) for c in solves) / slots
