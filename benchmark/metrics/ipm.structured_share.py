"""The share of the IPM's batched iterations run on a per-lane operator of
fixed-pattern rows (`structured` over `iters` of the program's `ipm.solve`
spans), in the profiled slice.  A program whose `ipm.solve` spans carry no
`structured` count reads nothing."""


def read(ctx):
    try:
        from minotaur_tpu_torch.utils import trace
    except ImportError:
        return None
    if not ctx["trace"]:
        return None
    solves = [r.counts for r in trace.spans()
              if r.name == "ipm.solve" and r.t1]
    if not any("structured" in c for c in solves):
        return None
    iters = sum(c.get("iters", 0) for c in solves)
    if iters <= 0:
        return None
    return 100.0 * sum(c.get("structured", 0) for c in solves) / iters
