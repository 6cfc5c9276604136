"""The IPM's blocking host reads (`ipm.sync` spans) per batched iteration
(the `iters` counts of `ipm.solve`), in the profiled slice."""


def read(ctx):
    try:
        from minotaur_tpu_torch.utils import trace
    except ImportError:
        return None
    if not ctx["trace"]:
        return None
    recs = [r for r in trace.spans() if r.t1]
    iters = sum(r.counts.get("iters", 0) for r in recs
                if r.name == "ipm.solve")
    if iters <= 0:
        return None
    return sum(r.name == "ipm.sync" for r in recs) / iters
