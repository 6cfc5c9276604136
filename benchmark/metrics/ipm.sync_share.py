"""Time in the program's `ipm.sync` spans (the IPM's blocking host reads)
over time in its `ipm.solve` spans, in the profiled slice: the share of
the IPM that the host spends blocked on the device."""


def read(ctx):
    try:
        from minotaur_tpu_torch.utils import trace
    except ImportError:
        return None
    if not ctx["trace"]:
        return None
    recs = [r for r in trace.spans() if r.t1]
    solve = sum(r.t1 - r.t0 for r in recs if r.name == "ipm.solve")
    if solve <= 0:
        return None
    sync = sum(r.t1 - r.t0 for r in recs if r.name == "ipm.sync")
    return 100.0 * sync / solve
