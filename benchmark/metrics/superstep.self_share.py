"""The superstep's self time outside the IPM (`step`, `step.fbbt`,
`step.rows`, `step.fetch`: each span's duration less its child spans) as
a share of the profiled slice, from the program's spans
(`minotaur_tpu_torch.utils.trace`); nothing where the program records
none."""

NAMES = ("step", "step.fbbt", "step.rows", "step.fetch")


def read(ctx):
    try:
        from minotaur_tpu_torch.utils import trace
    except ImportError:
        return None
    tr = ctx["trace"]
    recs = [r for r in trace.spans() if r.t1]
    if not tr or tr["window_s"] <= 0 or not recs:
        return None
    self_s = sum(s for r, s in zip(recs, trace.self_ns(recs))
                 if r.name in NAMES) / 1e9
    return 100.0 * self_s / tr["window_s"]
