"""The share of K2's refining calls that ran a cluster design (`cluster`
over `refining` of the program's `k2` spans), in the profiled slice.  The
launcher reports the design it took; a program whose `k2` spans carry no
`refining` count, or a slice with no refining call, reads nothing."""


def read(ctx):
    try:
        from minotaur_tpu_torch.utils import trace
    except ImportError:
        return None
    if not ctx["trace"]:
        return None
    solves = [r.counts for r in trace.spans() if r.name == "k2" and r.t1]
    if not any("refining" in c for c in solves):
        return None
    refining = sum(c.get("refining", 0) for c in solves)
    if refining <= 0:
        return None
    return 100.0 * sum(c.get("cluster", 0) for c in solves) / refining
