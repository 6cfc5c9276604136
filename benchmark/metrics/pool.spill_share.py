"""Nodes the device pool spilled to the host tree on congestion (`spilled`
of `pool.spill`) over the nodes it processed (`processed` of
`pool.summary`), in the profiled slice."""


def read(ctx):
    try:
        from minotaur_tpu_torch.utils import trace
    except ImportError:
        return None
    if not ctx["trace"]:
        return None
    recs = [r for r in trace.spans() if r.t1]
    done = sum(r.counts.get("processed", 0) for r in recs
               if r.name == "pool.summary")
    if done <= 0:
        return None
    spilled = sum(r.counts.get("spilled", 0) for r in recs
                  if r.name == "pool.spill")
    return 100.0 * spilled / done
