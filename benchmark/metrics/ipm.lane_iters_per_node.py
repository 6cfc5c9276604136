"""IPM iterations summed over lanes (`stats.ipm_iters`) per node
processed: the IPM's work a node."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("ipm_iters") or not c.get("nodes_processed"):
        return None
    return c["ipm_iters"] / c["nodes_processed"]
