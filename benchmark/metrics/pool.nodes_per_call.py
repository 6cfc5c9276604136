"""Nodes processed by the device pool a multiround call."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("pool_calls"):
        return None
    return c["pool_processed"] / c["pool_calls"]
