"""1 - the union of device kernel intervals over the profiled slice."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
