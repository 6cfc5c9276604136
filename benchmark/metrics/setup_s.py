"""From the process's start to the window: imports, instance, staging,
the warm-up superstep (and, in a checkout's first run, the kernels'
build)."""


def read(ctx):
    return ctx["setup_s"]
