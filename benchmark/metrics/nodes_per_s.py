"""Nodes whose relaxation was solved and processed, over the window."""


def read(ctx):
    return ctx["nodes"] / ctx["window_s"]
