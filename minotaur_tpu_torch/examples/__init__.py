"""Example gallery of the port: one script per example of the repo's
`examples/` (the JAX package's gallery), same file names, same `main`
arguments plus a `device` keyword (default "cuda"; `nl_roundtrip` and
`polynomial_demo` run nothing on a device and take none).  Run one from
the repo root with

    python -m minotaur_tpu_torch.examples.simple_bnb

The six that read a .nl file take its path as their first argument.
"""
