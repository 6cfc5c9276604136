"""Shared helpers of the benchmark's tests (CPU, small sizes)."""

import argparse
import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# small sizes of each configuration for a CPU run
SMALL = {
    "intquad300-f64": dict(sizes={"n": 30, "u": 4}, node_batch=16),
    "qkp-ghs-100-25": dict(sizes={"n": 14, "density": 0.25, "p_max": 100,
                                  "w_max": 50, "c_min": 50}, node_batch=8),
}


@pytest.fixture(autouse=True)
def _one_thread():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_run(cell, seed=2 ** 31 + 17, seconds=3.0, trace=0, solver=None,
              control=False, trace_slice_s=1.0):
    """One run of `cell` on the CPU at its small size; the line."""
    import torch
    from benchmark.harness import registry, runner
    cfg = registry.config(registry.workload(cell)["config"])
    small = SMALL[cfg["name"]]
    over = dict(sizes=small["sizes"],
                solver={**cfg["solver"], "node_batch": small["node_batch"],
                        **(solver or {})},
                traffic=dict(trace_slice_s=trace_slice_s))
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=trace)
    return runner.execute(args, time.monotonic(), torch.device("cpu"), 1,
                          registry.benchmark(), overrides=over,
                          control=control)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the benchmark measures the card)")
