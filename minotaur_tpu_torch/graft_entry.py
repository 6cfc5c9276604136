"""Entry points of the port: one batched superstep, and the
multi-device dry run.

Port of the repo root's `__graft_entry__.py`, which stays the JAX
package's.  The superstep (FBBT -> batched IPM -> integrality analysis,
`bnb/step.py`) on a MINLP is this solver's "flagship model"; the
partitioned pool with the min-fused incumbent (`parallel/pool.py`) is
its multi-device step.

The JAX entry reads nvs08.nl, which this repository does not hold.  The
stand-in is the suite row stockcycle_24a (`models/convex_suite2.py::
stockcycle(24, 8, 0)`: 24 integers k_i in [1, 8], a nonlinear objective
sum a_i / k_i + b_i k_i, one capacity row, an exact oracle).  Like
nvs08's, its variable 2 is an integer whose upper bound is at least 7,
so the eight lanes' boxes `vlb[k, 2] = k` are distinct branch boxes.

    python -m minotaur_tpu_torch.graft_entry [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
from typing import Callable, List, Tuple

import numpy as np

STAND_IN = (24, 8, 0)      # stockcycle(n, K, seed)
BRANCH_VAR = 2


class DryRunFailed(AssertionError):
    """A check of the dry run failed."""


def _check(cond, what):
    if not cond:
        raise DryRunFailed(what)


def _setup():
    from .engines.staging import stage_problem
    from .models.convex_suite2 import stockcycle
    return stage_problem(stockcycle(*STAND_IN))


def branch_boxes(sp, B: int):
    """(vlb_b, vub_b): B copies of the root box with vlb[k, 2] = k % 8."""
    vlb_b = np.tile(sp.vlb, (B, 1))
    vub_b = np.tile(sp.vub, (B, 1))
    for k in range(B):
        vlb_b[k, BRANCH_VAR] = float(k % 8)
    return vlb_b, vub_b


def entry(device="cuda") -> Tuple[Callable, tuple]:
    """-> (fn, args): one lane-batched node superstep on eight lanes.

    `fn(A, clb, cub, vlb_b, vub_b, x0_b)` is `bnb/step.py`'s
    `build_node_step_unjitted` (the counterpart of the JAX package's
    single-lane step vmapped over lanes) and returns a `StepResult` of
    tensors; `args` are on `device`."""
    from .bnb.step import StepOptions, StepResult, build_node_step_unjitted
    from .device import resolve_device
    from .engines.ipm import to_device

    dev = resolve_device(device)
    sp = _setup()
    step_b = build_node_step_unjitted(sp, StepOptions(), dev)

    def fn(A, clb, cub, vlb_b, vub_b, x0_b):
        return StepResult(**step_b(A, clb, cub, vlb_b, vub_b, x0_b))

    vlb_b, vub_b = branch_boxes(sp, 8)
    args = tuple(to_device(a, dev) for a in (
        sp.A.reshape(sp.m, sp.n), sp.clb, sp.cub, vlb_b, vub_b,
        np.zeros((8, sp.n))))
    return fn, args


def partition_devices(n_parts: int, device="cuda") -> List[str]:
    """Partition i on cuda:{i % card count}, or every partition on the
    CPU."""
    import torch
    from .device import resolve_device
    if resolve_device(device).type == "cpu":
        return ["cpu"] * n_parts
    cards = torch.cuda.device_count()
    return [f"cuda:{i % cards}" for i in range(n_parts)]


def sharded_step_part(n_parts: int, device="cuda"):
    """Part 1: the sharded superstep over n_parts partitions at
    B = 2 n_parts lanes; every objective finite, every status OPTIMAL,
    and lane 0's objective at most that of the lane with the tightest
    branch box (lane 7, or the last lane where B < 8).  Returns
    (StepResult, fused bound)."""
    from .bnb.step import StepOptions
    from .parallel.pool import build_sharded_step

    sp = _setup()
    step = build_sharded_step(sp, StepOptions(),
                              partition_devices(n_parts, device))
    B = 2 * n_parts
    vlb_b, vub_b = branch_boxes(sp, B)
    res, gub = step(sp.A, sp.clb, sp.cub, vlb_b, vub_b,
                    np.zeros((B, sp.n)), np.zeros((B, sp.m)), np.inf)
    objs = np.asarray(res.obj)
    _check(np.all(np.isfinite(objs)), f"non-finite objectives {objs}")
    _check(np.all(res.status == 1), f"statuses {res.status}")
    top = min(7, B - 1)
    _check(objs[0] <= objs[top] + 1e-9,
           f"objs[0] {objs[0]} > objs[{top}] {objs[top]}")
    print(f"dryrun_multichip({n_parts}): plain sharded step OK on "
          f"{[str(d) for d in step.devices]}, "
          f"objs[:8]={np.round(objs[:8], 4)}", flush=True)
    return res, gub


def dist_qg_part(n_parts: int, path: str, dp_opt: float, device="cuda"):
    """Part 2: DistQGBranchAndBound on the knapsack at `path` over
    n_parts partitions (node_batch 4 n_parts, lb_frequency 3, bfs): the
    DP optimum, at least one rebalance and, from two partitions on,
    nodes migrated and two partitions that did work."""
    from .io.nl_reader import read_nl
    from .parallel.dist_bnb import DistQGBranchAndBound
    from .utils.environment import Environment
    from .utils.types import SolveStatus

    env = Environment()
    env.set_option("node_batch", 4 * n_parts)
    env.set_option("log_level", 1)
    env.set_option("lb_frequency", 3)
    env.set_option("tree_search", "bfs")   # the reference's mpi protocol
    bab = DistQGBranchAndBound(read_nl(path),
                               partition_devices(n_parts, device), env=env)
    status = bab.solve()
    parts = [pool.nodes_processed for pool in bab.pools]
    _check(status == SolveStatus.SOLVED_OPTIMAL, f"DistQG status {status}")
    _check(abs(bab.ub - dp_opt) < 1e-6 * max(1, abs(dp_opt)),
           f"DistQG ub {bab.ub} vs DP {dp_opt}")
    _check(bab.stats.rebalances >= 1, "DistQG: no rebalance ran")
    if n_parts >= 2:
        # one partition has nothing to migrate to
        _check(bab.stats.nodes_migrated > 0, "DistQG: no node migrated")
        _check(sum(1 for c in parts if c > 0) >= 2,
               f"DistQG: one partition did all the work {parts}")
    print(f"dryrun_multichip({n_parts}): DistQG OK, ub={bab.ub:.6f} "
          f"(DP-verified) nodes={bab.stats.nodes_processed} parts={parts} "
          f"rebalances={bab.stats.rebalances} "
          f"migrated={bab.stats.nodes_migrated}", flush=True)
    return bab


def multi_controller_part(n_parts: int, path: str, dp_opt: float,
                          device="cuda"):
    """Part 3: two controller processes (`spawn_local`, ranks on
    cuda:{r % card count}) coordinated by host TCP collectives: both at
    the DP optimum, both did work, nodes migrated in."""
    from .parallel.multihost import spawn_local
    results = spawn_local(path, 2, {"log_level": 0, "node_batch": 16,
                                    "lb_frequency": 3}, device=device)
    _check(all(r["status"] == "SOLVED_OPTIMAL" for r in results),
           f"ranks {results}")
    _check(all(abs(r["ub"] - dp_opt) < 1e-6 * max(1, abs(dp_opt))
               for r in results), f"rank ubs {[r['ub'] for r in results]}")
    _check(all(r["processed"] > 0 for r in results), f"ranks {results}")
    _check(sum(r["migrated_in"] for r in results) > 0,
           f"no node migrated: {results}")
    print(f"dryrun_multichip({n_parts}): multi-controller OK, 2 processes "
          f"on {[r['device'] for r in results]}, per-rank nodes="
          f"{[r['processed'] for r in results]} migrated_in="
          f"{[r['migrated_in'] for r in results]} "
          f"rounds={results[0]['rounds']}", flush=True)
    return results


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The three parts on n_devices partitions (partition i on
    cuda:{i % card count}, or on the CPU): the sharded superstep, the
    distributed QG solve on correlated_knapsack(30, 1) (written by the
    port's nl_writer) and the two-process run on the same file.  Each
    part raises on a failed check."""
    from .io.nl_writer import write_nl
    from .models.generators import correlated_knapsack, knapsack_dp_optimum

    sharded_step_part(n_devices, device)
    dp_opt = knapsack_dp_optimum(30, 1)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dryrun_cknap30.nl")
        write_nl(correlated_knapsack(30, 1), path)
        dist_qg_part(n_devices, path, dp_opt, device)
        multi_controller_part(n_devices, path, dp_opt, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m minotaur_tpu_torch.graft_entry",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import torch
    from .bench import card_name
    from .device import resolve_device
    dev = resolve_device(args.device)
    print(f"card: {card_name(dev)}", flush=True)
    fn, fargs = entry(dev)
    out = fn(*fargs)
    print("entry: OK, obj =", np.round(out.obj.cpu().numpy(), 4), flush=True)
    # every card; on the CPU the JAX script's eight virtual devices
    dryrun_multichip(torch.cuda.device_count() if dev.type == "cuda" else 8,
                     dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
