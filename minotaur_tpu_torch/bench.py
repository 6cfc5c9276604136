"""Benchmark entry of the port: B&B nodes/s on one NVIDIA GPU.

Prints ONE JSON line on stdout:
  {"metric": "bnb_nodes_per_sec", "value": N, "unit": "nodes/s",
   "vs_baseline": N}

Headline metric: B&B nodes/sec at the settings of the repo's `bench.py`
(the JAX package's entry, which stays as it is): 64-node batches, one
warm-up superstep outside the timed window, at most 32768 nodes or
600 s.  The instance is intquad(300, 4, 0) (models/convex_suite2.py: 300
integers in [0, 4], a dense PSD Q, an exact oracle), the in-repo
stand-in for color_lab2_4x0.nl (300-binary MIQP with dense Q); a .nl
path argument runs that file instead.

Baseline: the reference publishes no numbers (BASELINE.md) and its
binaries need third-party solvers (Ipopt/ASL/Clp) that cannot be built in
this zero-egress image.  vs_baseline therefore uses a documented proxy:
single-core NLP-based B&B in the reference class processes ~100 nodes/sec
on instances of this size (one warm-started Ipopt/Clp solve per node at
~5-20 ms plus tree overhead).  See BASELINE.md measurement plan.

Diagnostics go to stderr: the card, the instance, status, nodes, time,
bounds against the oracle and the soundness verdict, which limit stopped
the run, t_device/t_host, KKT factorizations/s and direction solves/s,
and the launches of each CUDA kernel in the timed solve.  The process
exits non-zero (and prints no line) when the solve raises, the result is
unsound, a kernel of the path was never launched on the card, or the
card is asked for and absent.

    python -m minotaur_tpu_torch.bench [file.nl [--optimum VALUE]]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional, Sequence

import numpy as np

BASELINE_NODES_PER_SEC = 100.0
# 32768 nodes: steady-state throughput (warm dual-started children
# dominate; the root amortizes); TIME_LIMIT bounds the run's wall.
NODE_LIMIT = 32768
NODE_BATCH = 64
TIME_LIMIT = 600.0
INTQUAD = (300, 4, 0)
# bench.py's solver options (bench.py:77-103), in its order
OPTIONS = (("node_batch", NODE_BATCH), ("pad_full", 1),
           ("ipm_max_iters", 28), ("ipm_tail_kkt_rounds", 4),
           ("ipm_refine_steps", 0), ("ipm_chol_retry", 0),
           ("device_pool_cap", 16384), ("device_tree", 0),
           ("log_level", 1))
LINE_KEYS = ("metric", "value", "unit", "vs_baseline")
# soundness: lb <= opt <= ub within this relative tolerance
SOUND_RTOL = 1e-6


class BenchFailed(RuntimeError):
    """The run finished but its result may not be reported."""


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def card_name(device) -> str:
    """The card as nvidia-smi names it (name, power limit), or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def run(problem=None, *, optimum: Optional[float] = None,
        node_limit: int = NODE_LIMIT, time_limit: float = TIME_LIMIT,
        device="cuda", options: Sequence = ()) -> dict:
    """One bench run: warm-up superstep, then the timed `solve()`.

    `problem` defaults to intquad(300, 4, 0) with its exact optimum;
    `optimum`, where given (or known), decides soundness, otherwise only
    lb <= ub is held.  `options` are solver options set after the
    bench's.  Returns {"line": the one-line dict, ...diagnostics}; raises
    BenchFailed on an unsound result or a kernel never launched on the
    card."""
    from .bnb.bnb import BranchAndBound
    from .device import launch_counts, reset_launches, resolve_device
    from .models.convex_suite2 import intquad, intquad_optimum
    from .utils.environment import Environment
    from .utils.types import SolveStatus

    dev = resolve_device(device)
    t_start = time.monotonic()
    if problem is None:
        problem, optimum = intquad(*INTQUAD), intquad_optimum(*INTQUAD)
    card = card_name(dev)
    log(f"bench: card {card}; device {dev}")
    env = Environment()
    for k, v in OPTIONS + (("bnb_node_limit", node_limit),
                           ("bnb_time_limit", time_limit)) + tuple(options):
        env.set_option(k, v)
    bab = BranchAndBound(problem, env, device=dev)

    # one full 64-lane bucket (pad_full) through the step: on the card this
    # builds the kernels with nvcc, so the timed window is execution only
    sp = bab.sp
    t0 = time.monotonic()
    bab._step(sp.A, sp.clb, sp.cub,
              np.tile(sp.vlb, (NODE_BATCH, 1)),
              np.tile(sp.vub, (NODE_BATCH, 1)),
              np.zeros((NODE_BATCH, sp.n)),
              np.zeros((NODE_BATCH, sp.m)))
    log(f"bench: warmup bucket {NODE_BATCH} built+ran in "
        f"{time.monotonic() - t0:.1f}s")

    reset_launches()
    t0 = time.monotonic()
    status = bab.solve()
    dt = time.monotonic() - t0
    launches = launch_counts()
    nodes = max(1, bab.stats.nodes_processed)
    nps = nodes / dt
    stopped_by = {SolveStatus.SOLVED_NODE_LIMIT: "node limit",
                  SolveStatus.SOLVED_TIME_LIMIT: "time limit"}.get(
                      status, "neither (search ended)")
    log(f"bench: instance={problem.name} status={status.name} "
        f"nodes={nodes} time={dt:.1f}s ub={bab.ub:.10g} lb={bab.lb:.10g} "
        f"batches={bab.stats.batches} rebalances={bab.stats.rebalances} "
        f"total_wall={time.monotonic() - t_start:.1f}s; stopped by "
        f"{stopped_by} (node limit {node_limit}, time limit {time_limit} s)")
    # NOTE: dispatch/fetch windows OVERLAP host work under the pipelined
    # loop, so these are occupancy accumulators (can exceed 100% of
    # wall), not an additive profile
    log(f"bench: phase occupancy device={bab.stats.t_device:.1f}s "
        f"host={bab.stats.t_host:.1f}s of {dt:.1f}s wall (overlapped)")
    # every IPM iteration is one batched KKT factorization; each issues
    # 3 + affine_rounds + tail_kkt_rounds direction solves of it
    kkt_facts = bab.stats.ipm_iters
    dir_per_iter = 3 + 1 + int(env.options.get("ipm_tail_kkt_rounds"))
    log(f"bench: KKT factorizations/sec = {kkt_facts / dt:.1f} "
        f"({kkt_facts} total); KKT direction solves/sec = "
        f"{kkt_facts * dir_per_iter / dt:.1f}")
    log(f"bench: kernel launches in the timed solve: {launches}")

    tol = SOUND_RTOL * (1.0 + abs(optimum if optimum is not None
                                  else bab.ub))
    if optimum is None:
        sound = bab.lb <= bab.ub + tol
        log(f"bench: oracle none; lb <= ub {'holds' if sound else 'FAILS'}")
    else:
        sound = bab.lb <= optimum + tol and optimum <= bab.ub + tol
        log(f"bench: oracle {optimum:.10g}; lb <= opt <= ub "
            f"{'holds' if sound else 'FAILS'} (rtol {SOUND_RTOL})")
    if not sound:
        raise BenchFailed(f"unsound: lb {bab.lb} opt {optimum} ub {bab.ub}")
    if dev.type == "cuda":
        idle = sorted(k for k, v in launches.items() if v == 0)
        if idle:
            raise BenchFailed(f"kernels never launched on the card: {idle}")
    line = {"metric": "bnb_nodes_per_sec", "value": round(nps, 2),
            "unit": "nodes/s",
            "vs_baseline": round(nps / BASELINE_NODES_PER_SEC, 3)}
    return dict(line=line, status=status, ub=bab.ub, lb=bab.lb,
                optimum=optimum, nodes=nodes, seconds=dt,
                ipm_iters=kkt_facts, launches=launches,
                stopped_by=stopped_by, card=card)


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(
        prog="python -m minotaur_tpu_torch.bench",
        description="B&B nodes/s of the port at bench.py's settings")
    ap.add_argument("nl", nargs="?", help="a .nl instance (default: "
                    "intquad(300, 4, 0) with its exact optimum)")
    ap.add_argument("--optimum", type=float, default=None,
                    help="the instance's known optimum (soundness check)")
    args = ap.parse_args(argv)
    problem = None
    if args.nl is not None:
        if not os.path.isfile(args.nl):
            ap.error(f"no such file: {args.nl}")
        from .io.nl_reader import read_nl
        problem = read_nl(args.nl)
    elif args.optimum is not None:
        ap.error("--optimum needs a .nl path")
    try:
        res = run(problem, optimum=args.optimum, device=device)
    except BenchFailed as e:
        log(f"bench: FAILED: {e}")
        return 1
    print(json.dumps(res["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
