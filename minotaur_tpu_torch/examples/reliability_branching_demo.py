"""Example: reliability branching with strong-branch probe lanes
(reference ReliabilityBrancher.cpp:161-236).

The `rel` brancher scores candidates by pseudocosts; candidates whose
costs are unreliable (observed fewer than `rel_thresh` times) get
strong-branch BOUND PROBES.  Where the reference probes synchronously
per node, here probes are queued and ride RESERVED lanes of the next
batched superstep — branching quality improves without dedicated
engine calls.

    python -m minotaur_tpu_torch.examples.reliability_branching_demo
"""

import numpy as np

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.ir.functions import Function, LinearFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import VarType


def main(log=True, device="cuda"):
    # multidimensional knapsack: LP vertices carry several fractional
    # binaries, so the probe queue has real candidates
    rng = np.random.default_rng(5)
    n, m = 12, 3
    v = rng.integers(8, 30, size=n).astype(float)
    W = rng.integers(5, 20, size=(m, n)).astype(float)
    caps = W.sum(axis=1) * 0.4
    p = Problem("rel_demo")
    for _ in range(n):
        p.new_variable(0, 1, VarType.BINARY)
    for r in range(m):
        p.new_constraint(Function(lf=LinearFunction(
            {i: W[r, i] for i in range(n)})), -np.inf, float(caps[r]))
    p.new_objective(Function(lf=LinearFunction(
        {i: -v[i] for i in range(n)})))

    env = Environment()
    env.set_option("brancher", "rel")
    env.set_option("rel_thresh", 4)
    env.set_option("node_batch", 4)
    env.set_option("pad_full", 1)
    env.set_option("bnb_node_limit", 400)
    env.set_option("bnb_time_limit", 120)
    env.set_option("log_level", 1)
    bab = BranchAndBound(p, env, device=device)
    st = bab.solve()
    pc = int(bab._pc_down_cnt.sum() + bab._pc_up_cnt.sum())
    if log:
        print(f"status {st.name}  ub {bab.ub:.6g}  nodes "
              f"{bab.stats.nodes_processed}  probes {bab.stats.probes}  "
              f"pseudocost observations {pc}")
    return st, bab.ub, bab.stats.probes


if __name__ == "__main__":
    main()
