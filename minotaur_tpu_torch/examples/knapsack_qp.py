"""Example: build a small nonconvex quadratic knapsack in code and solve
it globally (reference analogue: examples/ demo apps).

    python -m minotaur_tpu_torch.examples.knapsack_qp
"""

import numpy as np

from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
from minotaur_tpu_torch.ir.functions import Function, LinearFunction, \
    QuadraticFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import VarType


def build():
    """The model of `main` and its weights and capacity."""
    rng = np.random.default_rng(7)
    n = 8
    w = rng.integers(2, 10, size=n).astype(float)
    cap = float(w.sum() * 0.5)

    p = Problem("qknap")
    for j in range(n):
        p.new_variable(0, 1, VarType.BINARY, f"x{j}")
    p.new_constraint(
        Function(lf=LinearFunction({j: w[j] for j in range(n)})),
        -np.inf, cap, "capacity")

    # maximize pairwise synergies + values  ->  minimize the negation
    qf = QuadraticFunction()
    lf = LinearFunction()
    for j in range(n):
        lf.add_term(j, -float(rng.uniform(1, 5)))
        for k in range(j + 1, n):
            if rng.uniform() < 0.4:
                qf.add_term(j, k, -float(rng.uniform(0.5, 2.0)))
    p.new_objective(Function(lf=lf, qf=qf))
    return p, w, cap


def main(device="cuda"):
    p, w, cap = build()
    n = len(w)
    env = Environment()
    env.set_option("node_batch", 16)
    bab = GlobBranchAndBound(p, env, device=device)
    status = bab.solve()
    print(f"status: {status.name}")
    print(f"optimal value: {bab.ub:.6f}")
    print(f"chosen items: {np.where(bab.best_x[:n] > 0.5)[0].tolist()}")
    print(f"weight used: {w @ np.round(bab.best_x[:n])} / {cap}")
    return bab


if __name__ == "__main__":
    main()
