"""Example: multi-tree outer approximation (OA).

Reference analogue: examples/outer-approx and the moa solver (OA.cpp):
alternate a master MILP over the cut pool with fixed-integer NLP
subproblems.

    python -m minotaur_tpu_torch.examples.outer_approx
"""

import numpy as np

from minotaur_tpu_torch.bnb.oa import OABranchAndBound
from minotaur_tpu_torch.ir.functions import Function, LinearFunction, \
    QuadraticFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import VarType


def main(node_batch=8, log_level=3, device="cuda"):
    # convex MIQP: min (x0-1.3)^2 + (x1-2.6)^2, x integer in [0,4]^2,
    #              x0 + x1 >= 2
    p = Problem("oa-demo")
    p.new_variable(0.0, 4.0, vtype=VarType.INTEGER)
    p.new_variable(0.0, 4.0, vtype=VarType.INTEGER)
    p.new_constraint(Function(lf=LinearFunction({0: 1.0, 1: 1.0})),
                     2.0, np.inf)
    qf = QuadraticFunction()
    qf.add_term(0, 0, 1.0)
    qf.add_term(1, 1, 1.0)
    p.new_objective(Function(
        lf=LinearFunction({0: -2.6, 1: -5.2}), qf=qf), const=1.69 + 6.76)

    env = Environment()
    env.set_option("node_batch", node_batch)
    env.set_option("log_level", log_level)
    bab = OABranchAndBound(p, env, device=device)
    status = bab.solve()
    print(f"{status.name}: ub={bab.ub:.8g} x*={bab.best_x}")
    return bab


if __name__ == "__main__":
    main()
