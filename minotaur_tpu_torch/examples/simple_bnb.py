"""Example: hand-built convex MINLP solved by plain B&B.

Reference analogue: examples/simple-bnb/simple-bnb-cg.cpp (build a
Problem in code, wire handlers, run BranchAndBound).  Here the handler
wiring disappears: integrality, FBBT and bounding live inside one fused
superstep.

    python -m minotaur_tpu_torch.examples.simple_bnb
"""

import numpy as np

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.ir.functions import Function, LinearFunction, \
    QuadraticFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import VarType


def main(node_batch=8, log_level=3, device="cuda"):
    # min x0^2 + x1^2 - x0 - 2 x1,  x0 + x1 <= 3,  x1 integer in [0, 5]
    p = Problem("simple")
    p.new_variable(0.0, 5.0)
    p.new_variable(0.0, 5.0, vtype=VarType.INTEGER)
    p.new_constraint(Function(lf=LinearFunction({0: 1.0, 1: 1.0})),
                     -np.inf, 3.0)
    qf = QuadraticFunction()
    qf.add_term(0, 0, 1.0)
    qf.add_term(1, 1, 1.0)
    p.new_objective(Function(lf=LinearFunction({0: -1.0, 1: -2.0}), qf=qf))

    env = Environment()
    env.set_option("node_batch", node_batch)
    env.set_option("log_level", log_level)
    bab = BranchAndBound(p, env, device=device)
    status = bab.solve()
    print(f"{status.name}: ub={bab.ub:.8g} x*={bab.best_x} "
          f"nodes={bab.stats.nodes_processed}")
    return bab


if __name__ == "__main__":
    main()
