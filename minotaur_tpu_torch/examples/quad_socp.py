"""Example: convex quadratically-constrained integer program.

Reference analogue: examples/quad-socp — a ball-constrained (SOCP-
representable) integer model.  Convex nonlinear rows are exactly QG's
domain, so the demo runs the QG branch-and-cut: the ball constraint is
outer-approximated by gradient cuts at NLP solutions.

    min -x0 - 2 x1   s.t.  x0^2 + x1^2 <= 4,  x integer in [0,2]^2
    optimum -4 at (0, 2).

    python -m minotaur_tpu_torch.examples.quad_socp
"""

import numpy as np

from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
from minotaur_tpu_torch.ir.functions import Function, LinearFunction, \
    QuadraticFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import VarType


def main(node_batch=4, log=True, device="cuda"):
    p = Problem("quad-socp")
    p.new_variable(0.0, 2.0, vtype=VarType.INTEGER)
    p.new_variable(0.0, 2.0, vtype=VarType.INTEGER)
    qf = QuadraticFunction()
    qf.add_term(0, 0, 1.0)
    qf.add_term(1, 1, 1.0)
    p.new_constraint(Function(qf=qf), -np.inf, 4.0)
    p.new_objective(Function(lf=LinearFunction({0: -1.0, 1: -2.0})))

    env = Environment()
    env.set_option("node_batch", node_batch)
    env.set_option("log_level", 1)
    env.set_option("bnb_node_limit", 500)
    bab = QGBranchAndBound(p, env, device=device)
    status = bab.solve()
    if log:
        print(f"{status.name}: obj {bab.ub:.8g}  x* {bab.best_x}")
    return bab


if __name__ == "__main__":
    main()
