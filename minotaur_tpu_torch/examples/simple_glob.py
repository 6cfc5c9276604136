"""Example: nonconvex bilinear program solved globally.

Reference analogue: examples/simple-glob and examples/bilinear
(bilinear-relax.cpp): McCormick relaxation + spatial branching.  Here
the envelopes are computed inside the batched superstep from each
node's box, and RLT bound-factor cuts tighten the root.

    python -m minotaur_tpu_torch.examples.simple_glob
"""

import numpy as np

from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
from minotaur_tpu_torch.ir.functions import Function, LinearFunction, \
    QuadraticFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.utils.environment import Environment


def main(node_batch=8, log_level=3, device="cuda"):
    # min -x0*x1 - x2  s.t. x0 + x1 + 2 x2 <= 4,  x in [0, 2]^3
    p = Problem("glob-demo")
    for _ in range(3):
        p.new_variable(0.0, 2.0)
    p.new_constraint(
        Function(lf=LinearFunction({0: 1.0, 1: 1.0, 2: 2.0})),
        -np.inf, 4.0)
    qf = QuadraticFunction()
    qf.add_term(0, 1, -1.0)
    p.new_objective(Function(lf=LinearFunction({2: -1.0}), qf=qf))

    env = Environment()
    env.set_option("node_batch", node_batch)
    env.set_option("log_level", log_level)
    env.set_option("bnb_node_limit", 2000)
    bab = GlobBranchAndBound(p, env, device=device)
    status = bab.solve()
    print(f"{status.name}: ub={bab.ub:.8g} lb={bab.lb:.8g} "
          f"x*={bab.best_x} nodes={bab.nodes_processed}")
    return bab


if __name__ == "__main__":
    main()
