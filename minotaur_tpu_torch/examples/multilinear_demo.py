"""Example: trilinear term with the exact lambda-hull formulation.

Reference analogue: examples/multilinear (grouping-based multilinear
convex hulls via MultilinearTermsHandler).  Here the hull is a
formulation: 8 lambda columns per trilinear monomial whose link rows
are rebuilt from each node's box inside the superstep.

    python -m minotaur_tpu_torch.examples.multilinear_demo
"""

import numpy as np

from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
from minotaur_tpu_torch.ir.expr import ExprGraph
from minotaur_tpu_torch.ir.functions import Function, LinearFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.ops.opcodes import Op
from minotaur_tpu_torch.utils.environment import Environment


def main(node_batch=8, log_level=3, device="cuda"):
    # min -x0*x1*x2 + 0.2*x0,  x0 in [-1,2], x1 in [0,2], x2 in [-1,1],
    # x0 + x1 + x2 <= 1.5 — mixed-sign box where the lambda hull is
    # strictly tighter than recursive McCormick
    p = Problem("tri-demo")
    for lo, hi in ((-1.0, 2.0), (0.0, 2.0), (-1.0, 1.0)):
        p.new_variable(lo, hi)
    p.new_constraint(
        Function(lf=LinearFunction({0: 1.0, 1: 1.0, 2: 1.0})),
        -np.inf, 1.5)
    g = ExprGraph()
    t = g.node(Op.MULT, g.node(Op.MULT, g.var(0), g.var(1)), g.var(2))
    g.set_root(g.node(Op.UMINUS, t))
    p.new_objective(Function(lf=LinearFunction({0: 0.2}), nlf=g))

    for hull in (0, 8):
        env = Environment()
        env.set_option("node_batch", node_batch)
        env.set_option("log_level", log_level)
        env.set_option("multilinear_hull", hull)
        env.set_option("bnb_node_limit", 500)
        bab = GlobBranchAndBound(p, env, device=device)
        status = bab.solve()
        print(f"multilinear_hull={hull}: {status.name} ub={bab.ub:.6g} "
              f"lb={bab.lb:.6g} nodes={bab.nodes_processed}")
    return bab


if __name__ == "__main__":
    main()
