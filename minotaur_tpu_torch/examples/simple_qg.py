"""Example: convex MINLP solved by Quesada-Grossmann branch-and-cut.

Reference analogue: examples/simple-qg + the mqg solver (QG.cpp): LP
tree with an NLP oracle adding gradient linearizations at integral
points.  Here the LP tree is a batched superstep and the NLP oracle
solves all integral lanes of a batch in one batched call.

    python -m minotaur_tpu_torch.examples.simple_qg
"""

import numpy as np

from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
from minotaur_tpu_torch.ir.expr import ExprGraph
from minotaur_tpu_torch.ir.functions import Function, LinearFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.ops.opcodes import Op
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import VarType


def main(node_batch=8, log_level=3, device="cuda"):
    # min x0 + x1  s.t.  exp(0.5 x0) - x1 <= 1,  x0 >= 0.3 (cont),
    #                    x1 integer in [0, 6]
    p = Problem("qg-demo")
    p.new_variable(0.3, 4.0)
    p.new_variable(0.0, 6.0, vtype=VarType.INTEGER)
    g = ExprGraph()
    e = g.node(Op.EXP, g.node(Op.MULT, g.num(0.5), g.var(0)))
    g.set_root(e)
    p.new_constraint(Function(lf=LinearFunction({1: -1.0}), nlf=g),
                     -np.inf, 1.0)
    p.new_objective(Function(lf=LinearFunction({0: 1.0, 1: 1.0})))

    env = Environment()
    env.set_option("node_batch", node_batch)
    env.set_option("log_level", log_level)
    bab = QGBranchAndBound(p, env, device=device)
    status = bab.solve()
    print(f"{status.name}: ub={bab.ub:.8g} x*={bab.best_x} "
          f"nodes={bab.stats.nodes_processed}")
    return bab


if __name__ == "__main__":
    main()
