"""Example: in-tree multistart B&B on a wavy nonconvex MINLP.

Reference analogue: examples built around MsProcessor / mmultistart
(multistart node processing).  Each tree node occupies several restart
lanes of the same batched superstep.

    python -m minotaur_tpu_torch.examples.multistart_demo
"""

import numpy as np

from minotaur_tpu_torch.bnb.multistart import MsBranchAndBound
from minotaur_tpu_torch.ir.expr import ExprGraph
from minotaur_tpu_torch.ir.functions import Function, LinearFunction, \
    QuadraticFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.ops.opcodes import Op
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import VarType


def main(log_level=3, device="cuda"):
    # min sin(3 x) + 0.1 x^2 + (y-1)^2, x in [-3,3], y in {0,1,2};
    # the adversarial warm start x=2 sits in a non-global basin
    p = Problem("wavy")
    p.new_variable(-3.0, 3.0)
    p.new_variable(0.0, 2.0, vtype=VarType.INTEGER)
    g = ExprGraph()
    g.set_root(g.node(Op.SIN, g.node(Op.MULT, g.num(3.0), g.var(0))))
    qf = QuadraticFunction()
    qf.add_term(0, 0, 0.1)
    qf.add_term(1, 1, 1.0)
    p.new_objective(Function(lf=LinearFunction({1: -2.0}), qf=qf, nlf=g),
                    const=1.0)
    p.initial_point = np.array([2.0, 1.0])

    for restarts in (1, 8):
        env = Environment()
        env.set_option("node_batch", 16)
        env.set_option("msbnb_restarts", restarts)
        env.set_option("bnb_node_limit", 40)
        env.set_option("log_level", log_level)
        bab = MsBranchAndBound(p, env, device=device)
        bab.solve()
        print(f"restarts={restarts}: incumbent {bab.ub:.6f} at "
              f"x={np.round(bab.best_x, 4) if bab.best_x is not None else None}")
    return bab


if __name__ == "__main__":
    main()
