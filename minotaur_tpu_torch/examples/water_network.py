"""Example: pooling/blending network (water-network analogue).

Reference analogue: examples/water-network — a small nonconvex network
flow model.  This is the classic Haverly pooling problem: two sources
blend in a pool whose quality q couples to outgoing flows through
BILINEAR terms q*px, q*py; a third source bypasses the pool.  Global
optimum: profit 400 (objective -400 in min form).

    python -m minotaur_tpu_torch.examples.water_network
"""

import numpy as np

from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
from minotaur_tpu_torch.ir.functions import Function, LinearFunction, \
    QuadraticFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.utils.environment import Environment


def build():
    # vars: 0:a (src A->pool), 1:b (src B->pool), 2:px (pool->X),
    #       3:py (pool->Y), 4:zx (src C->X), 5:zy (src C->Y), 6:q (pool S%)
    p = Problem("haverly")
    for _ in range(4):
        p.new_variable(0.0, 300.0)      # a, b, px, py
    p.new_variable(0.0, 100.0)          # zx
    p.new_variable(0.0, 200.0)          # zy
    p.new_variable(1.0, 3.0)            # q in [1, 3] % sulfur

    # min 6a + 16b + 10(zx+zy) - 9(px+zx) - 15(py+zy)
    p.new_objective(Function(lf=LinearFunction(
        {0: 6.0, 1: 16.0, 2: -9.0, 3: -15.0, 4: 1.0, 5: -5.0})))

    # pool mass balance: a + b - px - py = 0
    p.new_constraint(Function(lf=LinearFunction(
        {0: 1.0, 1: 1.0, 2: -1.0, 3: -1.0})), 0.0, 0.0)
    # pool sulfur balance: 3a + b - q*(px+py) = 0
    qf = QuadraticFunction()
    qf.add_term(6, 2, -1.0)
    qf.add_term(6, 3, -1.0)
    p.new_constraint(Function(lf=LinearFunction({0: 3.0, 1: 1.0}), qf=qf),
                     0.0, 0.0)
    # demand X quality: q*px + 2 zx <= 2.5 (px + zx)
    qf = QuadraticFunction()
    qf.add_term(6, 2, 1.0)
    p.new_constraint(Function(lf=LinearFunction({2: -2.5, 4: -0.5}), qf=qf),
                     -np.inf, 0.0)
    # demand Y quality: q*py + 2 zy <= 1.5 (py + zy)
    qf = QuadraticFunction()
    qf.add_term(6, 3, 1.0)
    p.new_constraint(Function(lf=LinearFunction({3: -1.5, 5: 0.5}), qf=qf),
                     -np.inf, 0.0)
    # demand caps
    p.new_constraint(Function(lf=LinearFunction({2: 1.0, 4: 1.0})),
                     -np.inf, 100.0)
    p.new_constraint(Function(lf=LinearFunction({3: 1.0, 5: 1.0})),
                     -np.inf, 200.0)
    return p


def main(node_batch=16, node_limit=4000, log=True, device="cuda"):
    env = Environment()
    env.set_option("node_batch", node_batch)
    env.set_option("log_level", 1)
    env.set_option("bnb_node_limit", node_limit)
    bab = GlobBranchAndBound(build(), env, device=device)
    status = bab.solve()
    if log:
        print(f"{status.name}: profit={-bab.ub:.6g} (optimum 400)  "
              f"lb={bab.lb:.6g}  nodes={bab.nodes_processed}")
    return bab


if __name__ == "__main__":
    main()
