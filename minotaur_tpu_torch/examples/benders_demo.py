"""Example: Benders decomposition (benders analogue).

Reference analogue: examples/benders — a master/subproblem decomposition
solver built from framework parts.  Two-stage stochastic facility
location: the MILP master picks facilities y and per-scenario value
estimates theta_s; the scenario LPs price the recourse and return
optimality cuts theta_s >= lam'(b_s - T y) from their duals.

ONE batched IPM solver serves every scenario and every iteration — the
row bounds (b_s - T y) are arguments, so re-pricing a scenario is a data
change, not a rebuild (the reference re-loads an Osi LP each time).

    python -m minotaur_tpu_torch.examples.benders_demo
"""

import numpy as np

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.engines.ipm import build_batch_solver
from minotaur_tpu_torch.engines.staging import StagedProblem
from minotaur_tpu_torch.ir.functions import Function, LinearFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import VarType

# 2 facilities, 2 customers, 2 demand scenarios
F_COST = np.array([8.0, 6.0])               # facility open cost
CAP = np.array([6.0, 5.0])                  # capacity if open
C_SHIP = np.array([[1.0, 3.0],              # ship cost facility i -> cust j
                   [2.5, 1.2]])
PENALTY = 50.0                               # emergency supply (recourse)
DEMANDS = np.array([[4.0, 5.0], [7.0, 3.0]])  # scenario x customer
PROBS = np.array([0.5, 0.5])


def _build_sub():
    """Scenario LP: min sum c_ij x_ij + PENALTY * e_j
       s.t. sum_i x_ij + e_j >= d_j          (demand rows, clb varies)
            -sum_j x_ij      >= -CAP_i y_i   (capacity rows, clb varies)
    Variables: x (3*2), e (2)."""
    nf, nc = C_SHIP.shape
    n = nf * nc + nc
    m = nc + nf
    A = np.zeros((m, n))
    for j in range(nc):
        for i in range(nf):
            A[j, i * nc + j] = 1.0
        A[j, nf * nc + j] = 1.0
    for i in range(nf):
        for j in range(nc):
            A[nc + i, i * nc + j] = -1.0
    c = np.concatenate([C_SHIP.ravel(), np.full(nc, PENALTY)])
    return StagedProblem(
        name="benders-sub", n=n, m=m, c=c, obj_const=0.0, Qobj=None,
        obj_nl=None, A=A, clb=np.zeros(m), cub=np.full(m, np.inf),
        vlb=np.zeros(n), vub=np.full(n, np.inf),
        int_mask=np.zeros(n, bool), nl_rows=np.zeros(0, np.int32),
        con_nl=None, nl_graphs=[])


def _solve_master(cuts, log_level=1, device="cuda"):
    """MILP master: min f'y + sum_s p_s theta_s  s.t. optimality cuts."""
    nf, ns = len(F_COST), len(PROBS)
    p = Problem("benders-master")
    for _ in range(nf):
        p.new_variable(0.0, 1.0, vtype=VarType.BINARY)
    for _ in range(ns):
        p.new_variable(0.0, 1e4)       # theta_s
    obj = {i: float(F_COST[i]) for i in range(nf)}
    for s in range(ns):
        obj[nf + s] = float(PROBS[s])
    p.new_objective(Function(lf=LinearFunction(obj)))
    for s, coef_y, rhs in cuts:      # theta_s >= rhs + coef_y . y
        lf = {nf + s: 1.0}
        for i in range(nf):
            if abs(coef_y[i]) > 1e-12:
                lf[i] = -float(coef_y[i])
        p.new_constraint(Function(lf=LinearFunction(lf)), float(rhs),
                         np.inf)
    env = Environment()
    env.set_option("node_batch", 4)
    env.set_option("log_level", log_level)
    env.set_option("bnb_node_limit", 500)
    bab = BranchAndBound(p, env, device=device)
    bab.solve()
    x = bab.best_x
    return x[:nf], x[nf:], bab.ub


def main(max_iters=15, log=True, device="cuda"):
    sub = _build_sub()
    solve_sub = build_batch_solver(sub, device=device)
    nf, nc = C_SHIP.shape
    ns = len(PROBS)
    cuts = []
    y = np.ones(nf)
    ub_best = np.inf
    for it in range(max_iters):
        yb, theta, master_obj = _solve_master(cuts, device=device)
        y = np.round(yb)
        # price every scenario against this y (one shared solver; only
        # clb changes between calls)
        vals = np.zeros(ns)
        for s in range(ns):
            clb = np.concatenate([DEMANDS[s], -CAP * y])
            res = solve_sub(sub.A, clb, sub.cub, sub.vlb[None, :],
                            sub.vub[None, :])
            lam = np.maximum(0.0, -np.asarray(res.y[0]))   # >=-row duals
            vals[s] = float(res.obj[0])
            # optimality cut: theta_s >= lam_d'd_s - sum_i lam_c_i CAP_i y_i
            rhs = float(lam[:nc] @ DEMANDS[s])
            coef_y = -(lam[nc:] * CAP)
            cuts.append((s, coef_y, rhs))
        total = float(F_COST @ y + PROBS @ vals)
        ub_best = min(ub_best, total)
        gap = ub_best - master_obj
        if log:
            print(f"iter {it}: y={y.astype(int)}  master {master_obj:.6g}"
                  f"  true {total:.6g}  gap {gap:.3g}")
        if gap <= 1e-6 * (1.0 + abs(ub_best)):
            break
    if log:
        print(f"Benders converged: cost {ub_best:.8g}, open "
              f"{np.where(y > 0.5)[0].tolist()}")
    return y, ub_best


if __name__ == "__main__":
    main()
