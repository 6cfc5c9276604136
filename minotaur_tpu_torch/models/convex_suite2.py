"""Convex-suite families, round 5: the reference benchmark families the
round-4 sweep did not cover (VERDICT r4 missing #5 / next-step #3) —
clay*, slay, rsyn*, sssd, stockcycle, portfol/alan, st_e14 — plus
large-n rows (n >= 1000) that hit the dense-scaling wall on purpose.

Same discipline as models/convex_suite.py: every generator has an
INDEPENDENT exact oracle (vectorized enumeration, DP over an integer
budget, greedy exchange on a separable convex objective, Lagrangian
waterfilling, or scipy SLSQP over an enumerated combinatorial skeleton —
all algorithm families disjoint from the batched IPM under test).
Reference instance lists: the reference's scripts/convex_inst_list.csv,
minlp-test.py:36-60.
"""

from __future__ import annotations

import itertools
import math
from typing import Dict

import numpy as np

from ..ir.expr import ExprGraph
from ..ir.functions import Function, LinearFunction, QuadraticFunction
from ..ir.problem import Problem
from ..ops.opcodes import Op
from ..utils.types import VarType
from .convex_suite import SUITE

_INF = float("inf")


# ------------------- stockcycle-like (integer cycle sizing, capacity DP)

def _stockcycle_data(n, K, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(4.0, 20.0, size=n)          # setup amortization a/k
    b = rng.uniform(0.3, 1.5, size=n)           # holding cost b*k
    s = rng.integers(1, 5, size=n)              # capacity usage per cycle
    C = int(math.floor(0.55 * float(s.sum()) * K / 2))
    return a, b, s, C


def stockcycle(n: int = 24, K: int = 8, seed: int = 0) -> Problem:
    """min sum_i a_i/k_i + b_i k_i  s.t.  sum_i s_i k_i <= C,
    k_i integer in [1, K]  (family: stockcycle — cyclic inventory
    sizing; the a/k term is the classic setup-amortization convexity)."""
    a, b, s, C = _stockcycle_data(n, K, seed)
    p = Problem(f"stockcycle_{n}")
    for i in range(n):
        p.new_variable(1, K, VarType.INTEGER, f"k{i}")
    p.new_constraint(Function(lf=LinearFunction(
        {i: float(s[i]) for i in range(n)})), -_INF, float(C), "cap")
    g = ExprGraph()
    acc = None
    for i in range(n):
        t = g.node(Op.DIV, g.num(float(a[i])), g.var(i))
        acc = t if acc is None else g.node(Op.PLUS, acc, t)
    g.root = acc
    lf = LinearFunction({i: float(b[i]) for i in range(n)})
    p.new_objective(Function(lf=lf, nlf=g))
    return p


def stockcycle_optimum(n: int = 24, K: int = 8, seed: int = 0) -> float:
    """Exact DP over the integer capacity (knapsack with K choices per
    item; cost a/k + b*k)."""
    a, b, s, C = _stockcycle_data(n, K, seed)
    BIG = 1e18
    best = np.full(C + 1, BIG)
    best[0] = 0.0
    for i in range(n):
        nb = np.full(C + 1, BIG)
        for k in range(1, K + 1):
            w = int(s[i]) * k
            if w > C:
                break
            cost = a[i] / k + b[i] * k
            nb[w:] = np.minimum(nb[w:], best[:-w] + cost)
        best = nb
    # dp requires every item to pick some k (k>=1): feasible iff any
    return float(best.min())


# -------------- sssd-like (service system design: assignment + congestion)

def _sssd_data(nc, ns, seed):
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.5, 2.0, size=nc)        # customer demand rates
    rho = rng.uniform(0.4, 1.2, size=ns)        # server congestion coef
    cost = rng.uniform(0.0, 1.5, size=(nc, ns))  # assignment cost
    return lam, rho, cost


def sssd(nc: int = 7, ns: int = 3, seed: int = 0) -> Problem:
    """Assign each customer to one server; congestion is quadratic in
    the server load (family: sssd — the M/M/1 delay replaced by its
    quadratic convex analogue, keeping the assignment+congestion
    structure).  Pure-binary PSD MIQP -> certified dual bounds."""
    lam, rho, cost = _sssd_data(nc, ns, seed)
    p = Problem(f"sssd_{nc}x{ns}")
    xi = lambda c, s: c * ns + s
    for c in range(nc):
        for s in range(ns):
            p.new_variable(0, 1, VarType.BINARY, f"x{c}_{s}")
    for c in range(nc):
        p.new_constraint(Function(lf=LinearFunction(
            {xi(c, s): 1.0 for s in range(ns)})), 1.0, 1.0, f"asg{c}")
    qf = QuadraticFunction()
    # sum_s rho_s (sum_c lam_c x_cs)^2 — PSD by construction
    for s in range(ns):
        for c1 in range(nc):
            for c2 in range(nc):
                qf.add_term(xi(c1, s), xi(c2, s),
                            float(rho[s] * lam[c1] * lam[c2]))
    lf = LinearFunction({xi(c, s): float(cost[c, s])
                         for c in range(nc) for s in range(ns)})
    p.new_objective(Function(lf=lf, qf=qf))
    return p


def sssd_optimum(nc: int = 7, ns: int = 3, seed: int = 0) -> float:
    """Exact by vectorized enumeration of all ns^nc assignments."""
    lam, rho, cost = _sssd_data(nc, ns, seed)
    combos = np.array(list(itertools.product(range(ns), repeat=nc)))
    loads = np.zeros((len(combos), ns))
    csum = np.zeros(len(combos))
    for c in range(nc):
        a = combos[:, c]
        for s in range(ns):
            m = a == s
            loads[m, s] += lam[c]
            csum[m] += cost[c, s]
    val = csum + (rho[None, :] * loads ** 2).sum(axis=1)
    return float(val.min())


# -------- portfol/alan-like (cardinality-constrained mean-variance QP)

def _portcard_data(n, seed):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(n, max(2, n // 3)))
    Q = F @ F.T / n + np.diag(rng.uniform(0.05, 0.3, size=n))
    r = rng.uniform(0.02, 0.3, size=n)
    return Q, r


def portcard(n: int = 8, k: int = 3, seed: int = 0, u: float = 0.6
             ) -> Problem:
    """min x'Qx - r'x  s.t. sum x = 1, 0 <= x_i <= u z_i, sum z <= k,
    z binary (family: portfol / alan / meanvar with cardinality)."""
    Q, r = _portcard_data(n, seed)
    p = Problem(f"portcard_{n}_{k}")
    for i in range(n):
        p.new_variable(0.0, u, VarType.CONTINUOUS, f"x{i}")
    for i in range(n):
        p.new_variable(0, 1, VarType.BINARY, f"z{i}")
    p.new_constraint(Function(lf=LinearFunction(
        {i: 1.0 for i in range(n)})), 1.0, 1.0, "budget")
    for i in range(n):
        p.new_constraint(Function(lf=LinearFunction(
            {i: 1.0, n + i: -u})), -_INF, 0.0, f"link{i}")
    p.new_constraint(Function(lf=LinearFunction(
        {n + i: 1.0 for i in range(n)})), -_INF, float(k), "card")
    qf = QuadraticFunction()
    for i in range(n):
        for j in range(n):
            if abs(Q[i, j]) > 1e-14:
                qf.add_term(i, j, float(Q[i, j]))
    lf = LinearFunction({i: float(-r[i]) for i in range(n)})
    p.new_objective(Function(lf=lf, qf=qf))
    return p


def portcard_optimum(n: int = 8, k: int = 3, seed: int = 0,
                     u: float = 0.6) -> float:
    """Exact by support enumeration + SLSQP on each support QP (an
    independent dense-active-set method; 1e-10 tolerances)."""
    from scipy.optimize import minimize
    Q, r = _portcard_data(n, seed)
    best = _INF
    idx = list(range(n))
    for sz in range(1, k + 1):
        if sz * u < 1.0 - 1e-12:
            continue                      # cannot reach the budget
        for S in itertools.combinations(idx, sz):
            S = list(S)
            QS = Q[np.ix_(S, S)]
            rS = r[S]
            x0 = np.full(len(S), 1.0 / len(S))
            res = minimize(
                lambda x: x @ QS @ x - rS @ x,
                x0, jac=lambda x: (QS + QS.T) @ x - rS,
                method="SLSQP",
                bounds=[(0.0, u)] * len(S),
                constraints=[{"type": "eq",
                              "fun": lambda x: x.sum() - 1.0,
                              "jac": lambda x: np.ones(len(S))}],
                options={"maxiter": 300, "ftol": 1e-12})
            if res.success:
                best = min(best, float(res.fun))
    return best


# ------------------ clay/slay-like (2-D layout with big-M disjunctions)

def _clay2_data(kk, seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(1.5, 8.5, size=(kk, 2))
    d = 2.5                                    # min separation
    L = 10.0
    return t, d, L


def clay2(kk: int = 3, seed: int = 0) -> Problem:
    """Place kk points in [0,L]^2 minimizing sum ||p_i - t_i||^2 with
    pairwise axis separation |x_i-x_j|>=d OR |y_i-y_j|>=d, expressed as
    4 big-M disjunction binaries per pair (family: clay0203m / slay —
    the reference's constrained-layout encoding, CLay uses exactly this
    big-M form)."""
    t, d, L = _clay2_data(kk, seed)
    p = Problem(f"clay2_{kk}")
    for i in range(kk):
        p.new_variable(0.0, L, VarType.CONTINUOUS, f"px{i}")
        p.new_variable(0.0, L, VarType.CONTINUOUS, f"py{i}")
    pairs = list(itertools.combinations(range(kk), 2))
    zbase = 2 * kk
    for q, (i, j) in enumerate(pairs):
        for w in range(4):
            p.new_variable(0, 1, VarType.BINARY, f"z{q}_{w}")
    M = L + d
    for q, (i, j) in enumerate(pairs):
        z = [zbase + 4 * q + w for w in range(4)]
        p.new_constraint(Function(lf=LinearFunction(
            {zz: 1.0 for zz in z})), 1.0, _INF, f"disj{q}")
        # z0: x_i + d <= x_j   ->  x_i - x_j + M z0 <= M - d
        p.new_constraint(Function(lf=LinearFunction(
            {2 * i: 1.0, 2 * j: -1.0, z[0]: M})), -_INF, M - d)
        p.new_constraint(Function(lf=LinearFunction(
            {2 * j: 1.0, 2 * i: -1.0, z[1]: M})), -_INF, M - d)
        p.new_constraint(Function(lf=LinearFunction(
            {2 * i + 1: 1.0, 2 * j + 1: -1.0, z[2]: M})), -_INF, M - d)
        p.new_constraint(Function(lf=LinearFunction(
            {2 * j + 1: 1.0, 2 * i + 1: -1.0, z[3]: M})), -_INF, M - d)
    qf = QuadraticFunction()
    lf = LinearFunction()
    const = 0.0
    for i in range(kk):
        for ax in range(2):
            v = 2 * i + ax
            qf.add_term(v, v, 1.0)
            lf.add_term(v, -2.0 * float(t[i, ax]))
            const += float(t[i, ax]) ** 2
    p.new_objective(Function(lf=lf, qf=qf), const=const)
    return p


def clay2_optimum(kk: int = 3, seed: int = 0) -> float:
    """Exact by enumerating the active disjunct per pair (the union of
    the 4^P single-disjunct polyhedra IS the feasible set) and solving
    each convex QP with SLSQP."""
    from scipy.optimize import minimize
    t, d, L = _clay2_data(kk, seed)
    pairs = list(itertools.combinations(range(kk), 2))
    best = _INF
    for combo in itertools.product(range(4), repeat=len(pairs)):
        cons = []
        for q, (i, j) in enumerate(pairs):
            w = combo[q]
            if w == 0:
                a, bvar = 2 * i, 2 * j
            elif w == 1:
                a, bvar = 2 * j, 2 * i
            elif w == 2:
                a, bvar = 2 * i + 1, 2 * j + 1
            else:
                a, bvar = 2 * j + 1, 2 * i + 1
            cons.append({"type": "ineq",
                         "fun": (lambda x, a=a, b=bvar:
                                 x[b] - x[a] - d)})
        x0 = t.reshape(-1).copy()
        res = minimize(
            lambda x: float(((x.reshape(-1, 2) - t) ** 2).sum()),
            x0, method="SLSQP",
            bounds=[(0.0, L)] * (2 * kk),
            constraints=cons,
            options={"maxiter": 300, "ftol": 1e-12})
        if res.success:
            ok = all(c["fun"](res.x) >= -1e-9 for c in cons)
            if ok:
                best = min(best, float(res.fun))
    return best


# ---------- rsyn-like (process selection + log revenue, waterfilling)

def _rsyn_data(k, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(1.0, 4.0, size=k)           # build cost
    q = rng.uniform(0.4, 1.0, size=k)           # unit operating cost
    pr = rng.uniform(1.5, 4.0, size=k)          # log revenue coefficient
    U = rng.uniform(2.0, 5.0, size=k)           # capacity
    D = float(np.floor(0.4 * U.sum()))          # demand
    return c, q, pr, U, D


def rsyn(k: int = 8, seed: int = 0) -> Problem:
    """Process selection: min sum c_j z_j + q_j x_j - p_j ln(1 + x_j)
    s.t. x_j <= U_j z_j, sum x_j >= D (family: rsyn0805 — retrofit
    synthesis' select-and-operate structure with concave log revenue)."""
    c, q, pr, U, D = _rsyn_data(k, seed)
    p = Problem(f"rsyn_{k}")
    for j in range(k):
        p.new_variable(0.0, float(U[j]), VarType.CONTINUOUS, f"x{j}")
    for j in range(k):
        p.new_variable(0, 1, VarType.BINARY, f"z{j}")
    for j in range(k):
        p.new_constraint(Function(lf=LinearFunction(
            {j: 1.0, k + j: -float(U[j])})), -_INF, 0.0, f"cap{j}")
    p.new_constraint(Function(lf=LinearFunction(
        {j: 1.0 for j in range(k)})), D, _INF, "demand")
    g = ExprGraph()
    acc = None
    for j in range(k):
        one_px = g.node(Op.PLUS, g.num(1.0), g.var(j))
        term = g.node(Op.MULT, g.num(-float(pr[j])),
                      g.node(Op.LOG, one_px))
        acc = term if acc is None else g.node(Op.PLUS, acc, term)
    g.root = acc
    lf = LinearFunction({j: float(q[j]) for j in range(k)})
    for j in range(k):
        lf.add_term(k + j, float(c[j]))
    p.new_objective(Function(lf=lf, nlf=g))
    return p


def rsyn_optimum(k: int = 8, seed: int = 0) -> float:
    """Exact: enumerate supports; per support the continuous part is
    separable convex with one coupling row — Lagrangian waterfilling
    x_j(mu) = clip(p_j/(q_j - mu) - 1, 0, U_j), mu by bisection."""
    c, q, pr, U, D = _rsyn_data(k, seed)
    best = _INF
    for mask in range(1 << k):
        S = np.array([j for j in range(k) if mask >> j & 1], dtype=int)
        if U[S].sum() < D - 1e-12:
            continue
        fixed = float(c[S].sum()) if len(S) else 0.0
        if len(S) == 0:
            continue
        qS, pS, US = q[S], pr[S], U[S]

        def x_of(mu):
            den = np.maximum(qS - mu, 1e-300)
            return np.clip(pS / den - 1.0, 0.0, US)

        x = x_of(0.0)
        if x.sum() < D - 1e-12:
            lo, hi = 0.0, float(qS.min()) - 1e-12
            for _ in range(200):
                mu = 0.5 * (lo + hi)
                if x_of(mu).sum() < D:
                    lo = mu
                else:
                    hi = mu
            x = x_of(hi)
            s = x.sum()
            if s > D + 1e-9:      # scale the free coordinates down
                pass
        val = fixed + float(qS @ x - pS @ np.log1p(x))
        best = min(best, val)
    return best


# ----------------------- st_e14-like (tiny exp-constrained MINLP)

def _st_e14_data(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(1.2, 2.2, size=3)
    return a


def st_e14_like(seed: int = 0) -> Problem:
    """min x0 + x1 + sum c_j y_j  s.t.  exp(x0) - x1 <= a0,
    exp(x1) + x0 + y0 <= a1 + 2, x0 + y1 >= 0.8, x1 + y2 >= 0.6,
    y binary (family: st_e14 — the little exp-row MINLP shape)."""
    a = _st_e14_data(seed)
    p = Problem("st_e14_like")
    p.new_variable(0.0, 2.0, VarType.CONTINUOUS, "x0")
    p.new_variable(0.0, 2.0, VarType.CONTINUOUS, "x1")
    for j in range(3):
        p.new_variable(0, 1, VarType.BINARY, f"y{j}")
    g0 = ExprGraph()
    g0.root = g0.node(Op.EXP, g0.var(0))
    p.new_constraint(Function(lf=LinearFunction({1: -1.0}), nlf=g0),
                     -_INF, float(a[0]), "e0")
    g1 = ExprGraph()
    g1.root = g1.node(Op.EXP, g1.var(1))
    p.new_constraint(Function(lf=LinearFunction({0: 1.0, 2: 1.0}),
                              nlf=g1), -_INF, float(a[1]) + 2.0, "e1")
    p.new_constraint(Function(lf=LinearFunction({0: 1.0, 3: 1.0})),
                     0.8, _INF, "l0")
    p.new_constraint(Function(lf=LinearFunction({1: 1.0, 4: 1.0})),
                     0.6, _INF, "l1")
    p.new_objective(Function(lf=LinearFunction(
        {0: 1.0, 1: 1.0, 2: 0.7, 3: 0.9, 4: 0.5})))
    return p


def st_e14_like_optimum(seed: int = 0) -> float:
    """Exact: enumerate the 8 binary combos; each continuous sub is a
    tiny convex program solved by SLSQP."""
    from scipy.optimize import minimize
    a = _st_e14_data(seed)
    best = _INF
    for y0, y1, y2 in itertools.product((0, 1), repeat=3):
        cons = [
            {"type": "ineq",
             "fun": lambda x: a[0] - (np.exp(x[0]) - x[1])},
            {"type": "ineq",
             "fun": lambda x, y0=y0: a[1] + 2.0 -
             (np.exp(x[1]) + x[0] + y0)},
            {"type": "ineq", "fun": lambda x, y1=y1: x[0] + y1 - 0.8},
            {"type": "ineq", "fun": lambda x, y2=y2: x[1] + y2 - 0.6},
        ]
        res = minimize(lambda x: x[0] + x[1], np.array([0.5, 0.5]),
                       method="SLSQP", bounds=[(0.0, 2.0)] * 2,
                       constraints=cons,
                       options={"maxiter": 300, "ftol": 1e-12})
        if res.success and all(c["fun"](res.x) >= -1e-9 for c in cons):
            best = min(best, float(res.fun) +
                       0.7 * y0 + 0.9 * y1 + 0.5 * y2)
    return best


# ------------- intquad (separable integer QP; greedy-exchange oracle;
#                the deliberate dense-scaling row at n = 2048)

def _intquad_data(n, u, seed):
    rng = np.random.default_rng(seed)
    qd = rng.uniform(0.5, 2.0, size=n)
    t = rng.uniform(0.0, float(u), size=n)
    b = int(math.floor(0.42 * n * u))
    return qd, t, b


def intquad(n: int = 2048, u: int = 4, seed: int = 0) -> Problem:
    """min sum q_i (x_i - t_i)^2  s.t.  sum x_i <= b, x int in [0,u]^n
    — the deliberate n>=1000 dense-wall instance (diagonal PSD MIQP:
    certified dual bounds, device-pool eligible)."""
    qd, t, b = _intquad_data(n, u, seed)
    p = Problem(f"intquad_{n}")
    for i in range(n):
        p.new_variable(0, u, VarType.INTEGER, f"x{i}")
    p.new_constraint(Function(lf=LinearFunction(
        {i: 1.0 for i in range(n)})), -_INF, float(b), "budget")
    qf = QuadraticFunction({(i, i): float(qd[i]) for i in range(n)})
    lf = LinearFunction({i: float(-2.0 * qd[i] * t[i]) for i in range(n)})
    p.new_objective(Function(lf=lf, qf=qf),
                    const=float((qd * t * t).sum()))
    return p


def intquad_optimum(n: int = 2048, u: int = 4, seed: int = 0) -> float:
    """Exact greedy exchange: start at the per-coordinate integer argmin
    (round of t, clipped); while over budget, decrement the coordinate
    with the smallest cost increase.  Exact because the objective is
    separable convex and the constraint is a single cardinality-type
    row (polymatroid greedy)."""
    qd, t, b = _intquad_data(n, u, seed)
    x = np.clip(np.round(t), 0, u).astype(np.int64)
    over = int(x.sum()) - b
    if over > 0:
        # marginal increase of stepping x_i down once: q((x-1-t)^2-(x-t)^2)
        for _ in range(over):
            d = np.where(x > 0,
                         qd * (1.0 - 2.0 * (x - t)), np.inf)
            i = int(np.argmin(d))
            x[i] -= 1
    return float(qd @ (x - t) ** 2)


SUITE.update({
    "stockcycle_24a": (lambda: stockcycle(24, 8, 0),
                       lambda: stockcycle_optimum(24, 8, 0),
                       "stockcycle"),
    "sssd_7x3a": (lambda: sssd(7, 3, 0), lambda: sssd_optimum(7, 3, 0),
                  "sssd08-04/12-05"),
    "portcard_8_3a": (lambda: portcard(8, 3, 0),
                      lambda: portcard_optimum(8, 3, 0),
                      "portfol_card / alan"),
    "clay2_3a": (lambda: clay2(3, 3), lambda: clay2_optimum(3, 3),
                 "clay0203m / slay (2-D)"),
    "rsyn_8a": (lambda: rsyn(8, 0), lambda: rsyn_optimum(8, 0),
                "rsyn0805"),
    "st_e14a": (st_e14_like, st_e14_like_optimum, "st_e14"),
    # additional seeds/sizes for breadth (>=30-row sweep)
    "stockcycle_60a": (lambda: stockcycle(60, 8, 3),
                       lambda: stockcycle_optimum(60, 8, 3),
                       "stockcycle (n=60)"),
    "sssd_8x3b": (lambda: sssd(8, 3, 5), lambda: sssd_optimum(8, 3, 5),
                  "sssd (seed 5)"),
    "portcard_10_3b": (lambda: portcard(10, 3, 2),
                       lambda: portcard_optimum(10, 3, 2),
                       "portfol (n=10)"),
    "clay2_3b": (lambda: clay2(3, 6), lambda: clay2_optimum(3, 6),
                 "clay (seed 6)"),
    "rsyn_10b": (lambda: rsyn(10, 1), lambda: rsyn_optimum(10, 1),
                 "rsyn (k=10)"),
    "st_e14b": (lambda: st_e14_like(2), lambda: st_e14_like_optimum(2),
                "st_e14 (seed 2)"),
    # ---- the deliberate n >= 1000 dense-wall rows
    "intquad_2048a": (lambda: intquad(2048, 4, 0),
                      lambda: intquad_optimum(2048, 4, 0),
                      "n=2048 separable MIQP (dense wall)"),
    "normcon_1024a": (None, None, "filled below"),
    "cknap_1200a": (None, None, "filled below"),
})


def _normcon_big():
    from .convex_suite import normcon
    return normcon(1024, 7)


def _normcon_big_opt():
    from .convex_suite import normcon_optimum
    return normcon_optimum(1024, 7)


def _cknap_big():
    from .generators import correlated_knapsack
    return correlated_knapsack(1200, 2)


def _cknap_big_opt():
    from .generators import knapsack_dp_optimum
    return knapsack_dp_optimum(1200, 2)


SUITE["normcon_1024a"] = (_normcon_big, _normcon_big_opt,
                          "cvxnonsep_normcon (n=1024)")
SUITE["cknap_1200a"] = (_cknap_big, _cknap_big_opt,
                        "knapsack MILP (n=1200)")
