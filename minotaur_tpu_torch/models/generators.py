"""Synthetic problem-family generators.

The reference's "models" are its optimization problem classes; this
module generates parameterized instances of the families named in the
benchmark plan (BASELINE.json configs: knapsack + bilinear examples) for
tests and throughput benchmarks.
"""

from __future__ import annotations

import numpy as np

from ..ir.functions import Function, LinearFunction, QuadraticFunction
from ..ir.problem import Problem
from ..utils.types import VarType


def quadratic_knapsack(n: int = 12, density: float = 0.3, seed: int = 0
                       ) -> Problem:
    """max value + pairwise synergies under a capacity row (nonconvex
    after min-conversion); global optimum via mglob."""
    rng = np.random.default_rng(seed)
    w = rng.integers(2, 10, size=n).astype(float)
    p = Problem(f"qknap{n}")
    for j in range(n):
        p.new_variable(0, 1, VarType.BINARY, f"x{j}")
    p.new_constraint(
        Function(lf=LinearFunction({j: w[j] for j in range(n)})),
        -np.inf, float(w.sum() * 0.5), "capacity")
    qf = QuadraticFunction()
    lf = LinearFunction()
    for j in range(n):
        lf.add_term(j, -float(rng.uniform(1, 5)))
        for k in range(j + 1, n):
            if rng.uniform() < density:
                qf.add_term(j, k, -float(rng.uniform(0.5, 2.0)))
    p.new_objective(Function(lf=lf, qf=qf))
    return p


def bilinear_pooling(n_pairs: int = 4, seed: int = 0) -> Problem:
    """min sum of bilinear terms over coupled simplices — a pooling-style
    nonconvex QCQP for the spatial-branching pipeline."""
    rng = np.random.default_rng(seed)
    p = Problem(f"bilin{n_pairs}")
    for j in range(2 * n_pairs):
        p.new_variable(0.0, 4.0, VarType.CONTINUOUS, f"x{j}")
    qf = QuadraticFunction()
    for t in range(n_pairs):
        i, j = 2 * t, 2 * t + 1
        qf.add_term(i, j, -float(rng.uniform(0.5, 1.5)))
        p.new_constraint(
            Function(lf=LinearFunction({i: 1.0, j: 1.0})),
            -np.inf, float(rng.uniform(3.0, 5.0)), f"cap{t}")
    p.new_objective(Function(qf=qf))
    return p


def convex_miqp(n_cont: int = 4, n_int: int = 4, seed: int = 0) -> Problem:
    """min ||x - a||^2 with integer coordinates on half the variables and
    a coupling budget row — a convex MIQP for mbnb/mqg/moa."""
    rng = np.random.default_rng(seed)
    n = n_cont + n_int
    a = rng.uniform(0.0, 8.0, size=n)
    p = Problem(f"cmiqp{n}")
    for j in range(n):
        vt = VarType.INTEGER if j >= n_cont else VarType.CONTINUOUS
        p.new_variable(0.0, 10.0, vt, f"x{j}")
    p.new_constraint(
        Function(lf=LinearFunction({j: 1.0 for j in range(n)})),
        -np.inf, float(a.sum() * 0.8), "budget")
    qf = QuadraticFunction()
    lf = LinearFunction()
    for j in range(n):
        qf.add_term(j, j, 1.0)
        lf.add_term(j, -2.0 * a[j])
    p.new_objective(Function(lf=lf, qf=qf), const=float(a @ a))
    return p


def correlated_knapsack(n: int = 30, seed: int = 1, frac: float = 0.5
                        ) -> Problem:
    """0/1 knapsack with value~weight correlation — correlated instances
    are the classically hard family, giving a few-hundred-node B&B tree
    at n=30-40 (used by the multi-chip/multi-process dryruns, which need
    a tree big enough to trigger load balancing; the shipped reference
    instances' trees are 1-7 nodes).  The exact optimum is checked
    against `knapsack_dp_optimum`."""
    rng = np.random.default_rng(seed)
    w = rng.integers(20, 70, size=n).astype(float)
    v = w + rng.uniform(-4, 8, size=n)
    cap = float(np.floor(w.sum() * frac))
    p = Problem(f"cknap{n}")
    for j in range(n):
        p.new_variable(0, 1, VarType.BINARY, f"x{j}")
    p.new_constraint(
        Function(lf=LinearFunction({j: float(w[j]) for j in range(n)})),
        -np.inf, cap, "cap")
    p.new_objective(Function(lf=LinearFunction(
        {j: -float(v[j]) for j in range(n)})))
    return p


def knapsack_dp_optimum(n: int = 30, seed: int = 1, frac: float = 0.5
                        ) -> float:
    """Exact optimum of `correlated_knapsack` by dynamic programming
    over the integer weights (independent ground truth for dryruns)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(20, 70, size=n)
    v = w + rng.uniform(-4, 8, size=n)
    cap = int(np.floor(float(w.sum()) * frac))
    best = np.zeros(cap + 1)
    for wi, vi in zip(w, v):
        nb = best.copy()
        nb[wi:] = np.maximum(nb[wi:], best[:-wi] + vi)
        best = nb
    return -float(best.max())
