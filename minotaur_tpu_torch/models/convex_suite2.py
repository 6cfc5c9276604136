"""The `intquad` family of minotaur_tpu/models/convex_suite2.py.

Copied verbatim (generator and its exact greedy-exchange oracle): the
port's main path runs on in-repo generators with exact oracles.
"""

from __future__ import annotations

import math

import numpy as np

from ..ir.functions import Function, LinearFunction, QuadraticFunction
from ..ir.problem import Problem
from ..utils.types import VarType

_INF = float("inf")


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
