"""The quadratic knapsack class of Gallo, Hammer & Simeone (1980).

    max  sum_i p_ii x_i + sum_{i<j} p_ij x_i x_j   s.t.  sum_j w_j x_j <= c,
         x binary

p_ij (i <= j) is nonzero with probability `density`, and then a uniform
integer in [1, p_max]; w_j is a uniform integer in [1, w_max]; c is a
uniform integer in [c_min, sum w].  (p_ii is the linear profit: x_i^2 = x_i
for a binary.)  The objective is maximised, so the port receives it
negated.  One instance is drawn from the configuration's `instance_seed`;
the run's seed permutes its items.
"""

from __future__ import annotations

import numpy as np

from .common import instance_rng


def data(n: int, density: float, p_max: int, w_max: int, c_min: int,
         seed: int):
    """(P upper triangular (n, n) with the diagonal, w (n,), c)."""
    rng = np.random.default_rng(seed)
    mask = rng.random((n, n)) < density
    vals = rng.integers(1, p_max + 1, size=(n, n))
    P = np.triu(np.where(mask, vals, 0)).astype(np.float64)
    w = rng.integers(1, w_max + 1, size=n).astype(np.float64)
    c = float(rng.integers(c_min, int(w.sum()) + 1))
    return P, w, c


def generate(sizes: dict, instance_seed: int, seed: int, index: int) -> dict:
    n = int(sizes["n"])
    P, w, c = data(n, float(sizes["density"]), int(sizes["p_max"]),
                   int(sizes["w_max"]), int(sizes["c_min"]), instance_seed)
    perm = instance_rng(seed, index).permutation(n)
    Pf = P + np.triu(P, 1).T             # symmetric, diagonal once
    Pp = np.triu(Pf[np.ix_(perm, perm)])
    w = w[perm]
    iu, ju = np.nonzero(np.triu(Pp, 1))
    return dict(
        name=f"qkp_ghs_{n}",
        lb=np.zeros(n), ub=np.ones(n), vtype=["B"] * n,
        c=-np.diag(Pp).copy(), const=0.0,
        qi=iu, qj=ju, qv=-Pp[iu, ju],
        A=w[None, :].copy(), rlo=np.array([-np.inf]), rhi=np.array([c]),
        family=dict(P=Pp, w=w, c=c), perm=perm)
