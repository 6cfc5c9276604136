"""Plain reference of the quadratic knapsack (see generators/qkp_ghs.py).

The port minimises the negated profit, so every value here is
-(sum_i p_ii x_i + sum_{i<j} p_ij x_i x_j).  A node's relaxation is the
McCormick LP over its x box: one variable y_ij for each nonzero pair, the
four McCormick rows of y_ij = x_i x_j from the box, and the knapsack row,
built here from (P, w, c) and solved by `lp.solve`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import lp

INT_TOL = 1e-6
LANES = 8            # LPs solved together


def propagate(fam: dict, lb: np.ndarray, ub: np.ndarray):
    """The (L, n) x boxes after propagating the knapsack row and rounding:
    x_j <= (c - sum_{k != j} w_k lb_k) / w_j."""
    w, c = fam["w"][None, :], fam["c"]
    lb = np.ceil(lb - INT_TOL)
    rest = (w * lb).sum(axis=1, keepdims=True) - w * lb
    ub = np.floor(np.minimum(ub, (c - rest) / w) + INT_TOL)
    return lb, ub


def _pairs(fam):
    P = fam["P"]
    i, j = np.nonzero(np.triu(P, 1))
    return i, j, P[i, j]


def solvable(fam: dict, lb: np.ndarray, ub: np.ndarray) -> np.ndarray:
    """(L,) whether each box is nonempty and meets the knapsack row (the
    McCormick LP of such a box is feasible: x = lb with its y)."""
    return ~((lb > ub).any(axis=1) | ((fam["w"][None, :] * lb).sum(axis=1)
                                      > fam["c"]))


def relaxation(fam: dict, lb: np.ndarray, ub: np.ndarray, dtype=np.float64,
               device="cpu"):
    """McCormick LP value of each (L, n) box (+inf where it is empty or
    misses the knapsack row) and its x part."""
    P, w, cap = fam["P"], fam["w"], fam["c"]
    n = len(w)
    pi, pj, pv = _pairs(fam)
    K = len(pi)
    L = len(lb)
    infeas = ~solvable(fam, lb, ub)
    ub = np.maximum(lb, ub)
    nz, m = n + K, 4 * K + 1
    G = np.zeros((L, m, nz))
    h = np.zeros((L, m))
    li, ui, lj, uj = lb[:, pi], ub[:, pi], lb[:, pj], ub[:, pj]
    r = np.arange(K)
    yc = n + r
    for k, (ai, aj, sy, rhs) in enumerate((
            (lj, li, -1.0, li * lj),          # y >= lj xi + li xj - li lj
            (uj, ui, -1.0, ui * uj),          # y >= uj xi + ui xj - ui uj
            (-uj, -li, 1.0, -li * uj),        # y <= uj xi + li xj - li uj
            (-lj, -ui, 1.0, -ui * lj))):      # y <= lj xi + ui xj - ui lj
        rows = 4 * r + k
        G[:, rows, pi] += ai
        G[:, rows, pj] += aj
        G[:, rows, yc] = sy
        h[:, rows] = rhs
    G[:, m - 1, :n] = w
    h[:, m - 1] = cap
    cvec = np.concatenate([-np.diag(P), -pv])
    zl = np.concatenate([lb, li * lj], axis=1)
    zu = np.concatenate([ub, ui * uj], axis=1)
    tdt = getattr(torch, np.dtype(dtype).name)
    val = np.full(L, np.inf)
    x = np.zeros((L, n))
    ok = np.nonzero(~infeas)[0]
    for part in np.array_split(ok, max(1, -(-len(ok) // LANES))):
        if not len(part):
            continue
        t = lambda a: torch.as_tensor(a[part], dtype=tdt,  # noqa: E731
                                      device=device)
        v, z, conv = lp.solve(t(np.broadcast_to(cvec, (L, nz))), t(G),
                              t(h), t(zl), t(zu))
        # in float64 (the truth) an LP the reference could not solve to
        # its tolerance has no value: NaN, which fails the comparison
        if dtype == np.float64:
            v = torch.where(conv, v, float("nan"))
        val[part] = v.double().cpu().numpy()
        x[part] = z[:, :n].double().cpu().numpy()
    return val, x


def violation(fam: dict, lb: np.ndarray, ub: np.ndarray, x: np.ndarray):
    """(L,) largest violation by x of its box and of the knapsack row,
    relative to max(1, |bound|)."""
    box = np.maximum(np.maximum(lb - x, x - ub), 0.0)
    row = np.maximum(x @ fam["w"] - fam["c"], 0.0) / max(1.0, fam["c"])
    return np.maximum(box.max(axis=1), row)


def relaxed_objective(fam: dict, lb: np.ndarray, ub: np.ndarray,
                      x: np.ndarray) -> np.ndarray:
    """(L,) the McCormick LP's least objective at each lane's x part: every
    y_ij as large as its upper envelopes and u_i u_j let it be (all
    profits are nonnegative)."""
    P = fam["P"]
    pi, pj, pv = _pairs(fam)
    li, ui, lj, uj = lb[:, pi], ub[:, pi], lb[:, pj], ub[:, pj]
    xi, xj = x[:, pi], x[:, pj]
    y = np.minimum(np.minimum(uj * xi + li * xj - li * uj,
                              lj * xi + ui * xj - ui * lj), ui * uj)
    return -(x @ np.diag(P) + y @ pv)


def objective(fam: dict, x: np.ndarray, dtype=np.float64) -> float:
    P = fam["P"].astype(dtype)
    x = x.astype(dtype)
    return -float(x @ P @ x)


def point_violation(fam: dict, x: np.ndarray) -> float:
    return float(max(np.abs(x - np.round(x)).max(),
                     np.maximum(-x, 0).max(), np.maximum(x - 1, 0).max(),
                     max(x @ fam["w"] - fam["c"], 0.0)))


def final_truth(fam: dict) -> float:
    """A value no valid global lower bound may exceed: that of a feasible
    packing, items taken greedily by profit (linear plus half of each
    pair) over weight."""
    P, w, cap = fam["P"], fam["w"], fam["c"]
    Ps = P + np.triu(P, 1).T
    score = (np.diag(P) + 0.5 * (Ps.sum(axis=1) - np.diag(P))) / w
    x = np.zeros(len(w))
    load = 0.0
    for j in np.argsort(-score, kind="stable"):
        if load + w[j] <= cap:
            x[j] = 1.0
            load += w[j]
    return objective(fam, x)
