"""Plain NumPy reference of intquad (see generators/intquad.py).

Everything is worked out again from the instance data (q, t, b, u): the
node box after bound propagation, the exact continuous relaxation of a
node, the exact integer optimum and the objective of a point.  `dtype`
float32 gives the control: the same arithmetic one precision down.
"""

from __future__ import annotations

import numpy as np

INT_TOL = 1e-6
BISECTIONS = 64


def propagate(fam: dict, lb: np.ndarray, ub: np.ndarray):
    """The node box after propagating the budget row and rounding the
    integers, on (L, n) boxes: x_i <= b - sum_{j != i} lb_j."""
    lb = np.ceil(lb - INT_TOL)
    ub = np.floor(np.minimum(ub, fam["b"] - (lb.sum(axis=1, keepdims=True)
                                             - lb)) + INT_TOL)
    return lb, ub


def solvable(fam: dict, lb: np.ndarray, ub: np.ndarray) -> np.ndarray:
    """(L,) whether each box is nonempty and meets the budget row."""
    return ~((lb > ub).any(axis=1) | (lb.sum(axis=1) > fam["b"]))


def relaxation(fam: dict, lb: np.ndarray, ub: np.ndarray, dtype=np.float64,
               device=None):
    """Exact minimum of sum q (x - t)^2 over {sum x <= b} and the (L, n)
    boxes: x(lam) = clip(t - lam / 2q, lb, ub), lam >= 0 by bisection on
    the budget.  Returns (value (L,), x (L, n)); +inf where the box is
    empty or misses the budget row."""
    q = fam["q"].astype(dtype)[None, :]
    t = fam["t"].astype(dtype)[None, :]
    b = dtype(fam["b"])
    infeas = ~solvable(fam, lb, ub)
    lb, ub = lb.astype(dtype), ub.astype(dtype)
    ub = np.maximum(lb, ub)

    def x_at(lam):
        return np.clip(t - lam[:, None] / (dtype(2) * q), lb, ub)

    lo = np.zeros(len(lb), dtype)
    hi = (dtype(2) * q * np.maximum(t - lb, 0)).max(axis=1) + dtype(1)
    free = x_at(lo).sum(axis=1) <= b
    for _ in range(BISECTIONS):
        mid = (lo + hi) / dtype(2)
        over = x_at(mid).sum(axis=1) > b
        lo = np.where(over, mid, lo)
        hi = np.where(over, hi, mid)
    x = x_at(np.where(free, dtype(0), hi))
    val = (q * (x - t) ** 2).sum(axis=1)
    return np.where(infeas, np.inf, val), x


def violation(fam: dict, lb: np.ndarray, ub: np.ndarray, x: np.ndarray):
    """(L,) largest violation by x of its box and of the budget row,
    relative to max(1, |bound|)."""
    box = np.maximum(np.maximum(lb - x, x - ub), 0.0) / \
        np.maximum(1.0, np.maximum(np.abs(lb), np.abs(ub)))
    row = np.maximum(x.sum(axis=1) - fam["b"], 0.0) / max(1.0, abs(fam["b"]))
    return np.maximum(box.max(axis=1), row)


def relaxed_objective(fam: dict, lb: np.ndarray, ub: np.ndarray,
                      x: np.ndarray) -> np.ndarray:
    """(L,) the relaxation's objective at each lane's point."""
    return (fam["q"][None, :] * (x - fam["t"][None, :]) ** 2).sum(axis=1)


def objective(fam: dict, x: np.ndarray, dtype=np.float64) -> float:
    q, t = fam["q"].astype(dtype), fam["t"].astype(dtype)
    x = x.astype(dtype)
    return float((q * (x - t) ** 2).sum())


def point_violation(fam: dict, x: np.ndarray) -> float:
    """Violation by an incumbent of integrality, [0, u] and the budget."""
    u = fam["u"]
    return float(max(np.abs(x - np.round(x)).max(),
                     np.maximum(-x, 0).max(), np.maximum(x - u, 0).max(),
                     max(x.sum() - fam["b"], 0.0)))


def optimum(fam: dict) -> float:
    """Exact integer optimum: start at the rounded targets and, while over
    budget, step down the coordinate whose step costs least (exact for a
    separable convex objective under one cardinality row)."""
    q, t, b, u = fam["q"], fam["t"], fam["b"], fam["u"]
    x = np.clip(np.round(t), 0, u)
    for _ in range(max(0, int(round(x.sum() - b)))):
        d = np.where(x > 0, q * (1.0 - 2.0 * (x - t)), np.inf)
        x[int(np.argmin(d))] -= 1
    return float((q * (x - t) ** 2).sum())


def final_truth(fam: dict) -> float:
    """A value no valid global lower bound may exceed: the optimum."""
    return optimum(fam)
