"""The comparison that decides `correct`.

The program's answers (captured by the harness from the timed path) are
held to the reference of their family, which works everything out again
from the instance data:

- `bound_excess`: by how much a certified node bound of the window, or the
  host loop's final global bound, lies above what it bounds: the exact
  relaxation of the node's box (after the reference's own propagation),
  or a value no global bound may pass (the optimum, or a feasible point's
  value).  Relative to max(1, |truth|); at most 0 up to rounding.
- `opt_gap`: on each lane the program reports as optimal, by how much it
  misses the exact relaxation from the other side: the larger of (truth -
  its certified bound) and (the relaxation's objective at its solution -
  truth), relative to max(1, |truth|).  A bound that is valid but weak,
  or a point that is feasible but not optimal, reads here.
- `primal_viol`: the largest violation of its node's box or rows by a
  relaxation solution the program reports as optimal.
- `short_share`: over every lane of the window (`capture["every"]`, not
  only those compared), the share of the lanes whose box the reference
  finds solvable (nonempty, meeting the rows) that the program leaves
  short of optimal (the iteration limit, a numerical stop): an IPM cut
  short reads here.
- `incumbent_err`: the incumbent's violation of integrality, bounds and
  rows, and the gap between the reported upper bound and the incumbent's
  objective worked out again (0 where the window found none).

A configuration compares the numbers its `limits` name, and no others.

`control_numbers` computes the same numbers with the reference itself in
the program's place, one precision down (float32): its bounds and points
are the answers held to the float64 truth.
"""

from __future__ import annotations

import importlib

import numpy as np

NUMBERS = ("bound_excess", "opt_gap", "primal_viol", "short_share",
           "incumbent_err")
OPTIMAL = 1


def family(name: str):
    return importlib.import_module(f"{__package__}.{name}")


def _scale(v):
    return np.maximum(1.0, np.abs(np.where(np.isfinite(v), v, 0.0)))


def _excess(db, truth):
    """(db - truth) / max(1, |truth|); -inf where nothing is bounded."""
    with np.errstate(invalid="ignore"):
        e = (db - truth) / _scale(truth)
    return np.where(np.isinf(truth) & (truth > 0), -np.inf, e)


def lane_truth(fam_mod, fam: dict, lanes: dict, dtype=np.float64,
               device="cpu"):
    """The reference's box and relaxation (value, x) for captured lanes."""
    lb, ub = fam_mod.propagate(fam, lanes["lb"], lanes["ub"])
    val, x = fam_mod.relaxation(fam, lb, ub, dtype=dtype, device=device)
    return lb, ub, val, x


def _gap(fam_mod, fam, lb, ub, db, x, truth):
    """(L,) max(truth - db, relaxation objective at x - truth) / scale."""
    with np.errstate(invalid="ignore"):
        obj = fam_mod.relaxed_objective(fam, lb, ub, x)
        return np.maximum(truth - db, obj - truth) / _scale(truth)


def numbers(fam_mod, fam: dict, capture: dict, limits: dict,
            device="cpu"):
    """(the numbers, how many compared lanes break a limit, plus one where
    the share of lanes left short breaks its own)."""
    lanes, final = capture["lanes"], capture["final"]
    lb, ub, truth, _ = lane_truth(fam_mod, fam, lanes, device=device)
    db, x = lanes["db"], lanes["x"]
    opt = lanes["status"] == OPTIMAL
    solved = np.isfinite(truth)
    ex = _excess(db, truth)
    ft = fam_mod.final_truth(fam)
    ex_final = (final["lb"] - ft) / max(1.0, abs(ft))
    gap = np.where(opt & solved, _gap(fam_mod, fam, lb, ub, db, x, truth),
                   -np.inf)
    viol = np.where(opt & solved, fam_mod.violation(fam, lb, ub, x), 0.0)
    every = capture["every"]
    elb, eub = fam_mod.propagate(fam, every["lb"], every["ub"])
    can = fam_mod.solvable(fam, elb, eub)
    short = can & (every["status"] != OPTIMAL)
    share = float(short.sum() / max(1, can.sum()))
    bad = np.zeros(len(db), dtype=bool)
    for k, v in (("bound_excess", ex), ("opt_gap", gap),
                 ("primal_viol", viol)):
        if k in limits:
            bad |= (v > limits[k]) | np.isnan(v)
    return dict(
        bound_excess=float(max(ex.max(initial=-np.inf), ex_final)),
        opt_gap=float(gap.max(initial=-np.inf)),
        primal_viol=float(viol.max(initial=0.0)),
        short_share=share,
        incumbent_err=incumbent_err(fam_mod, fam, final["x"], final["ub"])
    ), int(bad.sum()) + int(share > limits["short_share"])


def incumbent_err(fam_mod, fam, x, ub, dtype=np.float64) -> float:
    if x is None:
        return 0.0 if not np.isfinite(ub) else float("inf")
    x = np.asarray(x, dtype=np.float64)
    val = fam_mod.objective(fam, x, dtype=dtype)
    return float(max(abs(val - ub) / max(1.0, abs(ub)),
                     fam_mod.point_violation(fam, x)))


def control_numbers(fam_mod, fam: dict, capture: dict, device="cpu") -> dict:
    """The numbers that the reference reads in the program's place, in
    float32, on the same boxes and incumbent."""
    lanes, final = capture["lanes"], capture["final"]
    lb, ub, truth, _ = lane_truth(fam_mod, fam, lanes, device=device)
    _, _, v32, x32 = lane_truth(fam_mod, fam, lanes, dtype=np.float32,
                                device=device)
    x32 = x32.astype(np.float64)
    fin = np.isfinite(truth)
    ex = _excess(np.where(np.isfinite(v32), v32, 1e20), truth)
    gap = np.where(fin, _gap(fam_mod, fam, lb, ub, v32, x32, truth), -np.inf)
    viol = fam_mod.violation(fam, lb, ub, x32)
    inc = 0.0
    if final["x"] is not None:
        x = np.asarray(final["x"], dtype=np.float64)
        v64 = fam_mod.objective(fam, x)
        inc = abs(fam_mod.objective(fam, x, dtype=np.float32) - v64) / \
            max(1.0, abs(v64))
    return dict(bound_excess=float(ex.max(initial=-np.inf)),
                opt_gap=float(gap.max(initial=-np.inf)),
                primal_viol=float(np.where(fin, viol, 0.0).max(initial=0.0)),
                short_share=float((fin & ~np.isfinite(v32)).sum() /
                                  max(1, fin.sum())),
                incumbent_err=float(inc))


def verdict(values: dict, limits: dict):
    """(correct, lines): each number that `limits` names beside its limit;
    a number that is not finite, or above its limit, fails."""
    lines, ok = [], True
    for k in (k for k in NUMBERS if k in limits):
        v, lim = values[k], limits[k]
        good = bool(np.isfinite(v) or v == -np.inf) and v <= lim
        ok &= good
        lines.append((k, v, lim, good))
    return ok, lines
