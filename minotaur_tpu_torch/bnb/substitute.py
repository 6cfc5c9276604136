"""Root presolve substitution / variable elimination + postsolve.

Reference: LinearHandler.cpp:1429 (`substVars_` doubleton substitution),
Presolver.cpp:288 (`getPostSol`), PreAuxVars/PreDelVars/PreSubstVars
undo-records.  The repo's in-tree FBBT only tightens bounds because cut
pools and staged shapes must stay static DURING the tree — but the root
presolve runs ONCE before staging, so eliminating columns here shrinks
every subsequent device program (smaller n for every KKT factorization)
and can never trigger a recompile.

What is eliminated (continuous-and-linear-only occurrences, so the
substitution is exact and needs no DAG rewrites beyond index remapping):
- fixed columns (lb == ub) — integer or continuous;
- singleton equality rows a*x = c  ->  x fixed at c/a;
- doubleton equality rows a*x + b*y = c  ->  y := (c - a*x)/b, with y's
  bounds folded into x's.

The `Postsolve` map lifts a reduced-space point back to the original
space by replaying the eliminations in reverse (getPostSol semantics).
The debug_sol oracle survives: the reduced problem's debug_sol is the
restriction of the original's, asserted feasible after reduction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ir.expr import ExprGraph
from ..ir.functions import Function, LinearFunction, QuadraticFunction
from ..ir.problem import Problem
from ..utils.types import VarType

_INF = float("inf")


@dataclasses.dataclass
class Postsolve:
    """Affine lift from reduced space to original space (reference:
    Presolver::getPostSol + PreSubstVars undo-records)."""
    n_orig: int
    keep: np.ndarray                      # original indices kept (sorted)
    # elimination steps IN ORDER; replayed in reverse by lift():
    #   ("fix", j, val)            x_j := val
    #   ("sub", y, x, alpha, beta) x_y := alpha * x_x + beta
    steps: List[tuple] = dataclasses.field(default_factory=list)

    def lift(self, x_red: np.ndarray) -> np.ndarray:
        x = np.full(self.n_orig, np.nan)
        x[self.keep] = np.asarray(x_red)[: len(self.keep)]
        for step in reversed(self.steps):
            if step[0] == "fix":
                _, j, val = step
                x[j] = val
            else:
                _, y, xj, alpha, beta = step
                x[y] = alpha * x[xj] + beta
        return x

    def restrict(self, x_orig: np.ndarray) -> np.ndarray:
        return np.asarray(x_orig)[self.keep]

    @property
    def n_eliminated(self) -> int:
        return self.n_orig - len(self.keep)


def _remap_graph(g: ExprGraph, old2new: Dict[int, int]) -> ExprGraph:
    """Copy an expression DAG with variable indices renumbered (every
    var referenced must be in old2new — guaranteed because eliminated
    vars are linear-only by construction)."""
    h = ExprGraph()
    h._op = list(g._op)
    h._arg1 = list(g._arg1)
    h._arg2 = list(g._arg2)
    h._const = list(g._const)
    h._var = [old2new[v] if v >= 0 else v for v in g._var]
    h.root = g.root
    h._cache = {}
    h._frozen = None
    h._vars_cache = None
    return h


def substitute_problem(p: Problem, int_tol: float = 1e-6,
                       max_rounds: int = 5,
                       ) -> Optional[Tuple[Problem, Postsolve]]:
    """Eliminate substitutable columns; returns (reduced_problem,
    postsolve) or None when nothing reduces (or the problem has no
    objective).  Never raises on structure it cannot handle — those
    columns just stay."""
    n = p.n_vars
    if n == 0 or p.obj is None:
        return None
    lb = np.array([v.lb for v in p.vars], dtype=np.float64)
    ub = np.array([v.ub for v in p.vars], dtype=np.float64)
    is_int = np.array([v.is_integer() for v in p.vars], dtype=bool)

    # vars whose every occurrence is linear (objective + constraints),
    # and not pinned by SOS sets / initial structure
    nonlin = np.zeros(n, dtype=bool)
    of = p.obj.fun
    for f in [of] + [c.fun for c in p.cons]:
        if f is None:
            continue
        if f.qf is not None:
            for (i, j) in f.qf.terms:
                nonlin[i] = nonlin[j] = True
        if f.nlf is not None:
            for v in np.asarray(f.nlf.vars_used(), dtype=np.int64).ravel():
                nonlin[int(v)] = True
    for _w, vs in list(p._sos1) + list(p._sos2):
        for v in vs:
            nonlin[v] = True

    # working copies of the linear structure
    rows: List[Optional[Dict[int, float]]] = []
    rlb: List[float] = []
    rub: List[float] = []
    for c in p.cons:
        rows.append(dict(c.fun.lf.terms) if c.fun.lf is not None else {})
        rlb.append(float(c.lb))
        rub.append(float(c.ub))
    obj_lf = dict(of.lf.terms) if of.lf is not None else {}
    obj_const = float(p.obj.const)
    # var -> set of row indices containing it linearly
    occ: List[set] = [set() for _ in range(n)]
    for r, t in enumerate(rows):
        for j in t:
            occ[j].add(r)
    # row is pure-linear iff its fun has no qf/nlf content
    pure_lin = np.array(
        [c.fun.get_type().name in ("LINEAR", "CONSTANT") for c in p.cons],
        dtype=bool)

    gone = np.zeros(n, dtype=bool)
    dead_row = np.zeros(len(rows), dtype=bool)
    steps: List[tuple] = []

    def _apply_fix(j: int, val: float) -> None:
        nonlocal obj_const
        steps.append(("fix", j, float(val)))
        gone[j] = True
        for r in list(occ[j]):
            a = rows[r].pop(j, 0.0)
            if a:
                if math.isfinite(rlb[r]):
                    rlb[r] -= a * val
                if math.isfinite(rub[r]):
                    rub[r] -= a * val
            occ[j].discard(r)
        cj = obj_lf.pop(j, 0.0)
        obj_const += cj * val

    for _round in range(max_rounds):
        changed = False
        # ---- fixed columns (linear-only occurrence or truly constant)
        for j in range(n):
            if gone[j] or nonlin[j]:
                continue
            if ub[j] - lb[j] <= 1e-12 and math.isfinite(lb[j]):
                _apply_fix(j, 0.5 * (lb[j] + ub[j]))
                changed = True
        # ---- singleton / doubleton equality rows
        for r in range(len(rows)):
            if dead_row[r] or not pure_lin[r]:
                continue
            if not (math.isfinite(rlb[r]) and
                    abs(rub[r] - rlb[r]) <= 1e-12):
                continue
            t = {j: a for j, a in rows[r].items() if not gone[j]
                 and abs(a) > 1e-12}
            c0 = rlb[r]
            if len(t) == 1:
                (j, a), = t.items()
                if nonlin[j] or is_int[j]:
                    continue
                val = c0 / a
                if val < lb[j] - 1e-7 or val > ub[j] + 1e-7:
                    continue          # infeasible/borderline: leave to FBBT
                lb[j] = ub[j] = val
                dead_row[r] = True
                _apply_fix(j, val)
                changed = True
            elif len(t) == 2:
                (j1, a1), (j2, a2) = t.items()
                # eliminate a continuous, linear-only variable
                y, x2, b, a = None, None, 0.0, 0.0
                for (cand, cc), (oth, oc) in (((j1, a1), (j2, a2)),
                                              ((j2, a2), (j1, a1))):
                    if not nonlin[cand] and not is_int[cand] and \
                            abs(cc) > 1e-9 and \
                            abs(oc / cc) < 1e6:
                        y, x2, b, a = cand, oth, cc, oc
                        break
                if y is None:
                    continue
                alpha = -a / b
                beta = c0 / b
                # fold y's bounds into x2 (y = alpha x + beta)
                if alpha > 0:
                    if math.isfinite(lb[y]):
                        lb[x2] = max(lb[x2], (lb[y] - beta) / alpha)
                    if math.isfinite(ub[y]):
                        ub[x2] = min(ub[x2], (ub[y] - beta) / alpha)
                elif alpha < 0:
                    if math.isfinite(lb[y]):
                        ub[x2] = min(ub[x2], (lb[y] - beta) / alpha)
                    if math.isfinite(ub[y]):
                        lb[x2] = max(lb[x2], (ub[y] - beta) / alpha)
                else:
                    continue
                if lb[x2] > ub[x2] + 1e-9:
                    # empty box: leave the contradiction to root FBBT,
                    # which reports infeasibility with a certificate
                    lb[x2] = ub[x2]
                if is_int[x2]:
                    lb[x2] = math.ceil(lb[x2] - int_tol)
                    ub[x2] = math.floor(ub[x2] + int_tol)
                dead_row[r] = True
                gone[y] = True
                steps.append(("sub", y, x2, alpha, beta))
                # substitute y in every other row + objective
                for r2 in list(occ[y]):
                    if r2 == r or dead_row[r2]:
                        continue
                    d = rows[r2].pop(y, 0.0)
                    if not d:
                        continue
                    newc = rows[r2].get(x2, 0.0) + d * alpha
                    if abs(newc) > 1e-15:
                        rows[r2][x2] = newc
                        occ[x2].add(r2)
                    else:
                        rows[r2].pop(x2, None)
                        occ[x2].discard(r2)
                    if math.isfinite(rlb[r2]):
                        rlb[r2] -= d * beta
                    if math.isfinite(rub[r2]):
                        rub[r2] -= d * beta
                occ[y] = set()
                d = obj_lf.pop(y, 0.0)
                if d:
                    obj_lf[x2] = obj_lf.get(x2, 0.0) + d * alpha
                    obj_const += d * beta
                changed = True
        if not changed:
            break

    if not gone.any():
        return None

    # ---------------------------------------------------------- rebuild
    keep = np.where(~gone)[0]
    old2new = {int(j): i for i, j in enumerate(keep)}
    q = Problem(f"{p.name}_sub")
    for i, j in enumerate(keep):
        v = p.vars[j]
        q.new_variable(float(lb[j]), float(ub[j]), v.vtype, v.name)
    for r, c in enumerate(p.cons):
        if dead_row[r]:
            continue
        lf = LinearFunction({old2new[j]: a for j, a in rows[r].items()
                             if not gone[j] and abs(a) > 1e-15})
        qf = None
        if c.fun.qf is not None and len(c.fun.qf):
            qf = QuadraticFunction({(old2new[i], old2new[j]): v
                                    for (i, j), v in c.fun.qf.terms.items()})
        nlf = _remap_graph(c.fun.nlf, old2new) \
            if c.fun.nlf is not None else None
        if not lf.terms and qf is None and nlf is None:
            # empty row: consistency check, then drop
            if rlb[r] > 1e-7 or rub[r] < -1e-7:
                # provably infeasible row — keep a trivial contradiction
                # so the solver reports infeasibility with a certificate
                zv = LinearFunction({0: 0.0})
                q.new_constraint(Function(lf=zv), rlb[r], rub[r], c.name)
            continue
        q.new_constraint(Function(lf=lf, qf=qf, nlf=nlf),
                         float(rlb[r]), float(rub[r]), c.name)
    o_lf = LinearFunction({old2new[j]: a for j, a in obj_lf.items()
                           if not gone[j] and abs(a) > 1e-15})
    o_qf = None
    if of.qf is not None and len(of.qf):
        o_qf = QuadraticFunction({(old2new[i], old2new[j]): v
                                  for (i, j), v in of.qf.terms.items()})
    o_nlf = _remap_graph(of.nlf, old2new) if of.nlf is not None else None
    q.new_objective(Function(lf=o_lf, qf=o_qf, nlf=o_nlf),
                    const=obj_const)
    post = Postsolve(n_orig=n, keep=keep, steps=steps)
    if p.initial_point is not None:
        q.initial_point = post.restrict(p.initial_point)
    if p.debug_sol is not None:
        # debug oracle must survive the reduction (a repo invariant)
        q.debug_sol = post.restrict(p.debug_sol)
        assert q.is_debug_sol_feas(atol=1e-5), \
            "presolve substitution killed the debug solution"
    return q, post
