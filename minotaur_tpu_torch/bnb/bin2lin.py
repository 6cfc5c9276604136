"""Binary-product linearization (exact MIQP -> MILP reformulation).

Reference: NlPresHandler's bin2Lin presolve (NlPresHandler.cpp:424) —
products involving binaries admit an EXACT linear reformulation with one
auxiliary variable per distinct product:

    y = xb * xc,  xb binary:
      xb^2        -> xb                     (no aux needed)
      bin * bin   -> y <= xb, y <= xc, y >= xb + xc - 1, y in [0, 1]
      bin * cont  -> y <= U xb, y >= L xb,
                     y <= xc - L (1 - xb), y >= xc - U (1 - xb)
                     (xc in [L, U] finite)

When every quadratic term is linearizable the MIQP becomes an MILP: the
B&B tree then runs on pure LP relaxations with certified dual bounds —
on TPU that also moves the node superstep onto the cheaper LP path.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..ir.functions import Function, LinearFunction, QuadraticFunction
from ..ir.problem import Problem
from ..utils.types import INF, VarType


def _has_nlf(p: Problem) -> bool:
    if p.obj and p.obj.fun.nlf is not None and p.obj.fun.nlf.root >= 0:
        return True
    return any(c.fun.nlf is not None and c.fun.nlf.root >= 0
               for c in p.cons)


def binary_products_to_linear(p: Problem) -> Optional[Tuple[Problem, int]]:
    """Return (milp, n_orig) when every quadratic term involves a binary
    (and its partner has finite bounds); None when not applicable.
    The first n_orig variables of the MILP are the original variables."""
    if _has_nlf(p):
        return None
    vlb, vub = p.var_bounds()
    is_bin = np.zeros(p.n_vars, dtype=bool)
    is_bin[p.int_indices()] = True
    is_bin &= (vlb >= -1e-12) & (vub <= 1.0 + 1e-12)

    def linearizable(qf) -> bool:
        for (i, j) in qf.terms:
            if i == j:
                if not is_bin[i]:
                    return False
            elif is_bin[i]:
                if not (is_bin[j] or (np.isfinite(vlb[j]) and
                                      np.isfinite(vub[j]))):
                    return False
            elif is_bin[j]:
                if not (np.isfinite(vlb[i]) and np.isfinite(vub[i])):
                    return False
            else:
                return False
        return True

    quads = [c.fun.qf for c in p.cons if c.fun.qf and len(c.fun.qf)]
    if p.obj and p.obj.fun.qf and len(p.obj.fun.qf):
        quads.append(p.obj.fun.qf)
    if not quads or not all(linearizable(q) for q in quads):
        return None

    out = Problem(p.name + "-bin2lin")
    for v in range(p.n_vars):
        out.new_variable(vlb[v], vub[v], p.vars[v].vtype,
                         name=p.vars[v].name)
    aux: Dict[Tuple[int, int], int] = {}
    aux_rows = []   # deferred (lf_dict, lb, ub)

    def y_of(i: int, j: int) -> Optional[int]:
        """Aux column for x_i x_j, or None when the term is x_bin^2 == x."""
        if i == j:
            return None
        key = (i, j) if i <= j else (j, i)
        hit = aux.get(key)
        if hit is not None:
            return hit
        bi, bj = is_bin[i], is_bin[j]
        if bi and bj:
            y = out.new_variable(0.0, 1.0).index
            aux_rows.append(({y: 1.0, i: -1.0}, -INF, 0.0))   # y <= xi
            aux_rows.append(({y: 1.0, j: -1.0}, -INF, 0.0))   # y <= xj
            aux_rows.append(({y: 1.0, i: -1.0, j: -1.0}, -1.0, INF))
        else:
            xb, xc = (i, j) if bi else (j, i)
            L, U = vlb[xc], vub[xc]
            # y = xb*xc in [min(L,0), max(U,0)]
            y = out.new_variable(min(L, 0.0), max(U, 0.0)).index
            aux_rows.append(({y: 1.0, xb: -U}, -INF, 0.0))     # y <= U xb
            aux_rows.append(({y: 1.0, xb: -L}, 0.0, INF))      # y >= L xb
            # y <= xc - L(1-xb)  <=>  y - xc - L xb <= -L
            aux_rows.append(({y: 1.0, xc: -1.0, xb: -L}, -INF, -L))
            # y >= xc - U(1-xb)  <=>  y - xc - U xb >= -U
            aux_rows.append(({y: 1.0, xc: -1.0, xb: -U}, -U, INF))
        aux[key] = y
        return y

    def rewrite(fun: Function) -> Function:
        lf = dict(fun.lf.terms) if fun.lf else {}
        if fun.qf and len(fun.qf):
            for (i, j), coef in fun.qf.terms.items():
                y = y_of(i, j)
                col = i if y is None else y     # x_bin^2 == x_bin
                lf[col] = lf.get(col, 0.0) + coef
        return Function(lf=LinearFunction(lf) if lf else None)

    for c in p.cons:
        out.new_constraint(rewrite(c.fun), c.lb, c.ub, name=c.name)
    obj_fun = rewrite(p.obj.fun) if p.obj else None
    for lf_dict, lb, ub in aux_rows:
        out.new_constraint(Function(lf=LinearFunction(lf_dict)), lb, ub)
    if obj_fun is not None:
        out.new_objective(obj_fun, const=p.obj.const)
    out._sos1 = list(p._sos1)
    out._sos2 = list(p._sos2)
    if p.debug_sol is not None:
        ds = np.zeros(out.n_vars)
        ds[:p.n_vars] = p.debug_sol
        for (i, j), y in aux.items():
            ds[y] = p.debug_sol[i] * p.debug_sol[j]
        out.debug_sol = ds
    if p.initial_point is not None:
        x0 = np.zeros(out.n_vars)
        x0[:p.n_vars] = p.initial_point
        for (i, j), y in aux.items():
            x0[y] = p.initial_point[i] * p.initial_point[j]
        out.initial_point = x0
    return out, p.n_vars
