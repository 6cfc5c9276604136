"""Nonlinear presolve transforms that REWRITE the problem (pre-staging).

Reference: NlPresHandler.{h,cpp}.  The array-level nonlinear passes
(bound tightening via interval FBBT, nl coefficient improvement) live in
bnb/presolve.py and run on the staged arrays; the transforms here change
EXPRESSION STRUCTURE and therefore run on the ir-level Problem before
stage_problem:

  quad_cone_reform — NlPresHandler::quadConeRef_ (:1135):
      sos(x) - M z <= K   (z binary, K >= 0, sos = sum of squares)
   -> sqrt(sos(x) + eps) + (sqrt(K+eps) - sqrt(K+M+eps)) z <= sqrt(K+eps)

  The rewritten row has the same integer-feasible set (z in {0,1}
  reproduces the two original cases exactly, up to the eps smoothing the
  reference also applies) but a TIGHTER continuous relaxation: sqrt of
  the big-M row bends toward the cone, cutting fractional-z points the
  original big-M row admits.
"""

from __future__ import annotations

import math

import numpy as np

from ..ir.functions import Function, LinearFunction
from ..ir.problem import Problem
from ..ops.opcodes import Op

_INF = float("inf")
_EPS = 1e-4


def _is_sum_of_squares(g) -> bool:
    """Conservative detector: the graph is a +-tree whose leaves are
    SQR/POWK(k=2) nodes or nonnegative-constant multiples of them
    (reference NonlinearFunction::isSumOfSquares)."""
    op = np.asarray(g._op)
    a1 = np.asarray(g._arg1)
    a2 = np.asarray(g._arg2)
    cs = np.asarray(g._const)

    def sos(i: int) -> bool:
        o = op[i]
        if o == Op.PLUS:
            return sos(a1[i]) and sos(a2[i])
        if o == Op.SQR:
            return True
        if o == Op.POWK and cs[i] == 2.0:
            return True
        if o == Op.MULT:
            # nonneg-const * sos (either side)
            if op[a1[i]] == Op.NUM and cs[a1[i]] >= 0.0:
                return sos(a2[i])
            if op[a2[i]] == Op.NUM and cs[a2[i]] >= 0.0:
                return sos(a1[i])
            return False
        return False

    return g.root >= 0 and bool(sos(int(g.root)))


def quad_cone_reform(problem: Problem, int_tol: float = 1e-6) -> int:
    """Apply quadConeRef_ to every matching constraint in place.
    Returns the number of rows rewritten."""
    changed = 0
    for con in problem.cons:
        K = con.ub
        if not np.isfinite(K) or K < 0.0 or np.isfinite(con.lb):
            continue
        f = con.fun
        if f.nlf is None or f.nlf.root < 0:
            continue
        if f.qf is not None and len(f.qf):
            continue
        if f.lf is None or len(f.lf.terms) != 1:
            continue
        (z, a0), = f.lf.terms.items()
        v = problem.vars[z]
        is_bin = v.is_integer() and v.lb >= -int_tol and v.ub <= 1 + int_tol
        if not is_bin:
            continue
        M = -a0
        if K + M < 0.0:
            # sqrt(K+M+eps) undefined; the z=1 case is then infeasible
            # and better handled by bound tightening
            continue
        if not _is_sum_of_squares(f.nlf):
            continue
        g2 = f.nlf.clone()
        g2.root = g2.node(Op.SQRT,
                          g2.node(Op.PLUS, g2.root, g2.num(_EPS)))
        con.fun = Function(
            lf=LinearFunction({z: math.sqrt(K + _EPS) -
                               math.sqrt(K + M + _EPS)}),
            nlf=g2)
        con.lb = -_INF
        con.ub = math.sqrt(K + _EPS)
        changed += 1
    if changed and problem.debug_sol is not None:
        assert problem.is_feasible(np.asarray(problem.debug_sol),
                                   atol=1e-5, int_tol=_INF), \
            "quad-cone reformulation cut off the debug solution"
    return changed
