"""Perspective reformulation: detection + perspective cuts.

Reference: PerspCon.{h,cpp} (detection of constraints controlled by a
binary "indicator"), PerspCutGenerator.{h,cpp} and PerspCutHandler
(perspective cuts), NlPresHandler perspective detect (:837).

Structure detected (conservative): a nonlinear row  g(x) <= c  whose
variables are ALL semi-continuous on the SAME binary z — i.e. for every
variable v of the row there are linear rows forcing  v <= ub_v * z  and
v >= lb_v * z  (so z = 0 fixes the row's variables at 0).  For convex g
with g(0) <= c, the perspective  z * g(x/z) <= z * c  is the convex hull
of the on/off graph, and its linearization at any point u,

    grad_g(u) . x  +  (g(u) - grad_g(u) . u - c) * z  <=  0,

is globally valid (the perspective cut).  QG swaps these in for plain
gradient cuts on detected rows — strictly tighter at fractional z.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..engines.staging import StagedProblem

_INF = float("inf")


@dataclasses.dataclass
class PerspRow:
    k: int          # index into sp.nl_rows
    row: int        # row index in sp
    z: int          # controlling binary column
    vars: np.ndarray


def detect_perspective(sp: StagedProblem) -> List[PerspRow]:
    """Find nonlinear <=-rows whose variables are all zero-forced by one
    binary via linear indicator rows (reference PerspCon::detect)."""
    out: List[PerspRow] = []
    if not len(sp.nl_rows):
        return out
    n = sp.n
    is_bin = sp.int_mask & (sp.vlb >= -1e-9) & (sp.vub <= 1 + 1e-9)

    # indicator structure per (v, z), from 2-var rows normalized to
    # coefficient +1 on v:  v in [lo - czn*z, hi - czn*z]
    #   upper control (v <= u*z, u >= 0): finite hi <= 0 and czn < 0
    #   lower control (v >= l*z, l <= 0 with v >= 0 at z=0): finite
    #     lo >= 0 ... combined with czn arbitrary gives v >= lo - czn*z
    #     >= 0 at z = 0; the variable's own bound v >= 0 also qualifies
    ub_ctrl: Dict[int, set] = {}
    lb_ctrl: Dict[int, set] = {}
    nl_set = set(int(x) for x in sp.nl_rows)
    for r in range(sp.m):
        if r in nl_set:
            continue
        nz = np.nonzero(sp.A[r])[0]
        if len(nz) != 2:
            continue
        a, b = int(nz[0]), int(nz[1])
        for v, z in ((a, b), (b, a)):
            if not is_bin[z] or is_bin[v]:
                continue
            cv, cz = sp.A[r, v], sp.A[r, z]
            czn = cz / cv
            if cv > 0:
                lo = sp.clb[r] / cv if np.isfinite(sp.clb[r]) else -_INF
                hi = sp.cub[r] / cv if np.isfinite(sp.cub[r]) else _INF
            else:
                lo = sp.cub[r] / cv if np.isfinite(sp.cub[r]) else -_INF
                hi = sp.clb[r] / cv if np.isfinite(sp.clb[r]) else _INF
            if hi <= 1e-12 and czn < 0:
                ub_ctrl.setdefault(v, set()).add(z)
            if lo >= -1e-12:
                lb_ctrl.setdefault(v, set()).add(z)

    for k, r in enumerate(sp.nl_rows):
        r = int(r)
        if not (np.isfinite(sp.cub[r]) and not np.isfinite(sp.clb[r])):
            continue  # perspective cuts derived for <=-rows only
        g = sp.nl_graphs[k] if k < len(sp.nl_graphs) else None
        if g is None:
            continue
        vs = g.vars_used()
        lin_vs = np.nonzero(sp.A[r])[0]
        all_vs = np.unique(np.concatenate([vs, lin_vs])).astype(int)
        cands: Optional[set] = None
        ok = True
        for v in all_vs:
            if is_bin[v]:
                ok = False
                break
            zs = ub_ctrl.get(int(v), set()) & lb_ctrl.get(int(v), set())
            # lower side may come from the variable's own bound v >= 0
            if sp.vlb[v] >= -1e-12:
                zs = ub_ctrl.get(int(v), set())
            if not zs:
                ok = False
                break
            cands = zs if cands is None else (cands & zs)
            if not cands:
                ok = False
                break
        if not ok or not cands:
            continue
        z = sorted(cands)[0]
        # validity needs g(0) <= c: check by evaluation
        x0 = np.zeros(n)
        try:
            g0 = float(g.eval_np(x0)) + float(sp.A[r] @ x0)
        except Exception:
            continue
        if not np.isfinite(g0) or g0 > sp.cub[r] + 1e-9:
            continue
        out.append(PerspRow(k=k, row=r, z=int(z), vars=all_vs))
    return out


# ---------------------------------------------------------------- reform

def _persp_rebuild(g2, w, sources):
    """Rebuild source graphs into g2 with every VAR node v replaced by
    v / w (the perspective substitution of CGraph::getPersp,
    CGraph.cpp:757-969).  Returns the sum of the rebuilt roots."""
    from ..ir.expr import ExprGraph  # noqa: F401  (typing aid)
    from ..ops.opcodes import Op
    total = None
    for g in sources:
        memo = {}
        order = []
        stack = [g.root]
        seen = set()
        while stack:                      # iterative post-order
            i = stack.pop()
            if i in seen or i < 0:
                continue
            seen.add(i)
            order.append(i)
            stack.extend(a for a in (g._arg1[i], g._arg2[i]) if a >= 0)
        for i in sorted(order):           # children precede parents
            op = Op(g._op[i])
            if op is Op.NUM:
                memo[i] = g2.num(g._const[i])
            elif op is Op.VAR:
                memo[i] = g2.node(Op.DIV, g2.var(g._var[i]), w)
            else:
                a1 = memo.get(g._arg1[i], -1) if g._arg1[i] >= 0 else -1
                a2 = memo.get(g._arg2[i], -1) if g._arg2[i] >= 0 else -1
                memo[i] = g2._push(op, a1, a2, g._const[i], -1)
        r = memo[g.root]
        total = r if total is None else g2.node(Op.PLUS, total, r)
    return total


def perspective_reform(problem, eps: float = 1e-6) -> int:
    """Presolve-time perspective REFORMULATION (reference `persp_ref`:
    NlPresHandler::perspRef_ :837 + CGraph::getPersp).

    Every detected on/off row  lf(x) + G(x) <= ub  (all of G's variables
    zero-forced by one binary z, G(0) <= ub) is REWRITTEN in place as

        lf(x) + w * ( G(x/w) - ub ) <= 0,   w = eps + (1-eps) z ,

    the eps-smoothed perspective of the shifted body: exact at z=1,
    and at z=0 (row vars forced to 0) it evaluates to eps*(G(0)-ub)
    <= 0 — valid by the detection precondition.  The linear part is
    invariant under the perspective map (w * (a.(x/w)) == a.x) and
    stays outside the graph.  For convex G this is the convex-hull
    strengthening of the on/off set — strictly tighter than the
    McCormick-style big-M relaxation the plain row gives.

    Mutates `problem` (run BEFORE staging, like quad_cone_reform) and
    returns the number of rows reformulated."""
    from ..engines.staging import stage_problem
    from ..ir.expr import ExprGraph
    from ..ir.functions import Function
    from ..ops.opcodes import Op

    sp = stage_problem(problem)
    rows = detect_perspective(sp)
    n_ref = 0
    for pr in rows:
        con = problem.cons[pr.row]
        sources = []
        if con.fun.qf is not None:
            sources.append(con.fun.qf.to_expr_graph())
        if con.fun.nlf is not None:
            sources.append(con.fun.nlf)
        if not sources or not np.isfinite(con.ub):
            continue
        if any(pr.z in g.vars_used() for g in sources):
            continue                      # z inside G: not supported
        g2 = ExprGraph()
        w = g2.node(Op.PLUS, g2.num(eps),
                    g2.node(Op.MULT, g2.num(1.0 - eps), g2.var(pr.z)))
        sub = _persp_rebuild(g2, w, sources)
        body = g2.node(Op.MINUS, sub, g2.num(float(con.ub)))
        g2.set_root(g2.node(Op.MULT, w, body))
        con.fun = Function(lf=con.fun.lf, nlf=g2)
        con.ub = 0.0
        con.lb = -_INF
        n_ref += 1
    return n_ref
