"""Emit a Problem as a text-format .nl file.

Reference: src/base/NlWriter.{h,cpp} (NlWriter.cpp uses
CGraph::getNlString).  Round-trips through io/nl_reader.py.
"""

from __future__ import annotations

from typing import Dict, List, TextIO

import numpy as np

from ..ir.expr import ExprGraph
from ..ir.problem import Problem
from ..ops.opcodes import Op
from ..utils.types import INF, ObjectiveType, VarType

# our Op -> ASL text opcode
_OP2ASL = {
    Op.PLUS: 0, Op.MINUS: 1, Op.MULT: 2, Op.DIV: 3, Op.REM: 4, Op.POW: 5,
    Op.LESS: 6, Op.FLOOR: 13, Op.CEIL: 14, Op.ABS: 15, Op.UMINUS: 16,
    Op.TANH: 37, Op.TAN: 38, Op.SQRT: 39, Op.SINH: 40, Op.SIN: 41,
    Op.LOG10: 42, Op.LOG: 43, Op.EXP: 44, Op.COSH: 45, Op.COS: 46,
    Op.ATANH: 47, Op.ATAN2: 48, Op.ATAN: 49, Op.ASINH: 50, Op.ASIN: 51,
    Op.ACOSH: 52, Op.ACOS: 53, Op.INTDIV: 55, Op.MAX2: 12, Op.MIN2: 11,
}


def _write_expr(g: ExprGraph, node: int, out: List[str]) -> None:
    op, a1, a2, const, var = g.tables
    o = Op(op[node])
    if o is Op.NUM:
        out.append(f"n{const[node]:.17g}")
    elif o is Op.VAR:
        out.append(f"v{var[node]}")
    elif o is Op.SQR:
        out.append("o5")
        _write_expr(g, a1[node], out)
        out.append("n2")
    elif o is Op.POWK:
        out.append("o5")
        _write_expr(g, a1[node], out)
        out.append(f"n{const[node]:.17g}")
    elif o is Op.CPOW:
        out.append("o5")
        out.append(f"n{const[node]:.17g}")
        _write_expr(g, a1[node], out)
    elif o in (Op.MAX2, Op.MIN2):
        out.append(f"o{_OP2ASL[o]}")
        out.append("2")
        _write_expr(g, a1[node], out)
        _write_expr(g, a2[node], out)
    else:
        out.append(f"o{_OP2ASL[o]}")
        _write_expr(g, a1[node], out)
        if a2[node] >= 0:
            _write_expr(g, a2[node], out)


def _bound_line(lo: float, hi: float) -> str:
    if lo <= -INF and hi >= INF:
        return "3"
    if lo <= -INF:
        return f"1 {hi:.17g}"
    if hi >= INF:
        return f"2 {lo:.17g}"
    if lo == hi:
        return f"4 {lo:.17g}"
    return f"0 {lo:.17g} {hi:.17g}"


def write_nl(p: Problem, path: str) -> None:
    """Writes p as text .nl.  Quadratic parts are emitted as expression
    trees (readers with quadratic extraction recover them)."""
    n, m = p.n_vars, p.n_cons

    def body_graph(fun) -> ExprGraph:
        if fun.qf is not None and len(fun.qf):
            g = fun.qf.to_expr_graph()
            if fun.nlf is not None and fun.nlf.root >= 0:
                # merge quadratic and nonlinear parts into one graph
                g2 = ExprGraph()

                def emit(src: ExprGraph, node: int) -> int:
                    op, a1, a2, const, var = src.tables
                    o = Op(op[node])
                    if o is Op.NUM:
                        return g2.num(const[node])
                    if o is Op.VAR:
                        return g2.var(var[node])
                    x1 = emit(src, a1[node]) if a1[node] >= 0 else -1
                    x2 = emit(src, a2[node]) if a2[node] >= 0 else -1
                    return g2.node(o, x1, x2, const[node])
                r1 = emit(g, g.root)
                r2 = emit(fun.nlf, fun.nlf.root)
                g2.set_root(g2.node(Op.PLUS, r1, r2))
                return g2
            return g
        if fun.nlf is not None and fun.nlf.root >= 0:
            return fun.nlf
        g = ExprGraph()
        g.set_root(g.num(0.0))
        return g

    con_graphs = [body_graph(c.fun) for c in p.cons]
    obj_graph = body_graph(p.obj.fun) if p.obj else None
    if obj_graph is not None and p.obj.const != 0.0:
        # fold the objective constant back into the O expression
        obj_graph = obj_graph.clone()
        obj_graph.set_root(obj_graph.node(
            Op.PLUS, obj_graph.root, obj_graph.num(p.obj.const)))
    nlc = sum(1 for c in p.cons
              if c.fun.get_type().name in ("QUADRATIC", "NONLINEAR",
                                           "POLYNOMIAL"))
    nlo = 1 if (p.obj and p.obj.fun.get_type().name in
                ("QUADRATIC", "NONLINEAR", "POLYNOMIAL")) else 0

    # variable ordering: we write variables in their existing order and
    # declare all of them "nonlinear in both" when any nonlinearity
    # exists; integer layout must then use nlvbi. Simplest correct choice:
    # treat all vars as nonlinear-in-both only if they appear nonlinearly
    # is required by readers to type them; instead we emit a fully LINEAR
    # header layout when possible, else fall back to re-ordering... To
    # keep round-trips exact we require integer vars to already be at the
    # positions the header implies; the general remap is future work.
    int_count = sum(1 for v in p.vars if v.is_integer())
    nl_vars = set()
    for g in con_graphs + ([obj_graph] if obj_graph else []):
        if g is not None:
            nl_vars.update(int(v) for v in g.vars_used())

    n_eqns = sum(1 for c in p.cons if c.lb == c.ub)
    jac_entries = []
    for c in p.cons:
        ents = sorted(c.fun.lf.terms.items()) if c.fun.lf else []
        jac_entries.append(ents)
    nzc = sum(len(e) for e in jac_entries)
    grad_entries = sorted((v, co) for v, co in p.obj.fun.lf.terms.items()) \
        if (p.obj and p.obj.fun.lf) else []

    with open(path, "w") as fh:
        fh.write(f"g3 0 1 0\t# problem {p.name}\n")
        fh.write(f" {n} {m} 1 0 {n_eqns}\n")
        fh.write(f" {nlc} {nlo}\n")
        fh.write(" 0 0\n")
        nv = len(nl_vars)
        fh.write(f" {nv} {nv} {nv}\n")
        fh.write(" 0 0 0 1\n")
        # integer typing: the .nl layout can only express integers as a
        # suffix of the nonlinear block (nlvbi) and binary/integer
        # suffixes of the linear block (nbv/niv); emit what fits that
        # shape, which covers instances read from .nl in the first place
        nlvbi = 0
        if nl_vars == set(range(nv)):
            while nlvbi < nv and p.vars[nv - 1 - nlvbi].is_integer():
                nlvbi += 1
        k = n
        niv = 0
        while k > 0 and (k - 1) not in nl_vars and \
                p.vars[k - 1].vtype == VarType.INTEGER:
            niv += 1
            k -= 1
        nbv = 0
        while k > 0 and (k - 1) not in nl_vars and \
                p.vars[k - 1].vtype == VarType.BINARY:
            nbv += 1
            k -= 1
        fh.write(f" {nbv} {niv} {nlvbi} 0 0\n")
        fh.write(f" {nzc} {len(grad_entries)}\n")
        fh.write(" 0 0\n")
        fh.write(" 0 0 0 0 0\n")
        for i, g in enumerate(con_graphs):
            fh.write(f"C{i}\n")
            toks: List[str] = []
            _write_expr(g, g.root, toks)
            fh.write("\n".join(toks) + "\n")
        if obj_graph is not None:
            fh.write("O0 0\n")
            toks = []
            _write_expr(obj_graph, obj_graph.root, toks)
            fh.write("\n".join(toks) + "\n")
        fh.write("r\n")
        for c in p.cons:
            fh.write(_bound_line(c.lb, c.ub) + "\n")
        fh.write("b\n")
        for v in p.vars:
            fh.write(_bound_line(v.lb, v.ub) + "\n")
        for i, ents in enumerate(jac_entries):
            if ents:
                fh.write(f"J{i} {len(ents)}\n")
                for v, co in ents:
                    fh.write(f"{v} {co:.17g}\n")
        if grad_entries:
            fh.write(f"G0 {len(grad_entries)}\n")
            for v, co in grad_entries:
                fh.write(f"{v} {co:.17g}\n")
