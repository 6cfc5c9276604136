"""Carry staged state across from the JAX package.

`staged_from_numpy` builds the port's `StagedProblem` from the numpy
fields of a staged problem of either package (or of any dict with the
same names), so that both packages can be fed the same staged problem.
Nonlinear state travels as numpy too: per nl row its dense quadratic
matrix (`nl_Q`) and its body graph's tables (`nl_body`), the FBBT graphs
(`nl_graphs`) and the objective's graph (`obj_graph`), each graph as the
tables (op, arg1, arg2, const, var, root).  A JAX `StagedProblem` keeps
its bodies only as staged callables, so for it the nonlinear fields are
read from the `Problem` it was staged from (`staged_fields(sp, p)`).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from .engines.staging import StagedProblem, nl_callables, nl_parts
from .ir.expr import ExprGraph

FIELDS = ("n", "m", "c", "obj_const", "Qobj", "A", "clb", "cub", "vlb",
          "vub", "int_mask", "nl_rows")


def graph_tables(g) -> Optional[tuple]:
    """(op, arg1, arg2, const, var, root) of an ExprGraph of either
    package (copies), or None."""
    if g is None:
        return None
    return tuple(np.array(t) for t in g.tables) + (int(g.root),)


def graph_from_tables(t) -> Optional[ExprGraph]:
    """The port's ExprGraph with exactly the given tables (node indices
    kept, so orphan nodes survive as they were)."""
    if t is None:
        return None
    op, a1, a2, const, var, root = t
    g = ExprGraph()
    g._op = [int(v) for v in op]
    g._arg1 = [int(v) for v in a1]
    g._arg2 = [int(v) for v in a2]
    g._const = [float(v) for v in const]
    g._var = [int(v) for v in var]
    g._cache = {(g._op[i], g._arg1[i], g._arg2[i], g._const[i], g._var[i]): i
                for i in range(len(g._op))}
    g.root = int(root)
    return g


def staged_fields(sp, problem=None) -> dict:
    """The numpy fields of a staged problem (either package) as a dict.
    A JAX staged problem with nonlinear rows or objective needs the
    `problem` it was staged from (its bodies are closures there)."""
    out = {f: getattr(sp, f) for f in FIELDS}
    out["name"] = sp.name
    has_nl = len(sp.nl_rows) or sp.obj_nl is not None
    if hasattr(sp, "nl_Q"):                     # the port's own
        nl_Q, nl_body, graphs, obj = sp.nl_Q, sp.nl_body, sp.nl_graphs, \
            sp.obj_graph
    elif has_nl:
        if problem is None:
            raise ValueError("staged_fields: a JAX staged problem with "
                             "nonlinear parts needs the Problem it was "
                             "staged from")
        _, nl_Q, nl_body, graphs, obj = nl_parts(problem)
        if len(nl_Q) != len(sp.nl_rows):
            raise ValueError("staged_fields: problem does not match sp")
    else:
        nl_Q, nl_body, graphs, obj = [], [], [], None
    out["nl_Q"] = [None if Q is None else np.array(Q) for Q in nl_Q]
    out["nl_body"] = [graph_tables(g) for g in nl_body]
    out["nl_graphs"] = [graph_tables(g) for g in graphs]
    out["obj_graph"] = graph_tables(obj)
    return out


def staged_from_numpy(fields: Mapping, name: str = "staged") -> StagedProblem:
    """Port StagedProblem from numpy fields (copies every array)."""
    nl_rows = np.asarray(fields.get("nl_rows", ()), dtype=np.int32)
    n, m = int(fields["n"]), int(fields["m"])
    f64 = lambda a: np.array(a, dtype=np.float64)  # noqa: E731
    Q = fields.get("Qobj")
    nl_Q = [None if q is None else f64(q).reshape(n, n)
            for q in fields.get("nl_Q", ())]
    nl_body = [graph_from_tables(t) for t in fields.get("nl_body", ())]
    graphs = [graph_from_tables(t) for t in fields.get("nl_graphs", ())]
    obj_graph = graph_from_tables(fields.get("obj_graph"))
    if not (len(nl_Q) == len(nl_body) == len(graphs) == len(nl_rows)):
        raise ValueError("staged_from_numpy: nl_rows, nl_Q, nl_body and "
                         "nl_graphs must have one entry per nonlinear row")
    obj_nl, con_nl = nl_callables(nl_Q, nl_body, obj_graph)
    sp = StagedProblem(
        name=str(fields.get("name", name)), n=n, m=m, c=f64(fields["c"]),
        obj_const=float(fields["obj_const"]),
        Qobj=None if Q is None else f64(Q), obj_nl=obj_nl,
        A=f64(fields["A"]).reshape(m, n), clb=f64(fields["clb"]),
        cub=f64(fields["cub"]), vlb=f64(fields["vlb"]),
        vub=f64(fields["vub"]),
        int_mask=np.array(fields["int_mask"], dtype=bool),
        nl_rows=nl_rows, con_nl=con_nl, nl_graphs=graphs, nl_Q=nl_Q,
        nl_body=nl_body, obj_graph=obj_graph)
    for nm, v, shape in (("c", sp.c, (n,)), ("clb", sp.clb, (m,)),
                         ("cub", sp.cub, (m,)), ("vlb", sp.vlb, (n,)),
                         ("vub", sp.vub, (n,)), ("int_mask", sp.int_mask, (n,))):
        if v.shape != shape:
            raise ValueError(f"staged_from_numpy: {nm} has shape {v.shape}, "
                             f"expected {shape}")
    if sp.Qobj is not None and sp.Qobj.shape != (n, n):
        raise ValueError("staged_from_numpy: Qobj must be (n, n)")
    return sp
