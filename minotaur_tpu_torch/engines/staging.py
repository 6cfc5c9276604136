"""Stage a Problem into dense arrays + torch callables.

Port of minotaur_tpu/engines/staging.py.  The fields of `StagedProblem`
are numpy arrays with the JAX package's names and layout, so the tests
can hand both packages the same staged problem
(`convert.staged_from_numpy`).  Constraint bodies are split: linear parts
in A (m, n); quadratic parts as per-row dense Q matrices and nonlinear
parts as expression graphs, together the rows `nl_rows`, evaluated by
`con_nl`; the objective is c.x + x'Qobj x + obj_nl(x) + obj_const.

The port keeps the data the callables are made from (`nl_Q`, `nl_body`,
`obj_graph`), so a staged problem can be carried across packages and
devices.  `obj_nl` and `con_nl` are staged torch code
(`ops/stage.py`) on a trailing variable axis: x (..., n) -> (...) and
(..., len(nl_rows)); each quadratic row's Q is moved to the device of x
on first use.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ir.expr import ExprGraph
from ..ir.problem import Problem
from ..ops.opcodes import Op
from ..ops.stage import stage_scalar


@dataclasses.dataclass
class StagedProblem:
    """Immutable dense view of a Problem for the batched engines.

    Objective = c.x + x'Qobj x + obj_nl(x) + obj_const; rows
    clb <= A x + [con_nl(x) on nl_rows] <= cub.  `nl_graphs` holds one
    graph per nl row for FBBT (`fbbt_graph`).
    """

    name: str
    n: int
    m: int
    c: np.ndarray                       # (n,)
    obj_const: float
    Qobj: Optional[np.ndarray]          # (n, n) symmetric or None
    obj_nl: Optional[Callable]          # staged scalar fn or None
    A: np.ndarray                       # (m, n) linear parts
    clb: np.ndarray                     # (m,)
    cub: np.ndarray                     # (m,)
    vlb: np.ndarray                     # (n,) root bounds
    vub: np.ndarray                     # (n,)
    int_mask: np.ndarray                # (n,) bool
    nl_rows: np.ndarray                 # indices of rows with nl/quad bodies
    con_nl: Optional[Callable]          # x -> (..., len(nl_rows)) values
    nl_graphs: List                     # ExprGraphs (quadratic rows get one)
    # what obj_nl and con_nl are staged from
    nl_Q: List = dataclasses.field(default_factory=list)     # per nl row
    nl_body: List = dataclasses.field(default_factory=list)  # per nl row
    obj_graph: Optional[object] = None

    # --------------------------------------------------------- properties
    @property
    def has_nl_objective(self) -> bool:
        return self.obj_nl is not None or self.Qobj is not None

    @property
    def is_lp_relaxable(self) -> bool:
        return len(self.nl_rows) == 0 and not self.has_nl_objective

    def objective_fn(self, device="cpu") -> Callable:
        """Objective without the constant, as a torch callable on
        (..., n) float64 tensors."""
        c = torch.as_tensor(self.c, dtype=torch.float64, device=device)
        Q = None if self.Qobj is None else torch.as_tensor(
            self.Qobj, dtype=torch.float64, device=device)
        nl = self.obj_nl

        def f(x):
            val = x @ c
            if Q is not None:
                val = val + ((x @ Q.T) * x).sum(dim=-1)
            if nl is not None:
                val = val + nl(x)
            return val

        return f

    def constraint_fn(self, device="cpu") -> Callable:
        """Full constraint body g(x) -> (..., m): linear + nonlinear."""
        A = torch.as_tensor(self.A, dtype=torch.float64, device=device)
        rows = torch.as_tensor(self.nl_rows, dtype=torch.long, device=device)
        nl = self.con_nl

        def g(x):
            vals = x @ A.T
            if nl is not None and len(self.nl_rows):
                vals = vals.index_add(-1, rows, nl(x))
            return vals

        return g


def _quad_to_dense(qf, n: int) -> np.ndarray:
    """QuadraticFunction -> symmetric dense Q with x'Qx == qf(x)."""
    Q = np.zeros((n, n), dtype=np.float64)
    for (i, j), coef in qf.terms.items():
        if i == j:
            Q[i, i] += coef
        else:
            Q[i, j] += coef / 2.0
            Q[j, i] += coef / 2.0
    return Q


def _quad_form(Q: np.ndarray) -> Callable:
    """x -> x'Qx on a trailing axis (the JAX body x @ (Q @ x)), with Q
    moved to x's device and dtype on first use."""
    on = {}

    def f(x):
        key = (x.device, x.dtype)
        Qt = on.get(key)
        if Qt is None:
            Qt = on[key] = torch.as_tensor(Q, dtype=x.dtype, device=x.device)
        return (x * (x @ Qt.T)).sum(dim=-1)

    return f


def _graph_sum(g1, g2) -> ExprGraph:
    """One graph of g1 + g2 (g2's nodes appended to a copy of g1)."""
    g = g1.clone()
    op, arg1, arg2, const, var = g2.tables
    remap = {}
    for i in range(len(op)):
        o = Op(op[i])
        if o is Op.NUM:
            remap[i] = g.num(const[i])
        elif o is Op.VAR:
            remap[i] = g.var(int(var[i]))
        else:
            remap[i] = g._push(o, remap[arg1[i]] if arg1[i] >= 0 else -1,
                               remap[arg2[i]] if arg2[i] >= 0 else -1,
                               float(const[i]), -1)
    g.set_root(g.node(Op.PLUS, g.root, remap[g2.root]))
    return g


def fbbt_graph(fun):
    """The graph FBBT and `nl_coef_improve` bound for a row body's
    nonlinear part: its quadratic part's graph, its expression graph, or
    (with both) one graph of their sum.  The JAX package gives a row
    with both parts the quadratic graph alone, which bounds the wrong
    function (ROADMAP.md, Queue 3); no suite row has both."""
    qf = fun.qf if fun.qf is not None and len(fun.qf) else None
    nlf = fun.nlf if fun.nlf is not None and fun.nlf.root >= 0 else None
    if qf is not None and nlf is not None:
        return _graph_sum(qf.to_expr_graph(), nlf)
    return qf.to_expr_graph() if qf is not None else nlf


def nl_callables(nl_Q: List, nl_body: List, obj_graph):
    """(obj_nl, con_nl) staged from the per-row quadratic matrices and
    body graphs and the objective's graph (either may be None)."""
    fns = []
    for Q, g in zip(nl_Q, nl_body):
        parts = []
        if Q is not None:
            parts.append(_quad_form(Q))
        if g is not None:
            parts.append(stage_scalar(g))
        fns.append(parts[0] if len(parts) == 1 else
                   (lambda x, p=tuple(parts): p[0](x) + p[1](x)))
    con_nl = None
    if fns:
        def con_nl(x, fns=tuple(fns)):
            return torch.stack([f(x) for f in fns], dim=-1)
    obj_nl = None if obj_graph is None else stage_scalar(obj_graph)
    return obj_nl, con_nl


def nl_parts(p) -> tuple:
    """The nonlinear state of a Problem (either package's): per row with
    a quadratic or nonlinear body, its index, dense Q (or None), body
    graph (or None) and FBBT graph; and the objective's graph (or None)."""
    rows, nl_Q, nl_body, graphs = [], [], [], []
    for i, con in enumerate(p.cons):
        Q = g = None
        if con.fun.qf is not None and len(con.fun.qf):
            Q = _quad_to_dense(con.fun.qf, p.n_vars)
        if con.fun.nlf is not None and con.fun.nlf.root >= 0:
            g = con.fun.nlf
        if Q is not None or g is not None:
            rows.append(i)
            nl_Q.append(Q)
            nl_body.append(g)
            graphs.append(fbbt_graph(con.fun))
    obj = None
    if p.obj is not None and p.obj.fun.nlf is not None and \
            p.obj.fun.nlf.root >= 0:
        obj = p.obj.fun.nlf
    return rows, nl_Q, nl_body, graphs, obj


def stage_problem(p: Problem) -> StagedProblem:
    n, m = p.n_vars, p.n_cons
    vlb, vub = p.var_bounds()
    int_mask = np.zeros(n, dtype=bool)
    int_mask[p.int_indices()] = True

    A = np.zeros((m, n), dtype=np.float64)
    clb = np.empty(m)
    cub = np.empty(m)
    for i, con in enumerate(p.cons):
        if con.fun.lf:
            for v, coef in con.fun.lf:
                A[i, v] = coef
        clb[i], cub[i] = con.lb, con.ub
    nl_rows, nl_Q, nl_body, nl_graphs, obj_graph = nl_parts(p)

    c = np.zeros(n)
    obj_const = 0.0
    Qobj = None
    if p.obj is not None:
        obj_const = p.obj.const
        if p.obj.fun.lf:
            for v, coef in p.obj.fun.lf:
                c[v] = coef
        if p.obj.fun.qf is not None and len(p.obj.fun.qf):
            Qobj = _quad_to_dense(p.obj.fun.qf, n)
    obj_nl, con_nl = nl_callables(nl_Q, nl_body, obj_graph)

    return StagedProblem(
        name=p.name, n=n, m=m, c=c, obj_const=obj_const, Qobj=Qobj,
        obj_nl=obj_nl, A=A, clb=clb, cub=cub, vlb=vlb, vub=vub,
        int_mask=int_mask, nl_rows=np.asarray(nl_rows, dtype=np.int32),
        con_nl=con_nl, nl_graphs=nl_graphs, nl_Q=nl_Q, nl_body=nl_body,
        obj_graph=obj_graph,
    )
