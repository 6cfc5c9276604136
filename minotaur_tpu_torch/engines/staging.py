"""Stage a Problem into dense arrays + torch callables.

Port of minotaur_tpu/engines/staging.py for the LP/QP slice: the fields of
`StagedProblem` are numpy arrays with the JAX package's names and layout,
so the tests can hand both packages the same staged problem
(`convert.staged_from_numpy`).  Quadratic and nonlinear constraint rows
(which become `nl_rows` in the JAX package) and nonlinear objectives
belong to the NL path and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..ir.problem import Problem

_NL_MSG = "nonlinear or quadratic constraint rows / nonlinear objective: " \
    "not yet ported, see ROADMAP.md"


@dataclasses.dataclass
class StagedProblem:
    """Immutable dense view of a Problem for the batched engines.

    Objective = c.x + x'Qobj x + obj_const; rows clb <= A x <= cub.
    `obj_nl`, `con_nl` and `nl_graphs` keep the JAX package's fields and
    are always empty in the slice (`nl_rows` has length 0).
    """

    name: str
    n: int
    m: int
    c: np.ndarray                       # (n,)
    obj_const: float
    Qobj: Optional[np.ndarray]          # (n, n) symmetric or None
    obj_nl: Optional[Callable]          # always None in the slice
    A: np.ndarray                       # (m, n) linear parts
    clb: np.ndarray                     # (m,)
    cub: np.ndarray                     # (m,)
    vlb: np.ndarray                     # (n,) root bounds
    vub: np.ndarray                     # (n,)
    int_mask: np.ndarray                # (n,) bool
    nl_rows: np.ndarray                 # indices of rows with nl/quad bodies
    con_nl: Optional[Callable]          # always None in the slice
    nl_graphs: List                     # always [] in the slice

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

        def f(x):
            val = x @ c
            if Q is not None:
                val = val + ((x @ Q.T) * x).sum(dim=-1)
            return val

        return f

    def constraint_fn(self, device="cpu") -> Callable:
        """Constraint bodies g(x) -> (..., m) as a torch callable."""
        A = torch.as_tensor(self.A, dtype=torch.float64, device=device)

        def g(x):
            return x @ A.T

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
        if (con.fun.qf is not None and len(con.fun.qf)) or \
                (con.fun.nlf is not None and con.fun.nlf.root >= 0):
            raise NotImplementedError(_NL_MSG)

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
        if p.obj.fun.nlf is not None and p.obj.fun.nlf.root >= 0:
            raise NotImplementedError(_NL_MSG)

    return StagedProblem(
        name=p.name, n=n, m=m, c=c, obj_const=obj_const, Qobj=Qobj,
        obj_nl=None, A=A, clb=clb, cub=cub, vlb=vlb, vub=vub,
        int_mask=int_mask, nl_rows=np.zeros(0, dtype=np.int32),
        con_nl=None, nl_graphs=[],
    )
