"""Problem IR: variables, constraints, objective.

Reference: src/base/Problem.h:52 (mutation API), Variable.h, Constraint.h,
Objective.h.  The host-side Problem is a light mutable container; engines
consume an immutable *staged* view (engines/staging.py) where bounds and
linear parts are dense arrays ready to ship to device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.types import INF, FunctionType, ObjectiveType, ProblemType, VarType
from .expr import ExprGraph
from .functions import Function, LinearFunction, QuadraticFunction


class Variable:
    __slots__ = ("index", "lb", "ub", "vtype", "name")

    def __init__(self, index: int, lb: float, ub: float,
                 vtype: VarType = VarType.CONTINUOUS, name: str = ""):
        self.index = index
        self.lb = lb
        self.ub = ub
        self.vtype = VarType(vtype)
        self.name = name or f"x{index}"

    def is_integer(self) -> bool:
        return self.vtype in (VarType.BINARY, VarType.INTEGER,
                              VarType.IMPLBIN, VarType.IMPLINT)


class Constraint:
    __slots__ = ("index", "fun", "lb", "ub", "name")

    def __init__(self, index: int, fun: Function, lb: float, ub: float, name: str = ""):
        self.index = index
        self.fun = fun
        self.lb = lb
        self.ub = ub
        self.name = name or f"c{index}"

    def get_function_type(self) -> FunctionType:
        return self.fun.get_type()


class Objective:
    __slots__ = ("fun", "const", "sense", "name")

    def __init__(self, fun: Function, const: float = 0.0,
                 sense: ObjectiveType = ObjectiveType.MINIMIZE, name: str = "obj"):
        self.fun = fun
        self.const = const
        self.sense = ObjectiveType(sense)
        self.name = name

    def negate(self) -> None:
        """Convert max to min in place (reference: Objective.cpp negate)."""
        lf = self.fun.lf
        if lf:
            for v in list(lf.terms):
                lf.terms[v] = -lf.terms[v]
        qf = self.fun.qf
        if qf:
            for k in list(qf.terms):
                qf.terms[k] = -qf.terms[k]
        if self.fun.nlf is not None and self.fun.nlf.root >= 0:
            from ..ops.opcodes import Op
            g = self.fun.nlf
            g.set_root(g.node(Op.UMINUS, g.root))
        self.const = -self.const
        self.sense = ObjectiveType.MINIMIZE


class Problem:
    """Mutable MINLP container (reference: Problem.h:52)."""

    def __init__(self, name: str = "") -> None:
        self.name = name
        self.vars: List[Variable] = []
        self.cons: List[Constraint] = []
        self.obj: Optional[Objective] = None
        self.initial_point: Optional[np.ndarray] = None
        self.debug_sol: Optional[np.ndarray] = None
        self._sos1: List[tuple] = []   # (weights, var indices)
        self._sos2: List[tuple] = []

    # --------------------------------------------------------------- build
    def new_variable(self, lb: float = -INF, ub: float = INF,
                     vtype: VarType = VarType.CONTINUOUS, name: str = "") -> Variable:
        v = Variable(len(self.vars), lb, ub, vtype, name)
        self.vars.append(v)
        return v

    def new_constraint(self, fun: Function, lb: float, ub: float,
                       name: str = "") -> Constraint:
        c = Constraint(len(self.cons), fun, lb, ub, name)
        self.cons.append(c)
        return c

    def new_objective(self, fun: Function, const: float = 0.0,
                      sense: ObjectiveType = ObjectiveType.MINIMIZE) -> Objective:
        self.obj = Objective(fun, const, sense)
        if self.obj.sense == ObjectiveType.MAXIMIZE:
            self.obj.negate()
        return self.obj

    def change_bound(self, var_index: int, lb: float, ub: float) -> None:
        self.vars[var_index].lb = lb
        self.vars[var_index].ub = ub

    # ------------------------------------------------------------- queries
    @property
    def n_vars(self) -> int:
        return len(self.vars)

    @property
    def n_cons(self) -> int:
        return len(self.cons)

    def n_ints(self) -> int:
        return sum(1 for v in self.vars if v.is_integer())

    def int_indices(self) -> np.ndarray:
        return np.array([v.index for v in self.vars if v.is_integer()],
                        dtype=np.int32)

    def var_bounds(self) -> tuple:
        lb = np.array([v.lb for v in self.vars], dtype=np.float64)
        ub = np.array([v.ub for v in self.vars], dtype=np.float64)
        return lb, ub

    def find_type(self) -> ProblemType:
        """Classify (reference: Problem::findType Problem.h:180)."""
        has_int = any(v.is_integer() for v in self.vars)
        ftypes = {c.get_function_type() for c in self.cons}
        otype = (self.obj.fun.get_type() if self.obj else FunctionType.CONSTANT)
        if FunctionType.NONLINEAR in ftypes or otype == FunctionType.NONLINEAR:
            return ProblemType.MINLP if has_int else ProblemType.NLP
        if FunctionType.QUADRATIC in ftypes:
            return ProblemType.MIQCQP if has_int else ProblemType.QCQP
        if otype == FunctionType.QUADRATIC:
            return ProblemType.MIQP if has_int else ProblemType.QP
        return ProblemType.MILP if has_int else ProblemType.LP

    def is_linear(self) -> bool:
        return self.find_type() in (ProblemType.LP, ProblemType.MILP)

    # ---------------------------------------------------------- evaluation
    def eval_objective(self, x: np.ndarray) -> float:
        if self.obj is None:
            return 0.0
        return self.obj.fun.eval(x) + self.obj.const

    def eval_constraints(self, x: np.ndarray) -> np.ndarray:
        return np.array([c.fun.eval(x) for c in self.cons], dtype=np.float64)

    def is_feasible(self, x: np.ndarray, atol: float = 1e-6,
                    int_tol: float = 1e-6, rtol: float = None) -> bool:
        """Feasibility at x: bounds, integrality, rows.  Row tolerance is
        atol + rtol*|bound| (reference feasAbs_tol / feasRel_tol
        semantics; rtol defaults to atol for backward compatibility)."""
        if rtol is None:
            rtol = atol
        lb, ub = self.var_bounds()
        if np.any(x < lb - atol) or np.any(x > ub + atol):
            return False
        for v in self.vars:
            if v.is_integer() and abs(x[v.index] - round(x[v.index])) > int_tol:
                return False
        g = self.eval_constraints(x)
        for c, gi in zip(self.cons, g):
            if gi < c.lb - (atol + rtol * abs(c.lb)) or \
               gi > c.ub + (atol + rtol * abs(c.ub)):
                return False
        return True

    def is_debug_sol_feas(self, atol: float = 1e-6) -> bool:
        """debug_sol oracle (reference: Problem::isDebugSolFeas Problem.h:262)."""
        if self.debug_sol is None:
            return True
        return self.is_feasible(self.debug_sol, atol=atol)

    # ------------------------------------------------------------ printing
    def write_size(self, write) -> None:
        t = self.find_type()
        write(f"problem {self.name}: type={t.name} vars={self.n_vars} "
              f"(int={self.n_ints()}) cons={self.n_cons}\n")

    def __repr__(self) -> str:  # pragma: no cover
        return (f"Problem({self.name!r}, n={self.n_vars}, m={self.n_cons}, "
                f"type={self.find_type().name})")
