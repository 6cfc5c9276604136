"""Function objects: linear + quadratic + nonlinear parts.

Reference decomposition: a Function is lf + qf + nlf
(reference: src/base/Function.h:237-243); we keep that split because the
whole solver stack exploits it — linear parts become rows of a dense A
matrix on device, quadratic parts become (i, j, coef) triples, and only
true nonlinearities pay for DAG staging.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..utils.types import FunctionType
from .expr import ExprGraph


class LinearFunction:
    """var index -> coefficient (reference: src/base/LinearFunction.h)."""

    __slots__ = ("terms",)

    def __init__(self, terms: Optional[Dict[int, float]] = None):
        self.terms: Dict[int, float] = dict(terms) if terms else {}

    def add_term(self, var: int, coef: float) -> None:
        c = self.terms.get(var, 0.0) + coef
        if c == 0.0:
            self.terms.pop(var, None)
        else:
            self.terms[var] = c

    def get_weight(self, var: int) -> float:
        return self.terms.get(var, 0.0)

    def eval(self, x: np.ndarray) -> float:
        return float(sum(c * x[v] for v, c in self.terms.items()))

    def dense(self, n: int) -> np.ndarray:
        out = np.zeros(n, dtype=np.float64)
        for v, c in self.terms.items():
            out[v] = c
        return out

    def copy(self) -> "LinearFunction":
        return LinearFunction(self.terms)

    def __len__(self) -> int:
        return len(self.terms)

    def __iter__(self):
        return iter(self.terms.items())


class QuadraticFunction:
    """(i, j) -> coefficient with i <= j; value is sum coef * x_i * x_j
    (reference: src/base/QuadraticFunction.h)."""

    __slots__ = ("terms",)

    def __init__(self, terms: Optional[Dict[Tuple[int, int], float]] = None):
        self.terms: Dict[Tuple[int, int], float] = dict(terms) if terms else {}

    def add_term(self, i: int, j: int, coef: float) -> None:
        key = (i, j) if i <= j else (j, i)
        c = self.terms.get(key, 0.0) + coef
        if c == 0.0:
            self.terms.pop(key, None)
        else:
            self.terms[key] = c

    def eval(self, x: np.ndarray) -> float:
        return float(sum(c * x[i] * x[j] for (i, j), c in self.terms.items()))

    def eval_gradient(self, x: np.ndarray, grad: np.ndarray) -> None:
        for (i, j), c in self.terms.items():
            if i == j:
                grad[i] += 2.0 * c * x[i]
            else:
                grad[i] += c * x[j]
                grad[j] += c * x[i]

    def vars_used(self) -> Iterable[int]:
        s = set()
        for (i, j) in self.terms:
            s.add(i)
            s.add(j)
        return s

    def copy(self) -> "QuadraticFunction":
        return QuadraticFunction(self.terms)

    def __len__(self) -> int:
        return len(self.terms)

    def to_expr_graph(self) -> ExprGraph:
        from ..ops.opcodes import Op
        g = ExprGraph()
        parts = []
        for (i, j), c in sorted(self.terms.items()):
            if i == j:
                t = g.node(Op.SQR, g.var(i))
            else:
                t = g.node(Op.MULT, g.var(i), g.var(j))
            parts.append(g.node(Op.MULT, g.num(c), t))
        g.set_root(g.sum_list(parts) if parts else g.num(0.0))
        return g


class Function:
    """lf + qf + nlf composite (reference: Function.h:237-243)."""

    __slots__ = ("lf", "qf", "nlf")

    def __init__(self, lf: Optional[LinearFunction] = None,
                 qf: Optional[QuadraticFunction] = None,
                 nlf: Optional[ExprGraph] = None):
        self.lf = lf
        self.qf = qf
        self.nlf = nlf

    # ------------------------------------------------------------- queries
    def get_type(self) -> FunctionType:
        if self.nlf is not None and len(self.nlf) > 0 and not self._nl_is_constant():
            return FunctionType.NONLINEAR
        if self.qf is not None and len(self.qf) > 0:
            return FunctionType.QUADRATIC
        if self.lf is not None and len(self.lf) > 0:
            return FunctionType.LINEAR
        return FunctionType.CONSTANT

    def _nl_is_constant(self) -> bool:
        return self.nlf is not None and len(self.nlf.vars_used()) == 0

    def is_linear_in(self, var: int) -> bool:
        if self.nlf is not None and var in self.nlf.vars_used():
            return False
        if self.qf is not None and var in self.qf.vars_used():
            return False
        return True

    def vars_used(self) -> set:
        s = set()
        if self.lf:
            s.update(self.lf.terms.keys())
        if self.qf:
            s.update(self.qf.vars_used())
        if self.nlf is not None:
            s.update(int(v) for v in self.nlf.vars_used())
        return s

    # ---------------------------------------------------------------- eval
    def eval(self, x: np.ndarray) -> float:
        val = 0.0
        if self.lf:
            val += self.lf.eval(x)
        if self.qf:
            val += self.qf.eval(x)
        if self.nlf is not None and self.nlf.root >= 0:
            val += self.nlf.eval_np(x)
        return val

    def copy(self) -> "Function":
        return Function(
            self.lf.copy() if self.lf else None,
            self.qf.copy() if self.qf else None,
            self.nlf.clone() if self.nlf is not None else None,
        )
