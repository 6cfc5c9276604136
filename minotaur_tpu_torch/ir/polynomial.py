"""Monomial / polynomial algebra.

Reference: PolynomialFunction.{h,cpp} (MonomialFunction + polynomial
arithmetic, used by TransPoly and examples) and CGraph->polynomial
extraction.

A monomial is coef * prod_i x_i^p_i with integer powers p_i >= 1, stored
as a canonical sorted tuple ((var, pow), ...).  A polynomial is a dict
monomial-key -> coef plus a constant.  Conversion both ways: polynomials
stage to ExprGraphs for the device path, and expression DAGs that are
polynomial (PLUS/MINUS/MULT/SQR/POWK/NUM/VAR over integer powers) extract
back to polynomials (the TransPoly direction).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from ..ops.opcodes import Op
from .expr import ExprGraph

MonoKey = Tuple[Tuple[int, int], ...]   # ((var, power), ...) sorted by var


def _mono_mul(a: MonoKey, b: MonoKey) -> MonoKey:
    pows: Dict[int, int] = {}
    for v, p in a:
        pows[v] = pows.get(v, 0) + p
    for v, p in b:
        pows[v] = pows.get(v, 0) + p
    return tuple(sorted((v, p) for v, p in pows.items() if p != 0))


def _mono_pow(a: MonoKey, k: int) -> MonoKey:
    return tuple((v, p * k) for v, p in a)


class PolynomialFunction:
    """sum_m coef_m * monomial_m + const (reference PolynomialFunction)."""

    __slots__ = ("terms", "const")

    def __init__(self, terms: Optional[Dict[MonoKey, float]] = None,
                 const: float = 0.0):
        self.terms: Dict[MonoKey, float] = dict(terms or {})
        self.const = float(const)
        self._clean()

    def _clean(self) -> None:
        self.terms = {k: v for k, v in self.terms.items()
                      if abs(v) > 1e-300 and k}

    # ------------------------------------------------------------ algebra
    @classmethod
    def constant(cls, c: float) -> "PolynomialFunction":
        return cls({}, c)

    @classmethod
    def variable(cls, v: int, coef: float = 1.0) -> "PolynomialFunction":
        return cls({((int(v), 1),): float(coef)})

    @classmethod
    def monomial(cls, coef: float, powers: Iterable[Tuple[int, int]]
                 ) -> "PolynomialFunction":
        key = tuple(sorted((int(v), int(p)) for v, p in powers if p))
        return cls({key: float(coef)} if key else {},
                   float(coef) if not key else 0.0)

    def __add__(self, other) -> "PolynomialFunction":
        if isinstance(other, (int, float)):
            return PolynomialFunction(self.terms, self.const + other)
        t = dict(self.terms)
        for k, v in other.terms.items():
            t[k] = t.get(k, 0.0) + v
        return PolynomialFunction(t, self.const + other.const)

    def __sub__(self, other) -> "PolynomialFunction":
        return self + (other * -1.0 if isinstance(other, PolynomialFunction)
                       else -other)

    def __mul__(self, other) -> "PolynomialFunction":
        if isinstance(other, (int, float)):
            return PolynomialFunction(
                {k: v * other for k, v in self.terms.items()},
                self.const * other)
        t: Dict[MonoKey, float] = {}
        const = self.const * other.const
        for k1, v1 in self.terms.items():
            for k2, v2 in other.terms.items():
                k = _mono_mul(k1, k2)
                t[k] = t.get(k, 0.0) + v1 * v2
            if other.const:
                t[k1] = t.get(k1, 0.0) + v1 * other.const
        if self.const:
            for k2, v2 in other.terms.items():
                t[k2] = t.get(k2, 0.0) + self.const * v2
        return PolynomialFunction(t, const)

    __rmul__ = __mul__
    __radd__ = __add__

    def power(self, k: int) -> "PolynomialFunction":
        if k < 0 or k != int(k):
            raise ValueError("polynomial powers must be nonneg integers")
        out = PolynomialFunction.constant(1.0)
        base = self
        k = int(k)
        while k:
            if k & 1:
                out = out * base
            base = base * base
            k >>= 1
        return out

    # ------------------------------------------------------------ queries
    def degree(self) -> int:
        return max((sum(p for _, p in k) for k in self.terms), default=0)

    def vars_used(self) -> np.ndarray:
        vs = sorted({v for k in self.terms for v, _ in k})
        return np.asarray(vs, dtype=np.int32)

    def __len__(self) -> int:
        return len(self.terms)

    def eval(self, x: np.ndarray) -> float:
        tot = self.const
        for k, coef in self.terms.items():
            m = coef
            for v, p in k:
                m *= x[v] ** p
            tot += m
        return float(tot)

    def is_linear(self) -> bool:
        return self.degree() <= 1

    def is_quadratic(self) -> bool:
        return self.degree() <= 2

    # -------------------------------------------------------- conversions
    def to_expr_graph(self) -> ExprGraph:
        g = ExprGraph()
        parts = []
        for k, coef in sorted(self.terms.items()):
            factors = []
            for v, p in k:
                xv = g.var(v)
                if p == 1:
                    factors.append(xv)
                elif p == 2:
                    factors.append(g.node(Op.SQR, xv))
                else:
                    factors.append(g.node(Op.POWK, xv, const=float(p)))
            m = factors[0]
            for f in factors[1:]:
                m = g.node(Op.MULT, m, f)
            if coef != 1.0:
                m = g.node(Op.MULT, g.num(coef), m)
            parts.append(m)
        if self.const or not parts:
            parts.append(g.num(self.const))
        g.set_root(g.sum_list(parts))
        return g

    def __repr__(self) -> str:  # pragma: no cover
        return f"PolynomialFunction(n_terms={len(self.terms)}, " \
               f"deg={self.degree()}, const={self.const})"


def expr_to_polynomial(g: ExprGraph) -> Optional[PolynomialFunction]:
    """Extract a polynomial from an expression DAG when it is one
    (PLUS/MINUS/UMINUS/MULT/SQR/POWK-int/NUM/VAR/DIV-by-const); returns
    None otherwise (the TransPoly recognition direction)."""
    op_t, a1_t, a2_t, const_t, var_t = g.tables
    memo: Dict[int, Optional[PolynomialFunction]] = {}

    def rec(i: int) -> Optional[PolynomialFunction]:
        if i in memo:
            return memo[i]
        op = Op(op_t[i])
        out: Optional[PolynomialFunction]
        if op is Op.NUM:
            out = PolynomialFunction.constant(float(const_t[i]))
        elif op is Op.VAR:
            out = PolynomialFunction.variable(int(var_t[i]))
        elif op is Op.PLUS:
            a, b = rec(a1_t[i]), rec(a2_t[i])
            out = None if a is None or b is None else a + b
        elif op is Op.MINUS:
            a, b = rec(a1_t[i]), rec(a2_t[i])
            out = None if a is None or b is None else a - b
        elif op is Op.UMINUS:
            a = rec(a1_t[i])
            out = None if a is None else a * -1.0
        elif op is Op.MULT:
            a, b = rec(a1_t[i]), rec(a2_t[i])
            out = None if a is None or b is None else a * b
        elif op is Op.SQR:
            a = rec(a1_t[i])
            out = None if a is None else a * a
        elif op is Op.POWK:
            a = rec(a1_t[i])
            k = float(const_t[i])
            if a is None or k < 0 or abs(k - round(k)) > 1e-12:
                out = None
            else:
                out = a.power(int(round(k)))
        elif op is Op.DIV:
            a, b = rec(a1_t[i]), rec(a2_t[i])
            if a is None or b is None or len(b) or b.const == 0.0:
                out = None
            else:
                out = a * (1.0 / b.const)
        else:
            out = None
        memo[i] = out
        return out

    return rec(g.root) if g.root >= 0 else None
