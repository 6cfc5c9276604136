"""Reformulate a factorable MINLP to term-separable standard form.

Reference: the Glob pipeline's transformer stage (Glob.cpp:107-130 ->
QuadTransformer / SimpleTransformer.cpp:921 `reformulate`, recursive walk
`recursRef_` :260): every nonlinear subterm gets an auxiliary variable
with a defining constraint — y = x_i x_j for products (handled by
QuadHandler), y = f(x) for univariate nonlinearities (CxUnivarHandler /
kPowHandler) — deduplicated across the problem (the YEq* registries:
YEqVars/YEqLFs/YEqCGs/YEqMonomial...).  The problem becomes linear over
the extended variable vector z = (x, aux) plus the term definitions,
which the relaxation step outer-approximates (McCormick / secant /
tangent envelopes computed in-trace from the node box).

Convex quadratics are detected by eigenvalue check (reference
checkQuadConvexity_ :735 via LAPACK dsyevr -> numpy.linalg.eigvalsh here)
so the driver can forward them to QG (Glob.cpp:392-400).

TPU-native notes: the reformulation happens once on the host; what ships
to the device is purely static metadata (term index arrays + univariate
shape classes), so a batch of nodes shares one compiled superstep and
per-node state stays (vlb, vub).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..ir.expr import ExprGraph
from ..ir.problem import Problem
from ..ops.opcodes import Op
from ..utils.types import INF, FunctionType
from .univariate import term_meta, uni_range_np

_INF = float("inf")


@dataclasses.dataclass
class GlobStaged:
    """Standard form over z = (x, aux):  min c.z  s.t. A z in [clb, cub],
    vlb <= z <= vub, plus term definitions:
      bilinear: z[term_y[t]] = z[term_i[t]] * z[term_j[t]]
      univariate: z[uni_y[u]] = f_{uni_f[u], uni_k[u]}(z[uni_x[u]])
    Linear-form auxiliaries (w = a.z + b) are folded into A as equality
    rows and need no envelopes."""
    name: str
    n_x: int
    n_y: int                     # number of bilinear/square terms
    c: np.ndarray                # (nz,)
    obj_const: float
    A: np.ndarray                # (m, nz)
    clb: np.ndarray
    cub: np.ndarray
    vlb: np.ndarray              # (nz,) including aux bounds
    vub: np.ndarray
    int_mask: np.ndarray
    term_i: np.ndarray           # (n_y,) first factor column
    term_j: np.ndarray           # (n_y,) second factor column (== i: square)
    term_y: np.ndarray = None    # (n_y,) product column
    uni_f: np.ndarray = None     # (n_u,) opcode
    uni_x: np.ndarray = None     # (n_u,) input column
    uni_y: np.ndarray = None     # (n_u,) output column
    uni_k: np.ndarray = None     # (n_u,) payload (exponent / base)
    # trilinear lambda-hull groups (reference MultilinearTermsHandler):
    # z[tri_y[t]] = prod over z[tri_vars[t]]; 8 lambda columns starting
    # at tri_lam0[t] carry the extreme-point hull (sum-to-1 row is
    # static in A; the box-dependent link rows are built in-trace)
    tri_vars: np.ndarray = None  # (n_t, 3) factor columns
    tri_y: np.ndarray = None     # (n_t,) product column
    tri_lam0: np.ndarray = None  # (n_t,) first lambda column
    # quadrilinear lambda-hull groups (general `ml_*` grouping analogue:
    # the reference groups multilinear terms of any arity and builds the
    # grouped extreme-point hull, MultilinearTermsHandler.cpp; fixed
    # arities 3 and 4 cover the shipped instances' degrees while keeping
    # shapes static): 16 lambda columns per group
    quad_vars: np.ndarray = None  # (n_q, 4) factor columns
    quad_y: np.ndarray = None     # (n_q,) product column
    quad_lam0: np.ndarray = None  # (n_q,) first lambda column

    def __post_init__(self):
        if self.term_y is None:
            self.term_y = self.n_x + np.arange(self.n_y, dtype=np.int32)
        for f in ("uni_f", "uni_x", "uni_y", "tri_y", "tri_lam0",
                  "quad_y", "quad_lam0"):
            if getattr(self, f) is None:
                setattr(self, f, np.zeros(0, dtype=np.int32))
        if self.uni_k is None:
            self.uni_k = np.zeros(0, dtype=np.float64)
        if self.tri_vars is None:
            self.tri_vars = np.zeros((0, 3), dtype=np.int32)
        if self.quad_vars is None:
            self.quad_vars = np.zeros((0, 4), dtype=np.int32)

    @property
    def n(self) -> int:
        return len(self.c)

    @property
    def n_u(self) -> int:
        return len(self.uni_f)

    @property
    def n_t(self) -> int:
        return len(self.tri_y)

    @property
    def n_q(self) -> int:
        return len(self.quad_y)


def is_convex_quadratic(problem: Problem, tol: float = 1e-9) -> bool:
    """True if the objective quadratic is PSD and every quadratic
    constraint is one-sided-convex (<= with PSD or >= with NSD)."""
    from ..engines.staging import _quad_to_dense
    n = problem.n_vars

    def eigs(qf):
        return np.linalg.eigvalsh(_quad_to_dense(qf, n))

    if problem.obj and problem.obj.fun.nlf is not None and \
            problem.obj.fun.nlf.root >= 0:
        return False
    if problem.obj and problem.obj.fun.qf and len(problem.obj.fun.qf):
        if eigs(problem.obj.fun.qf).min() < -tol:
            return False
    for c in problem.cons:
        if c.fun.nlf is not None and c.fun.nlf.root >= 0:
            return False  # general nonlinear: not classified here
        if c.fun.qf and len(c.fun.qf):
            ev = eigs(c.fun.qf)
            if c.lb > -INF and c.ub < INF:
                return False            # two-sided quadratic: nonconvex
            if c.ub < INF and ev.min() < -tol:
                return False
            if c.lb > -INF and ev.max() > tol:
                return False
    return True


class _LinForm:
    """Sparse linear form sum coef*z + const over the extended space."""
    __slots__ = ("coefs", "const")

    def __init__(self, coefs: Optional[Dict[int, float]] = None,
                 const: float = 0.0):
        self.coefs = coefs or {}
        self.const = const

    def scaled(self, s: float) -> "_LinForm":
        return _LinForm({v: c * s for v, c in self.coefs.items()},
                        self.const * s)

    def plus(self, other: "_LinForm", sign: float = 1.0) -> "_LinForm":
        out = dict(self.coefs)
        for v, c in other.coefs.items():
            out[v] = out.get(v, 0.0) + sign * c
        return _LinForm(out, self.const + sign * other.const)

    @property
    def is_const(self) -> bool:
        return not any(abs(c) > 1e-300 for c in self.coefs.values())

    def single_col(self) -> Optional[int]:
        live = [(v, c) for v, c in self.coefs.items() if abs(c) > 1e-300]
        if len(live) == 1 and abs(live[0][1] - 1.0) < 1e-15 and \
                abs(self.const) < 1e-300:
            return live[0][0]
        return None

    def key(self) -> Tuple:
        return (tuple(sorted((v, c) for v, c in self.coefs.items()
                             if abs(c) > 1e-300)), self.const)


class _Builder:
    """Walks expression DAGs emitting deduplicated aux terms.

    Mirrors SimpleTransformer::recursRef_ (SimpleTransformer.cpp:260) with
    the YEq* registries collapsed into three dicts keyed on canonical
    term descriptors."""

    def __init__(self, problem: Problem):
        self.p = problem
        xlb, xub = problem.var_bounds()
        self.vlb: List[float] = list(xlb)
        self.vub: List[float] = list(xub)
        self.bil: Dict[Tuple[int, int], int] = {}   # (i,j) -> y col
        self.uni: Dict[Tuple[int, int, float], int] = {}  # (op,xc,k) -> y
        self.lfs: Dict[Tuple, int] = {}             # linform key -> w col
        self.extra_rows: List[Tuple[Dict[int, float], float, float]] = []
        self.bil_list: List[Tuple[int, int, int]] = []   # (i, j, ycol)
        self.uni_list: List[Tuple[int, int, int, float]] = []
        # flat monomial factorization per product column (reference:
        # MultilinearTermsHandler's term groups); used for lambda-hull
        # formulations of higher-order multilinear terms
        self.mono: Dict[int, Tuple[int, ...]] = {}

    # ------------------------------------------------------------ columns
    def _new_col(self, lo: float, hi: float) -> int:
        self.vlb.append(lo)
        self.vub.append(hi)
        return len(self.vlb) - 1

    def bil_col(self, i: int, j: int) -> int:
        key = (i, j) if i <= j else (j, i)
        hit = self.bil.get(key)
        if hit is not None:
            return hit
        lo_i, hi_i = self.vlb[key[0]], self.vub[key[0]]
        lo_j, hi_j = self.vlb[key[1]], self.vub[key[1]]
        if key[0] == key[1]:
            lo = 0.0 if lo_i <= 0.0 <= hi_i else min(lo_i ** 2, hi_i ** 2)
            hi = max(lo_i ** 2, hi_i ** 2)
        else:
            with np.errstate(invalid="ignore"):
                prods = [lo_i * lo_j, lo_i * hi_j, hi_i * lo_j,
                         hi_i * hi_j]
            prods = [0.0 if np.isnan(v) else v for v in prods]
            lo, hi = min(prods), max(prods)
        y = self._new_col(lo, hi)
        self.bil[key] = y
        self.bil_list.append((key[0], key[1], y))
        fi = self.mono.get(key[0], (key[0],))
        fj = self.mono.get(key[1], (key[1],))
        self.mono[y] = tuple(sorted(fi + fj))
        return y

    def uni_col(self, op: int, xcol: int, k: float = 0.0) -> int:
        key = (int(op), xcol, float(k))
        hit = self.uni.get(key)
        if hit is not None:
            return hit
        meta = term_meta(op, k)
        if not meta["ok"]:
            raise ValueError(
                f"op {Op(op).name} (k={k}) unsupported by the factorable "
                "transformer")
        lo, hi = uni_range_np(op, k, self.vlb[xcol], self.vub[xcol])
        # domain restriction on x is sound: f(x) must be defined
        self.vlb[xcol] = max(self.vlb[xcol], meta["dom_lo"])
        self.vub[xcol] = min(self.vub[xcol], meta["dom_hi"])
        y = self._new_col(lo, hi)
        self.uni[key] = y
        self.uni_list.append((int(op), xcol, y, float(k)))
        return y

    def col_of(self, form: _LinForm) -> int:
        """Column representing a linear form (YEqLFs equivalent): reuse an
        existing column for trivial forms, else an aux w with the defining
        equality row w - form = 0."""
        single = form.single_col()
        if single is not None:
            return single
        key = form.key()
        hit = self.lfs.get(key)
        if hit is not None:
            return hit
        lo = form.const
        hi = form.const
        for v, c in form.coefs.items():
            if abs(c) < 1e-300:
                continue
            a = c * self.vlb[v] if c > 0 else c * self.vub[v]
            b = c * self.vub[v] if c > 0 else c * self.vlb[v]
            lo += a if np.isfinite(a) else -_INF
            hi += b if np.isfinite(b) else _INF
        w = self._new_col(lo, hi)
        row = {v: -c for v, c in form.coefs.items() if abs(c) > 1e-300}
        row[w] = 1.0
        self.extra_rows.append((row, form.const, form.const))
        self.lfs[key] = w
        return w

    # --------------------------------------------------------------- walk
    def walk(self, g: ExprGraph) -> _LinForm:
        memo: Dict[int, _LinForm] = {}
        op_t, a1_t, a2_t, const_t, var_t = g.tables

        def rec(i: int) -> _LinForm:
            hit = memo.get(i)
            if hit is not None:
                return hit
            op = Op(op_t[i])
            if op is Op.NUM:
                out = _LinForm({}, float(const_t[i]))
            elif op is Op.VAR:
                out = _LinForm({int(var_t[i]): 1.0})
            elif op is Op.PLUS:
                out = rec(a1_t[i]).plus(rec(a2_t[i]))
            elif op is Op.MINUS:
                out = rec(a1_t[i]).plus(rec(a2_t[i]), -1.0)
            elif op is Op.UMINUS:
                out = rec(a1_t[i]).scaled(-1.0)
            elif op is Op.MULT:
                a = rec(a1_t[i])
                b = rec(a2_t[i])
                if a.is_const:
                    out = b.scaled(a.const)
                elif b.is_const:
                    out = a.scaled(b.const)
                else:
                    y = self.bil_col(self.col_of(a), self.col_of(b))
                    out = _LinForm({y: 1.0})
            elif op is Op.SQR:
                a = rec(a1_t[i])
                if a.is_const:
                    out = _LinForm({}, a.const ** 2)
                else:
                    w = self.col_of(a)
                    out = _LinForm({self.bil_col(w, w): 1.0})
            elif op is Op.DIV:
                a = rec(a1_t[i])
                b = rec(a2_t[i])
                if b.is_const:
                    if b.const == 0.0:
                        raise ValueError("division by constant zero")
                    out = a.scaled(1.0 / b.const)
                else:
                    # q = a / b  <=>  q*b - a = 0 with fresh q
                    wb = self.col_of(b)
                    alo, ahi = self._form_range(a)
                    qlo, qhi = _interval_div(alo, ahi, self.vlb[wb],
                                             self.vub[wb])
                    q = self._new_col(qlo, qhi)
                    t = self.bil_col(q, wb)
                    row = {t: 1.0}
                    for v, c in a.coefs.items():
                        row[v] = row.get(v, 0.0) - c
                    self.extra_rows.append((row, a.const, a.const))
                    out = _LinForm({q: 1.0})
            elif op is Op.POWK:
                a = rec(a1_t[i])
                k = float(const_t[i])
                if a.is_const:
                    out = _LinForm({}, a.const ** k)
                elif abs(k - 1.0) < 1e-12:
                    out = a
                elif abs(k) < 1e-12:
                    out = _LinForm({}, 1.0)
                elif abs(k - 2.0) < 1e-12:
                    w = self.col_of(a)
                    out = _LinForm({self.bil_col(w, w): 1.0})
                else:
                    w = self.col_of(a)
                    out = _LinForm({self.uni_col(Op.POWK, w, k): 1.0})
            elif op is Op.CPOW:
                a = rec(a1_t[i])
                cbase = float(const_t[i])
                if a.is_const:
                    out = _LinForm({}, cbase ** a.const)
                else:
                    w = self.col_of(a)
                    out = _LinForm({self.uni_col(Op.CPOW, w, cbase): 1.0})
            elif op is Op.POW:
                # x^y = exp(y * log(x)) (reference transformer does the
                # same decomposition for variable exponents)
                a = rec(a1_t[i])
                b = rec(a2_t[i])
                if b.is_const:
                    k = b.const
                    if a.is_const:
                        out = _LinForm({}, a.const ** k)
                    else:
                        w = self.col_of(a)
                        out = _LinForm({self.uni_col(Op.POWK, w, k): 1.0})
                elif a.is_const:
                    w = self.col_of(b)
                    out = _LinForm({self.uni_col(Op.CPOW, w, a.const): 1.0})
                else:
                    wl = self.uni_col(Op.LOG, self.col_of(a))
                    t = self.bil_col(wl, self.col_of(b))
                    out = _LinForm({self.uni_col(Op.EXP, t): 1.0})
            elif op in (Op.ABS, Op.SQRT, Op.EXP, Op.LOG, Op.LOG10, Op.SIN,
                        Op.COS, Op.TAN, Op.SINH, Op.COSH, Op.TANH, Op.ASIN,
                        Op.ACOS, Op.ATAN, Op.ASINH, Op.ACOSH, Op.ATANH):
                a = rec(a1_t[i])
                if a.is_const:
                    from .univariate import uni_eval_np
                    out = _LinForm({}, uni_eval_np(int(op), a.const, 0.0))
                else:
                    w = self.col_of(a)
                    out = _LinForm({self.uni_col(op, w): 1.0})
            else:
                raise ValueError(
                    f"op {op.name} unsupported by the factorable "
                    "transformer (reference SimpleTransformer also "
                    "rejects nonsmooth/integer ops)")
            memo[i] = out
            return out

        return rec(g.root)

    def _form_range(self, form: _LinForm) -> Tuple[float, float]:
        lo = form.const
        hi = form.const
        for v, c in form.coefs.items():
            if abs(c) < 1e-300:
                continue
            a = c * self.vlb[v] if c > 0 else c * self.vub[v]
            b = c * self.vub[v] if c > 0 else c * self.vlb[v]
            lo += a if np.isfinite(a) else -_INF
            hi += b if np.isfinite(b) else _INF
        return lo, hi


def _interval_div(alo, ahi, blo, bhi):
    if blo <= 0.0 <= bhi:
        return (-_INF, _INF)
    cands = []
    for a in (alo, ahi):
        for b in (blo, bhi):
            if b != 0.0 and np.isfinite(a) and np.isfinite(b):
                cands.append(a / b)
    if not cands:
        return (-_INF, _INF)
    return (min(cands), max(cands))


def transform(problem: Problem,
              multilinear_hull: int = 0,
              multilinear_group: int = 4) -> GlobStaged:
    """Build the (x, aux) standard form for spatial branch-and-bound.

    Quadratic terms map to bilinear/square auxiliaries (QuadTransformer
    path); general expression DAGs are walked recursively emitting
    bilinear + univariate terms (SimpleTransformer path).

    ``multilinear_hull`` > 0 additionally equips up to that many
    trilinear monomials (flat products of 3 distinct finite-bounded
    columns, tracked through the recursive binarization) with the exact
    extreme-point lambda-hull (reference: MultilinearTermsHandler's
    grouped convex hulls, built there by separation; here the hull is a
    formulation — 8 lambda columns + link rows — so it needs no
    separation loop and tightens automatically as branching shrinks the
    box).

    ``multilinear_group`` caps the GROUP arity given an exact hull (the
    reference's ml_* group-size knob, MultilinearTermsHandler.cpp):
    terms of arity > multilinear_group decompose into a chain of grouped
    intermediates — the recursive binarization's intermediate columns
    carry flat factor tuples in b.mono, so every intermediate of arity
    3..multilinear_group gets the exact lambda hull and the chain's
    remaining links are McCormick.  Hulls over identical factor SETS
    share their lambda columns through the hash-consed intermediate
    columns (the YEq registries), the analogue of the reference's
    shared group storage.  Arity caps at 4 (16 lambda columns): the
    hull grows as 2^arity, the same economics that make the reference
    cap its group size."""
    multilinear_group = max(2, min(4, int(multilinear_group)))
    n = problem.n_vars
    b = _Builder(problem)

    # row linear forms (one per original constraint)
    row_forms: List[_LinForm] = []
    for c in problem.cons:
        form = _LinForm()
        if c.fun.lf:
            for v, co in c.fun.lf:
                form.coefs[v] = form.coefs.get(v, 0.0) + co
        if c.fun.qf and len(c.fun.qf):
            for (i, j), co in c.fun.qf.terms.items():
                y = b.bil_col(i, j)
                form.coefs[y] = form.coefs.get(y, 0.0) + co
        if c.fun.nlf is not None and c.fun.nlf.root >= 0:
            form = form.plus(b.walk(c.fun.nlf))
        row_forms.append(form)

    obj_form = _LinForm()
    obj_const = 0.0
    if problem.obj:
        obj_const = problem.obj.const
        if problem.obj.fun.lf:
            for v, co in problem.obj.fun.lf:
                obj_form.coefs[v] = obj_form.coefs.get(v, 0.0) + co
        if problem.obj.fun.qf and len(problem.obj.fun.qf):
            for (i, j), co in problem.obj.fun.qf.terms.items():
                y = b.bil_col(i, j)
                obj_form.coefs[y] = obj_form.coefs.get(y, 0.0) + co
        if problem.obj.fun.nlf is not None and problem.obj.fun.nlf.root >= 0:
            obj_form = obj_form.plus(b.walk(problem.obj.fun.nlf))
    obj_const += obj_form.const

    # trilinear lambda-hull groups: flat products of 3 distinct columns
    # whose factors all have finite root bounds (children boxes only
    # shrink, so in-trace hull coefficients stay finite forever)
    tri_vars_l: List[Tuple[int, ...]] = []
    tri_y_l: List[int] = []
    tri_lam0_l: List[int] = []
    quad_vars_l: List[Tuple[int, ...]] = []
    quad_y_l: List[int] = []
    quad_lam0_l: List[int] = []
    if multilinear_hull > 0:
        for y, facs in b.mono.items():
            if len(tri_y_l) + len(quad_y_l) >= multilinear_hull:
                break
            if not (3 <= len(facs) <= multilinear_group) or \
                    len(set(facs)) != len(facs):
                continue
            if not all(np.isfinite(b.vlb[v]) and np.isfinite(b.vub[v]) and
                       abs(b.vlb[v]) < 1e8 and abs(b.vub[v]) < 1e8
                       for v in facs):
                continue
            k = len(facs)
            lam0 = len(b.vlb)
            for _ in range(1 << k):
                b._new_col(0.0, 1.0)
            b.extra_rows.append(
                ({lam0 + v: 1.0 for v in range(1 << k)}, 1.0, 1.0))
            if k == 3:
                tri_vars_l.append(tuple(facs))
                tri_y_l.append(y)
                tri_lam0_l.append(lam0)
            else:
                quad_vars_l.append(tuple(facs))
                quad_y_l.append(y)
                quad_lam0_l.append(lam0)

    nz = len(b.vlb)
    m = problem.n_cons + len(b.extra_rows)
    A = np.zeros((m, nz))
    clb = np.empty(m)
    cub = np.empty(m)
    for r, c in enumerate(problem.cons):
        for v, co in row_forms[r].coefs.items():
            A[r, v] += co
        clb[r] = c.lb - row_forms[r].const if c.lb > -_INF else -_INF
        cub[r] = c.ub - row_forms[r].const if c.ub < _INF else _INF
    for k, (row, lo, hi) in enumerate(b.extra_rows):
        r = problem.n_cons + k
        for v, co in row.items():
            A[r, v] += co
        clb[r], cub[r] = lo, hi

    cvec = np.zeros(nz)
    for v, co in obj_form.coefs.items():
        cvec[v] += co

    int_mask = np.zeros(nz, dtype=bool)
    int_mask[problem.int_indices()] = True

    n_y = len(b.bil_list)
    term_i = np.asarray([t[0] for t in b.bil_list], dtype=np.int32)
    term_j = np.asarray([t[1] for t in b.bil_list], dtype=np.int32)
    term_y = np.asarray([t[2] for t in b.bil_list], dtype=np.int32)
    uni_f = np.asarray([u[0] for u in b.uni_list], dtype=np.int32)
    uni_x = np.asarray([u[1] for u in b.uni_list], dtype=np.int32)
    uni_y = np.asarray([u[2] for u in b.uni_list], dtype=np.int32)
    uni_k = np.asarray([u[3] for u in b.uni_list], dtype=np.float64)

    return GlobStaged(
        name=problem.name + "-glob", n_x=n, n_y=n_y, c=cvec,
        obj_const=obj_const, A=A, clb=clb, cub=cub,
        vlb=np.asarray(b.vlb), vub=np.asarray(b.vub),
        int_mask=int_mask, term_i=term_i, term_j=term_j, term_y=term_y,
        uni_f=uni_f, uni_x=uni_x, uni_y=uni_y, uni_k=uni_k,
        tri_vars=np.asarray(tri_vars_l, dtype=np.int32).reshape(-1, 3),
        tri_y=np.asarray(tri_y_l, dtype=np.int32),
        tri_lam0=np.asarray(tri_lam0_l, dtype=np.int32),
        quad_vars=np.asarray(quad_vars_l, dtype=np.int32).reshape(-1, 4),
        quad_y=np.asarray(quad_y_l, dtype=np.int32),
        quad_lam0=np.asarray(quad_lam0_l, dtype=np.int32))
