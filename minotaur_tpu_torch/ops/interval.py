"""Interval arithmetic over expression DAGs — the FBBT primitive.

Port of minotaur_tpu/ops/interval.py.  The forward and backward rule
tables are the JAX package's, written against a small numpy-like view of
torch (`_TorchNP`: `maximum`/`minimum`/`clip` accept a float bound, as
jnp's do), so each rule reads as the original.  Every function works on
a trailing variable axis: bounds are (..., n) tensors, one call tightens
every lane of a batch.

``stage_fbbt(graph)`` returns

    (xlo, xhi, rlo, rhi) -> (new_xlo, new_xhi, infeasible)

a forward interval sweep, the root intersected with the imposed range
[rlo, rhi], then a backward projection sweep that tightens the variable
bounds.  Soundness convention: every rule returns a *superset* of the
true image / preimage; ops with no cheap inverse (trig, atan2, rem, ...)
give no backward tightening.  Infeasibility is detected wherever an
intersection becomes empty (lo > hi + eps).

`linear_fbbt` is the dense all-rows sweep over (B, n) boxes (the JAX
function is one box, vmapped by its callers; here the lane axis is
written out).
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch

from .opcodes import Op

_PI = math.pi
_INF = float("inf")


class _TorchNP:
    """The jnp functions the interval rules use, on torch tensors."""
    where = staticmethod(torch.where)
    isnan = staticmethod(torch.isnan)
    sqrt = staticmethod(torch.sqrt)
    exp = staticmethod(torch.exp)
    log = staticmethod(torch.log)
    log10 = staticmethod(torch.log10)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    tan = staticmethod(torch.tan)
    sinh = staticmethod(torch.sinh)
    cosh = staticmethod(torch.cosh)
    tanh = staticmethod(torch.tanh)
    arcsin = staticmethod(torch.asin)
    arccos = staticmethod(torch.acos)
    arctan = staticmethod(torch.atan)
    arcsinh = staticmethod(torch.asinh)
    arccosh = staticmethod(torch.acosh)
    arctanh = staticmethod(torch.atanh)
    floor = staticmethod(torch.floor)
    ceil = staticmethod(torch.ceil)
    trunc = staticmethod(torch.trunc)
    abs = staticmethod(torch.abs)
    sign = staticmethod(torch.sign)
    full_like = staticmethod(torch.full_like)
    ones_like = staticmethod(torch.ones_like)

    @staticmethod
    def maximum(a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, min=b)
        if not isinstance(a, torch.Tensor):
            return torch.clamp(b, min=a)
        return torch.maximum(a, b)

    @staticmethod
    def minimum(a, b):
        if not isinstance(b, torch.Tensor):
            return torch.clamp(a, max=b)
        if not isinstance(a, torch.Tensor):
            return torch.clamp(b, max=a)
        return torch.minimum(a, b)

    @staticmethod
    def clip(a, lo, hi):
        return torch.clamp(a, lo, hi)


jnp = _TorchNP


# ------------------------------------------------------------- primitives
def _safe_mul(jnp, a, b):
    """0 * inf -> 0 (needed for sound interval products)."""
    p = a * b
    return jnp.where(jnp.isnan(p), 0.0, p)


def _imul(jnp, al, ah, bl, bh):
    p1 = _safe_mul(jnp, al, bl)
    p2 = _safe_mul(jnp, al, bh)
    p3 = _safe_mul(jnp, ah, bl)
    p4 = _safe_mul(jnp, ah, bh)
    lo = jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4))
    hi = jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4))
    return lo, hi


def _idiv(jnp, al, ah, bl, bh):
    """[al,ah] / [bl,bh]; if 0 in [bl,bh] -> (-inf, inf).

    inf/inf quotients are NaN in IEEE; those lanes get the conservative
    (-inf, inf) — a NaN bound would otherwise break branching forever."""
    straddles = (bl <= 0.0) & (bh >= 0.0)
    safe_bl = jnp.where(straddles, 1.0, bl)
    safe_bh = jnp.where(straddles, 1.0, bh)
    q1 = al / safe_bl
    q2 = al / safe_bh
    q3 = ah / safe_bl
    q4 = ah / safe_bh
    lo = jnp.minimum(jnp.minimum(q1, q2), jnp.minimum(q3, q4))
    hi = jnp.maximum(jnp.maximum(q1, q2), jnp.maximum(q3, q4))
    lo = jnp.where(straddles | jnp.isnan(lo), -_INF, lo)
    hi = jnp.where(straddles | jnp.isnan(hi), _INF, hi)
    return lo, hi


def _isqr(jnp, al, ah):
    a2, b2 = al * al, ah * ah
    hi = jnp.maximum(a2, b2)
    lo = jnp.where((al <= 0.0) & (ah >= 0.0), 0.0, jnp.minimum(a2, b2))
    return lo, hi


def _ipow_even(jnp, al, ah, k):
    a2, b2 = al ** k, ah ** k
    hi = jnp.maximum(a2, b2)
    lo = jnp.where((al <= 0.0) & (ah >= 0.0), 0.0, jnp.minimum(a2, b2))
    return lo, hi


def _sin_bounds(jnp, al, ah):
    """Sharp interval sine: checks whether a peak/trough lies inside."""
    sa, sb = jnp.sin(al), jnp.sin(ah)
    lo = jnp.minimum(sa, sb)
    hi = jnp.maximum(sa, sb)
    two_pi = 2.0 * _PI
    # peak at pi/2 + 2k pi inside [al, ah]?
    has_peak = jnp.floor((ah - _PI / 2) / two_pi) >= jnp.ceil((al - _PI / 2) / two_pi)
    has_trough = jnp.floor((ah + _PI / 2) / two_pi) >= jnp.ceil((al + _PI / 2) / two_pi)
    wide = (ah - al) >= two_pi
    hi = jnp.where(has_peak | wide, 1.0, hi)
    lo = jnp.where(has_trough | wide, -1.0, lo)
    return lo, hi


# ------------------------------------------------------------ forward pass
def _forward_rules(jnp):
    tiny = 1e-300

    def fsqrt(al, ah):
        return jnp.sqrt(jnp.maximum(al, 0.0)), jnp.sqrt(jnp.maximum(ah, 0.0))

    def fpowk(al, ah, k):
        if float(k).is_integer():
            ki = int(k)
            if ki == 0:
                return jnp.ones_like(al), jnp.ones_like(ah)
            if ki < 0:
                plo, phi = fpowk(al, ah, -ki)
                return _idiv(jnp, jnp.ones_like(al), jnp.ones_like(ah), plo, phi)
            if ki % 2 == 0:
                return _ipow_even(jnp, al, ah, ki)
            return al ** ki, ah ** ki
        # fractional power: domain x >= 0, monotone for k > 0
        cl, ch = jnp.maximum(al, 0.0), jnp.maximum(ah, 0.0)
        if k > 0:
            return cl ** k, ch ** k
        lo, hi = ch ** k, cl ** k  # decreasing
        return lo, hi

    def fcpow(al, ah, c):
        if c <= 0.0:
            return jnp.full_like(al, -_INF), jnp.full_like(ah, _INF)
        if c >= 1.0:
            return c ** al, c ** ah
        return c ** ah, c ** al

    def ftan(al, ah):
        # asymptote at pi/2 + k pi inside?
        has_asym = jnp.floor((ah - _PI / 2) / _PI) >= jnp.ceil((al - _PI / 2) / _PI)
        lo = jnp.where(has_asym, -_INF, jnp.tan(al))
        hi = jnp.where(has_asym, _INF, jnp.tan(ah))
        return lo, hi

    def fcosh(al, ah):
        c1, c2 = jnp.cosh(al), jnp.cosh(ah)
        hi = jnp.maximum(c1, c2)
        lo = jnp.where((al <= 0.0) & (ah >= 0.0), 1.0, jnp.minimum(c1, c2))
        return lo, hi

    def fabs_(al, ah):
        hi = jnp.maximum(jnp.abs(al), jnp.abs(ah))
        lo = jnp.where((al <= 0.0) & (ah >= 0.0), 0.0,
                       jnp.minimum(jnp.abs(al), jnp.abs(ah)))
        return lo, hi

    def fpow(al, ah, bl, bh):
        # general x^y: only meaningful for x > 0; else give up
        pos = al > 0.0
        ll = jnp.log(jnp.maximum(al, tiny))
        lh = jnp.log(jnp.maximum(ah, tiny))
        ml, mh = _imul(jnp, ll, lh, bl, bh)
        lo = jnp.where(pos, jnp.exp(ml), -_INF)
        hi = jnp.where(pos, jnp.exp(mh), _INF)
        return lo, hi

    def fasin(al, ah):
        c = lambda v: jnp.clip(v, -1.0, 1.0)
        return jnp.arcsin(c(al)), jnp.arcsin(c(ah))

    def facos(al, ah):
        c = lambda v: jnp.clip(v, -1.0, 1.0)
        return jnp.arccos(c(ah)), jnp.arccos(c(al))

    def fatanh(al, ah):
        c = lambda v: jnp.clip(v, -1.0 + 1e-15, 1.0 - 1e-15)
        return jnp.arctanh(c(al)), jnp.arctanh(c(ah))

    def facosh(al, ah):
        c = lambda v: jnp.maximum(v, 1.0)
        return jnp.arccosh(c(al)), jnp.arccosh(c(ah))

    def frem(al, ah, bl, bh):
        m = jnp.maximum(jnp.abs(bl), jnp.abs(bh))
        m = jnp.minimum(m, jnp.maximum(jnp.abs(al), jnp.abs(ah)))
        return -m, m

    def fintdiv(al, ah, bl, bh):
        ql, qh = _idiv(jnp, al, ah, bl, bh)
        return jnp.trunc(ql) - 1.0, jnp.trunc(qh) + 1.0

    return {
        Op.PLUS: lambda a, b, c: (a[0] + b[0], a[1] + b[1]),
        Op.MINUS: lambda a, b, c: (a[0] - b[1], a[1] - b[0]),
        Op.MULT: lambda a, b, c: _imul(jnp, a[0], a[1], b[0], b[1]),
        Op.DIV: lambda a, b, c: _idiv(jnp, a[0], a[1], b[0], b[1]),
        Op.UMINUS: lambda a, b, c: (-a[1], -a[0]),
        Op.ABS: lambda a, b, c: fabs_(a[0], a[1]),
        Op.SQR: lambda a, b, c: _isqr(jnp, a[0], a[1]),
        Op.SQRT: lambda a, b, c: fsqrt(a[0], a[1]),
        Op.POWK: lambda a, b, c: fpowk(a[0], a[1], c),
        Op.CPOW: lambda a, b, c: fcpow(a[0], a[1], c),
        Op.POW: lambda a, b, c: fpow(a[0], a[1], b[0], b[1]),
        Op.EXP: lambda a, b, c: (jnp.exp(jnp.minimum(a[0], 709.0)),
                                 jnp.exp(jnp.minimum(a[1], 709.0))),
        Op.LOG: lambda a, b, c: (jnp.log(jnp.maximum(a[0], tiny)),
                                 jnp.log(jnp.maximum(a[1], tiny))),
        Op.LOG10: lambda a, b, c: (jnp.log10(jnp.maximum(a[0], tiny)),
                                   jnp.log10(jnp.maximum(a[1], tiny))),
        Op.SIN: lambda a, b, c: _sin_bounds(jnp, a[0], a[1]),
        Op.COS: lambda a, b, c: _sin_bounds(jnp, a[0] + _PI / 2, a[1] + _PI / 2),
        Op.TAN: lambda a, b, c: ftan(a[0], a[1]),
        Op.SINH: lambda a, b, c: (jnp.sinh(a[0]), jnp.sinh(a[1])),
        Op.COSH: lambda a, b, c: fcosh(a[0], a[1]),
        Op.TANH: lambda a, b, c: (jnp.tanh(a[0]), jnp.tanh(a[1])),
        Op.ASIN: lambda a, b, c: fasin(a[0], a[1]),
        Op.ACOS: lambda a, b, c: facos(a[0], a[1]),
        Op.ATAN: lambda a, b, c: (jnp.arctan(a[0]), jnp.arctan(a[1])),
        Op.ASINH: lambda a, b, c: (jnp.arcsinh(a[0]), jnp.arcsinh(a[1])),
        Op.ACOSH: lambda a, b, c: facosh(a[0], a[1]),
        Op.ATANH: lambda a, b, c: fatanh(a[0], a[1]),
        Op.ATAN2: lambda a, b, c: (jnp.full_like(a[0], -_PI), jnp.full_like(a[0], _PI)),
        Op.FLOOR: lambda a, b, c: (jnp.floor(a[0]), jnp.floor(a[1])),
        Op.CEIL: lambda a, b, c: (jnp.ceil(a[0]), jnp.ceil(a[1])),
        Op.INTDIV: lambda a, b, c: fintdiv(a[0], a[1], b[0], b[1]),
        Op.MAX2: lambda a, b, c: (jnp.maximum(a[0], b[0]), jnp.maximum(a[1], b[1])),
        Op.MIN2: lambda a, b, c: (jnp.minimum(a[0], b[0]), jnp.minimum(a[1], b[1])),
        Op.REM: lambda a, b, c: frem(a[0], a[1], b[0], b[1]),
        Op.LESS: lambda a, b, c: (jnp.maximum(a[0] - b[1], 0.0),
                                  jnp.maximum(a[1] - b[0], 0.0)),
    }


# ----------------------------------------------------------- backward pass
def _backward_rules(jnp):
    """rule(op) -> fn(r, a, b, const) -> (tight_a, tight_b)

    r, a, b are (lo, hi) pairs: r = imposed interval on the node, a/b the
    children's current (forward) intervals.  Returns tightened intervals
    for the children (or None for "no tightening")."""
    tiny = 1e-300

    def b_plus(r, a, b, c):
        return (r[0] - b[1], r[1] - b[0]), (r[0] - a[1], r[1] - a[0])

    def b_minus(r, a, b, c):
        return (r[0] + b[0], r[1] + b[1]), (a[0] - r[1], a[1] - r[0])

    def b_uminus(r, a, b, c):
        return (-r[1], -r[0]), None

    def b_mult(r, a, b, c):
        return _idiv(jnp, r[0], r[1], b[0], b[1]), \
               _idiv(jnp, r[0], r[1], a[0], a[1])

    def b_div(r, a, b, c):
        # node = a / b
        ta = _imul(jnp, r[0], r[1], b[0], b[1])
        tb = _idiv(jnp, a[0], a[1], r[0], r[1])
        return ta, tb

    def _root_pair(rl, rh, root):
        """preimage of [rl, rh] under even power, sign-split by child."""
        s = root(jnp.maximum(rh, 0.0))
        smin = root(jnp.maximum(rl, 0.0))
        return s, smin

    def b_sqr(r, a, b, c):
        s, smin = _root_pair(r[0], r[1], jnp.sqrt)
        # default hull [-s, s]; sharpen using the child's sign
        lo = jnp.where(a[0] >= 0.0, smin, -s)
        hi = jnp.where(a[1] <= 0.0, -smin, s)
        return (lo, hi), None

    def b_sqrt(r, a, b, c):
        rl = jnp.maximum(r[0], 0.0)
        rh = jnp.maximum(r[1], 0.0)
        return (rl * rl, rh * rh), None

    def b_abs(r, a, b, c):
        s = jnp.maximum(r[1], 0.0)
        smin = jnp.maximum(r[0], 0.0)
        lo = jnp.where(a[0] >= 0.0, smin, -s)
        hi = jnp.where(a[1] <= 0.0, -smin, s)
        return (lo, hi), None

    def b_powk(r, a, b, c):
        if float(c).is_integer() and c > 0:
            ki = int(c)
            if ki % 2 == 0:
                root = lambda v: v ** (1.0 / ki)
                s, smin = _root_pair(r[0], r[1], root)
                lo = jnp.where(a[0] >= 0.0, smin, -s)
                hi = jnp.where(a[1] <= 0.0, -smin, s)
                return (lo, hi), None
            # odd: monotone, signed root
            sroot = lambda v: jnp.sign(v) * jnp.abs(v) ** (1.0 / ki)
            return (sroot(r[0]), sroot(r[1])), None
        if c > 0:  # fractional, domain >= 0, increasing
            return (jnp.maximum(r[0], 0.0) ** (1.0 / c),
                    jnp.maximum(r[1], tiny) ** (1.0 / c)), None
        return None, None

    def b_exp(r, a, b, c):
        return (jnp.log(jnp.maximum(r[0], tiny)),
                jnp.log(jnp.maximum(r[1], tiny))), None

    def b_log(r, a, b, c):
        return (jnp.exp(jnp.minimum(r[0], 709.0)),
                jnp.exp(jnp.minimum(r[1], 709.0))), None

    def b_log10(r, a, b, c):
        ln10 = math.log(10.0)
        return (jnp.exp(jnp.minimum(r[0] * ln10, 709.0)),
                jnp.exp(jnp.minimum(r[1] * ln10, 709.0))), None

    def b_cpow(r, a, b, c):
        if c <= 0.0 or c == 1.0:
            return None, None
        lc = math.log(c)
        lo = jnp.log(jnp.maximum(r[0], tiny)) / lc
        hi = jnp.log(jnp.maximum(r[1], tiny)) / lc
        if c < 1.0:
            lo, hi = hi, lo
        return (lo, hi), None

    def b_tanh(r, a, b, c):
        cl = lambda v: jnp.clip(v, -1.0 + 1e-15, 1.0 - 1e-15)
        return (jnp.arctanh(cl(r[0])), jnp.arctanh(cl(r[1]))), None

    def b_sinh(r, a, b, c):
        return (jnp.arcsinh(r[0]), jnp.arcsinh(r[1])), None

    def b_asinh(r, a, b, c):
        return (jnp.sinh(jnp.clip(r[0], -700.0, 700.0)),
                jnp.sinh(jnp.clip(r[1], -700.0, 700.0))), None

    def b_atan(r, a, b, c):
        cl = lambda v: jnp.clip(v, -_PI / 2 + 1e-12, _PI / 2 - 1e-12)
        return (jnp.tan(cl(r[0])), jnp.tan(cl(r[1]))), None

    def b_atanh(r, a, b, c):
        return (jnp.tanh(r[0]), jnp.tanh(r[1])), None

    def b_asin(r, a, b, c):
        cl = lambda v: jnp.clip(v, -_PI / 2, _PI / 2)
        return (jnp.sin(cl(r[0])), jnp.sin(cl(r[1]))), None

    def b_acos(r, a, b, c):
        cl = lambda v: jnp.clip(v, 0.0, _PI)
        return (jnp.cos(cl(r[1])), jnp.cos(cl(r[0]))), None

    def b_acosh(r, a, b, c):
        rl = jnp.maximum(r[0], 0.0)
        rh = jnp.maximum(r[1], 0.0)
        return (jnp.cosh(jnp.minimum(rl, 700.0)),
                jnp.cosh(jnp.minimum(rh, 700.0))), None

    def b_max(r, a, b, c):
        # both children <= rh
        return (a[0], jnp.minimum(a[1], r[1])), (b[0], jnp.minimum(b[1], r[1]))

    def b_min(r, a, b, c):
        return (jnp.maximum(a[0], r[0]), a[1]), (jnp.maximum(b[0], r[0]), b[1])

    return {
        Op.PLUS: b_plus, Op.MINUS: b_minus, Op.UMINUS: b_uminus,
        Op.MULT: b_mult, Op.DIV: b_div, Op.SQR: b_sqr, Op.SQRT: b_sqrt,
        Op.ABS: b_abs, Op.POWK: b_powk, Op.EXP: b_exp, Op.LOG: b_log,
        Op.LOG10: b_log10, Op.CPOW: b_cpow, Op.TANH: b_tanh,
        Op.SINH: b_sinh, Op.ASINH: b_asinh, Op.ATAN: b_atan,
        Op.ATANH: b_atanh, Op.ASIN: b_asin, Op.ACOS: b_acos,
        Op.ACOSH: b_acosh, Op.MAX2: b_max, Op.MIN2: b_min,
    }


_FWD = _forward_rules(jnp)
_BWD = _backward_rules(jnp)


def _plan(graph):
    """The reachable nodes in topological order, as (i, Op, arg1, arg2,
    const, var) with plain Python values (made once at staging time)."""
    op, arg1, arg2, const, var = graph.tables
    reach = graph.reachable_from_root()
    return [(i, Op(op[i]), int(arg1[i]), int(arg2[i]), float(const[i]),
             int(var[i])) for i in range(len(op)) if reach[i]]


def _forward(plan, n, xlo, xhi):
    """Forward sweep: list of (lo, hi) per node (None where unreachable).
    NUM nodes are 0-dim tensors; every other node is (...)."""
    iv: List = [None] * n
    for i, o, a1, a2, c, v in plan:
        if o is Op.NUM:
            t = xlo.new_full((), c)
            iv[i] = (t, t)
        elif o is Op.VAR:
            iv[i] = (xlo[..., v], xhi[..., v])
        else:
            iv[i] = _FWD[o](iv[a1] if a1 >= 0 else None,
                            iv[a2] if a2 >= 0 else None, c)
    return iv


# ------------------------------------------------------------- staging api
def stage_interval(graph) -> Callable:
    """graph -> f(xlo, xhi) -> (root_lo, root_hi): forward sweep only
    (reference: CGraph::computeBounds)."""
    root = graph.root
    plan, n = _plan(graph), len(graph)

    def f(xlo, xhi):
        lo, hi = _forward(plan, n, xlo, xhi)[root]
        shape = xlo.shape[:-1]
        return lo.expand(shape), hi.expand(shape)

    return f


def stage_fbbt(graph, n_vars: int) -> Callable:
    """graph -> f(xlo, xhi, rlo, rhi) -> (new_xlo, new_xhi, infeasible).

    Forward sweep, intersect root with the constraint range, backward
    projection sweep; variable tightenings scatter into the full-length
    bound vectors (reference: CGraph::varBoundMods CGraph.h:198)."""
    op = graph.tables[0]
    plan = _plan(graph)
    n = len(op)
    root = graph.root
    eps = 1e-9
    var_nodes = [p[0] for p in plan if p[1] is Op.VAR]
    var_idx = [p[5] for p in plan if p[1] is Op.VAR]
    is_num = [Op(o) is Op.NUM for o in op]
    back = [p for p in reversed(plan)
            if p[1] not in (Op.NUM, Op.VAR) and p[1] in _BWD]

    def f(xlo, xhi, rlo, rhi):
        iv = _forward(plan, n, xlo, xhi)

        # imposed intervals, initialised to forward results
        tlo = [iv[i][0] if iv[i] is not None else None for i in range(n)]
        thi = [iv[i][1] if iv[i] is not None else None for i in range(n)]
        tlo[root] = jnp.maximum(tlo[root], rlo)
        thi[root] = jnp.minimum(thi[root], rhi)
        infeas = tlo[root] > thi[root] + eps

        for i, o, a_i, b_i, c, _v in back:
            a = (tlo[a_i], thi[a_i]) if a_i >= 0 else None
            b = (tlo[b_i], thi[b_i]) if b_i >= 0 else None
            ta, tb = _BWD[o]((tlo[i], thi[i]), a, b, c)
            for child, t in ((a_i, ta), (b_i, tb)):
                if child < 0 or t is None:
                    continue
                if is_num[child]:
                    continue
                nl = jnp.maximum(tlo[child], t[0])
                nh = jnp.minimum(thi[child], t[1])
                infeas = infeas | (nl > nh + eps)
                tlo[child], thi[child] = nl, nh

        shape = xlo.shape[:-1]
        new_lo, new_hi = xlo, xhi
        if var_nodes:
            idx = torch.as_tensor(var_idx, dtype=torch.long,
                                  device=xlo.device).expand(shape + (-1,))
            tl = torch.stack([tlo[i].expand(shape) for i in var_nodes], -1)
            th = torch.stack([thi[i].expand(shape) for i in var_nodes], -1)
            tl = torch.where(torch.isnan(tl), -_INF, tl)
            th = torch.where(torch.isnan(th), _INF, th)
            new_lo = xlo.scatter_reduce(-1, idx, tl, "amax")
            new_hi = xhi.scatter_reduce(-1, idx, th, "amin")
        infeas = infeas.expand(shape) | (new_lo > new_hi + eps).any(dim=-1)
        return new_lo, new_hi, infeas

    return f


# ------------------------------------------------- linear-row FBBT (dense)
def linear_fbbt(A: torch.Tensor, row_lo: torch.Tensor, row_hi: torch.Tensor,
                xlo: torch.Tensor, xhi: torch.Tensor):
    """One vectorized FBBT sweep over all linear rows, for every lane.

    A (m, n) is shared; row_lo/row_hi are (m,) or per lane (B, m);
    xlo/xhi are (B, n).  Returns (new_xlo, new_xhi, infeasible (B,)
    bool).  Infinities are tracked explicitly exactly as in the JAX
    function: zero coefficients are masked inside the products (0 * inf
    = NaN), and the activity excluding column j distinguishes 0, 1 and
    several infinite terms.
    """
    m = A.shape[0]
    row_lo = row_lo.expand(xlo.shape[0], m)
    row_hi = row_hi.expand(xlo.shape[0], m)
    pos = torch.clamp(A, min=0.0)[None]          # (1, m, n)
    neg = torch.clamp(A, max=0.0)[None]
    lo = xlo[:, None, :]                          # (B, 1, n)
    hi = xhi[:, None, :]

    def _sm(a, b):
        return torch.where(a == 0.0, 0.0, a * b)

    term_min = _sm(pos, lo) + _sm(neg, hi)        # (B, m, n)
    term_max = _sm(pos, hi) + _sm(neg, lo)
    inf_min = ~torch.isfinite(term_min)
    inf_max = ~torch.isfinite(term_max)
    tmin_f = torch.where(inf_min, 0.0, term_min)
    tmax_f = torch.where(inf_max, 0.0, term_max)
    fin_min = tmin_f.sum(dim=2)                   # (B, m)
    fin_max = tmax_f.sum(dim=2)
    ninf_min = inf_min.sum(dim=2)
    ninf_max = inf_max.sum(dim=2)
    minact = torch.where(ninf_min > 0, -_INF, fin_min)
    maxact = torch.where(ninf_max > 0, _INF, fin_max)
    infeas = (minact > row_hi + 1e-7).any(dim=1) | \
        (maxact < row_lo - 1e-7).any(dim=1)

    # min-activity excluding column j:
    #   0 infinite terms          -> fin_min - term_min[:, j]
    #   1 infinite term, it is j  -> fin_min (the finite remainder)
    #   otherwise                 -> -inf
    rmin = torch.where(ninf_min[:, :, None] == 0, fin_min[:, :, None] - tmin_f,
                       torch.where((ninf_min[:, :, None] == 1) & inf_min,
                                   fin_min[:, :, None], -_INF))
    rmax = torch.where(ninf_max[:, :, None] == 0, fin_max[:, :, None] - tmax_f,
                       torch.where((ninf_max[:, :, None] == 1) & inf_max,
                                   fin_max[:, :, None], _INF))

    Ab = A[None]
    safe = torch.where(Ab == 0.0, 1.0, Ab)
    # a_ij > 0: x_j <= (hi_i - rmin_ij)/a_ij ; x_j >= (lo_i - rmax_ij)/a_ij
    ub_pos = (row_hi[:, :, None] - rmin) / safe
    lb_pos = (row_lo[:, :, None] - rmax) / safe
    # a_ij < 0: x_j >= (hi_i - rmin_ij)/a_ij ; x_j <= (lo_i - rmax_ij)/a_ij
    new_ub = torch.where(Ab > 0.0, ub_pos, torch.where(Ab < 0.0, lb_pos, _INF))
    new_lb = torch.where(Ab > 0.0, lb_pos, torch.where(Ab < 0.0, ub_pos, -_INF))
    # ignore rows with infinite activities (no information)
    new_ub = torch.where(torch.isfinite(new_ub), new_ub, _INF)
    new_lb = torch.where(torch.isfinite(new_lb), new_lb, -_INF)
    if m:
        xhi2 = torch.minimum(xhi, new_ub.amin(dim=1))
        xlo2 = torch.maximum(xlo, new_lb.amax(dim=1))
    else:
        xhi2, xlo2 = xhi, xlo
    infeas = infeas | (xlo2 > xhi2 + 1e-9).any(dim=1)
    return xlo2, xhi2, infeas
