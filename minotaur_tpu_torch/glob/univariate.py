"""Univariate term library for the global pipeline: y = f(x).

Port of minotaur_tpu/glob/univariate.py.  The static metadata
(`term_meta`) and the host-side evaluation and range (`uni_eval_np`,
`uni_range_np`) are the JAX package's, as they are.  `make_uni_fns`
returns the value, derivative, forward range and backward projection as
torch functions over lane-batched (B, n_u) tensors, with every rule,
clip and guard of the JAX version.

Reference: kPowHandler.{h,cpp} (y = x^k), CxUnivarHandler.{h,cpp}
(secant over/under-estimators + tangent cuts for convex univariate
y=f(x)), and the univariate cases of SimpleTransformer::recursRef_
(SimpleTransformer.cpp:260 — aux vars for |x|, trig, powers).

Every univariate term is described by STATIC per-term metadata (opcode,
payload k, domain, curvature class on each side of the inflection at 0)
computed once at reformulation time, so the node superstep computes
secant + tangent envelope rows for a whole batch of boxes with array ops
— no per-node host work, no SecantMod-style mutation.  Curvature
classes:

    0 = convex   over the box  -> tangents are under-estimators, secant over
    1 = concave  over the box  -> tangents over, secant under
    2 = none     (no valid envelope; interval range rows only)

A term carries (shape_neg, shape_span, shape_pos): the class to use when
the node box lies in x<=0, spans 0, or lies in x>=0.  Functions with an
inflection at the origin (x^odd, sinh, tanh, atan, asin, ...) get class 2
in the spanning case; branching at 0 then restores full envelopes in both
children (the driver biases the spatial branch point to the inflection).
Everything here must stay *sound*: rows are only emitted when they are
guaranteed valid for all x in the box, and interval ranges are supersets.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.opcodes import Op

CONVEX, CONCAVE, NOENV = 0, 1, 2
_INF = float("inf")
# evaluation clip so tangent/secant arithmetic stays finite (tangents of a
# convex f at any point are globally valid supporting lines, so clipping
# the tangent point is sound; secants at clipped endpoints are disabled
# via the validity mask instead).
_XCAP = 1e8


def _is_int(k: float) -> bool:
    return abs(k - round(k)) < 1e-12


def term_meta(op: int, k: float) -> Dict[str, float]:
    """Static metadata for one univariate term.

    Returns dict with: dom_lo, dom_hi (x must lie inside for the term to
    be defined — FBBT may clamp the box to it), shape_neg/span/pos,
    even (f(-x)=f(x)), mono (+1 increasing, -1 decreasing, 0 neither),
    ok (False -> op unsupported, caller must reject).
    """
    o = Op(op)
    m = dict(dom_lo=-_INF, dom_hi=_INF, shape_neg=NOENV, shape_span=NOENV,
             shape_pos=NOENV, even=False, mono=0, ok=True)
    if o is Op.EXP:
        m.update(shape_neg=CONVEX, shape_span=CONVEX, shape_pos=CONVEX,
                 mono=1)
    elif o is Op.CPOW:                      # k^x, k > 0
        if k <= 0.0:
            m["ok"] = False
        else:
            m.update(shape_neg=CONVEX, shape_span=CONVEX, shape_pos=CONVEX,
                     mono=1 if k > 1.0 else (-1 if k < 1.0 else 0))
    elif o in (Op.LOG, Op.LOG10):
        m.update(dom_lo=0.0, shape_pos=CONCAVE, mono=1)
    elif o is Op.SQRT:
        m.update(dom_lo=0.0, shape_pos=CONCAVE, mono=1)
    elif o is Op.ACOSH:
        m.update(dom_lo=1.0, shape_pos=CONCAVE, mono=1)
    elif o is Op.ABS:
        m.update(shape_neg=CONVEX, shape_span=CONVEX, shape_pos=CONVEX,
                 even=True)
    elif o is Op.COSH:
        m.update(shape_neg=CONVEX, shape_span=CONVEX, shape_pos=CONVEX,
                 even=True)
    elif o is Op.SINH:
        m.update(shape_neg=CONCAVE, shape_span=NOENV, shape_pos=CONVEX,
                 mono=1)
    elif o in (Op.TANH, Op.ATAN, Op.ASINH):
        m.update(shape_neg=CONVEX, shape_span=NOENV, shape_pos=CONCAVE,
                 mono=1)
    elif o is Op.ASIN:
        m.update(dom_lo=-1.0, dom_hi=1.0, shape_neg=CONCAVE,
                 shape_span=NOENV, shape_pos=CONVEX, mono=1)
    elif o is Op.ACOS:
        m.update(dom_lo=-1.0, dom_hi=1.0, shape_neg=CONVEX,
                 shape_span=NOENV, shape_pos=CONCAVE, mono=-1)
    elif o is Op.ATANH:
        m.update(dom_lo=-1.0, dom_hi=1.0, shape_neg=CONCAVE,
                 shape_span=NOENV, shape_pos=CONVEX, mono=1)
    elif o in (Op.SIN, Op.COS, Op.TAN):
        pass                                 # range-only (class 2 all over)
    elif o is Op.SQR:
        m.update(shape_neg=CONVEX, shape_span=CONVEX, shape_pos=CONVEX,
                 even=True)
    elif o is Op.POWK:
        if _is_int(k):
            ki = int(round(k))
            if ki >= 2 and ki % 2 == 0:
                m.update(shape_neg=CONVEX, shape_span=CONVEX,
                         shape_pos=CONVEX, even=True)
            elif ki >= 3:
                m.update(shape_neg=CONCAVE, shape_span=NOENV,
                         shape_pos=CONVEX, mono=1)
            elif ki < 0 and ki % 2 == 0:
                # 1/x^even: defined off 0; each side convex
                m.update(shape_neg=CONVEX, shape_span=NOENV,
                         shape_pos=CONVEX, even=True)
            elif ki < 0:
                # 1/x^odd: x>0 convex, x<0 concave
                m.update(shape_neg=CONCAVE, shape_span=NOENV,
                         shape_pos=CONVEX)
            else:                            # k in {0, 1}: caller folds
                m["ok"] = False
        else:
            if k > 1.0:
                m.update(dom_lo=0.0, shape_pos=CONVEX, mono=1)
            elif 0.0 < k < 1.0:
                m.update(dom_lo=0.0, shape_pos=CONCAVE, mono=1)
            else:                            # k < 0, fractional: x > 0
                m.update(dom_lo=0.0, shape_pos=CONVEX, mono=-1)
    else:
        m["ok"] = False
    return m


SUPPORTED_UNI_OPS = frozenset(
    op for op in Op
    if op not in (Op.POWK, Op.CPOW) and term_meta(int(op), 0.0)["ok"])


# log and log10 of the smallest positive double (5e-324): the least value
# either takes on a double, the lower end of their range on [lo, hi] when
# lo < 1e-300 (the JAX package's range stops at the clamp, 1e-300)
LOG_FLOOR = {Op.LOG: math.log(5e-324), Op.LOG10: math.log10(5e-324)}


# ------------------------------------------------------------------ numpy
def uni_eval_np(op: int, x: float, k: float) -> float:
    o = Op(op)
    if o is Op.EXP:
        return math.exp(min(x, 700.0))
    if o is Op.CPOW:
        return k ** x if k > 0 else float("nan")
    if o is Op.LOG:
        return math.log(x) if x > 0 else -_INF
    if o is Op.LOG10:
        return math.log10(x) if x > 0 else -_INF
    if o is Op.SQRT:
        return math.sqrt(max(x, 0.0))
    if o is Op.ACOSH:
        return math.acosh(max(x, 1.0))
    if o is Op.ABS:
        return abs(x)
    if o is Op.COSH:
        return math.cosh(min(abs(x), 700.0))
    if o is Op.SINH:
        return math.sinh(np.clip(x, -700, 700))
    if o is Op.TANH:
        return math.tanh(x)
    if o is Op.ATAN:
        return math.atan(x)
    if o is Op.ASINH:
        return math.asinh(x)
    if o is Op.ASIN:
        return math.asin(np.clip(x, -1.0, 1.0))
    if o is Op.ACOS:
        return math.acos(np.clip(x, -1.0, 1.0))
    if o is Op.ATANH:
        if abs(x) >= 1.0:
            return math.copysign(_INF, x)
        return math.atanh(x)
    if o is Op.SIN:
        return math.sin(x)
    if o is Op.COS:
        return math.cos(x)
    if o is Op.TAN:
        return math.tan(x)
    if o is Op.SQR:
        return x * x
    if o is Op.POWK:
        if x == 0.0 and k < 0:
            return _INF
        if x < 0.0 and not _is_int(k):
            return float("nan")
        return float(np.power(x, k))
    raise ValueError(f"unsupported univariate op {o}")


def uni_range_np(op: int, k: float, lo: float, hi: float
                 ) -> Tuple[float, float]:
    """Sound superset of {f(x): x in [lo,hi] ∩ dom(f)} — host-side version
    for initial aux bounds at reformulation time."""
    meta = term_meta(op, k)
    lo = max(lo, meta["dom_lo"])
    hi = min(hi, meta["dom_hi"])
    o = Op(op)
    if lo > hi:
        return (_INF, -_INF)                 # empty domain: infeasible
    if o in (Op.SIN, Op.COS):
        shift = 0.0 if o is Op.SIN else math.pi / 2.0
        if not (math.isfinite(lo) and math.isfinite(hi)) or \
                hi - lo >= 2 * math.pi:
            return (-1.0, 1.0)
        vlo = min(uni_eval_np(op, lo, k), uni_eval_np(op, hi, k))
        vhi = max(uni_eval_np(op, lo, k), uni_eval_np(op, hi, k))
        # peak of sin at pi/2 + 2 pi n; trough at -pi/2 + 2 pi n
        if math.floor((hi + shift - math.pi / 2) / (2 * math.pi)) >= \
                math.ceil((lo + shift - math.pi / 2) / (2 * math.pi)):
            vhi = 1.0
        if math.floor((hi + shift + math.pi / 2) / (2 * math.pi)) >= \
                math.ceil((lo + shift + math.pi / 2) / (2 * math.pi)):
            vlo = -1.0
        return (vlo, vhi)
    if o is Op.TAN:
        if math.isfinite(lo) and math.isfinite(hi) and \
                math.floor((lo + math.pi / 2) / math.pi) == \
                math.floor((hi + math.pi / 2) / math.pi):
            return (uni_eval_np(op, lo, k), uni_eval_np(op, hi, k))
        return (-_INF, _INF)
    if meta["even"]:
        neg_pow = (o is Op.POWK and k < 0)
        if neg_pow and lo <= 0.0 <= hi:
            ends = [uni_eval_np(op, v, k) for v in (lo, hi) if v != 0.0]
            return (min(ends) if ends else _INF, _INF)
        if lo <= 0.0 <= hi:
            return (uni_eval_np(op, 0.0, k),
                    max(uni_eval_np(op, lo, k), uni_eval_np(op, hi, k)))
        a, b = uni_eval_np(op, lo, k), uni_eval_np(op, hi, k)
        return (min(a, b), max(a, b))
    if o is Op.POWK and k < 0 and lo <= 0.0 <= hi:
        return (-_INF, _INF)                 # 1/x^odd across the pole
    a, b = uni_eval_np(op, lo, k), uni_eval_np(op, hi, k)
    if math.isnan(a) or math.isnan(b):
        return (-_INF, _INF)
    return (min(a, b), max(a, b))


# ----------------------------------------------------------------- torch
def make_uni_fns(codes: np.ndarray, ks: np.ndarray, device="cpu"):
    """Vectorized (f, fprime, frange, fbackward) over a static code array.

    All four take/return (B, n_u) float64 tensors (fback: (B, n_u)
    y-ranges in, x-ranges out); evaluation is grouped per opcode present
    (static column gather/scatter), so each op's rule only ever sees
    domain-safe inputs for its own terms.
    """
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    inf = _INF

    groups: Dict[int, np.ndarray] = {}
    for i, c in enumerate(codes):
        groups.setdefault(int(c), []).append(i)
    groups = {c: np.asarray(ix, dtype=np.int64) for c, ix in groups.items()}
    gidx = {c: torch.as_tensor(ix, device=dev) for c, ix in groups.items()}
    ks = np.asarray(ks, dtype=np.float64)
    gk = {c: torch.as_tensor(ks[ix], **f64) for c, ix in groups.items()}

    def _rule_val(o, x, k):
        if o is Op.EXP:
            return torch.exp(torch.clamp(x, max=700.0))
        if o is Op.CPOW:
            return torch.exp(torch.clamp(x * torch.log(k), max=700.0))
        if o is Op.LOG:
            return torch.log(torch.clamp(x, min=1e-300))
        if o is Op.LOG10:
            return torch.log10(torch.clamp(x, min=1e-300))
        if o is Op.SQRT:
            return torch.sqrt(torch.clamp(x, min=0.0))
        if o is Op.ACOSH:
            return torch.acosh(torch.clamp(x, min=1.0))
        if o is Op.ABS:
            return torch.abs(x)
        if o is Op.COSH:
            return torch.cosh(torch.clamp(x, -700, 700))
        if o is Op.SINH:
            return torch.sinh(torch.clamp(x, -700, 700))
        if o is Op.TANH:
            return torch.tanh(x)
        if o is Op.ATAN:
            return torch.atan(x)
        if o is Op.ASINH:
            return torch.asinh(x)
        if o is Op.ASIN:
            return torch.asin(torch.clamp(x, -1.0, 1.0))
        if o is Op.ACOS:
            return torch.acos(torch.clamp(x, -1.0, 1.0))
        if o is Op.ATANH:
            return torch.atanh(torch.clamp(x, -1 + 1e-15, 1 - 1e-15))
        if o is Op.SIN:
            return torch.sin(x)
        if o is Op.COS:
            return torch.cos(x)
        if o is Op.TAN:
            return torch.tan(x)
        if o is Op.SQR:
            return x * x
        if o is Op.POWK:
            # k is a per-term vector; integer k uses |x|^k with sign fixup
            # for odd exponents, fractional k restricts to x >= 0
            isint = torch.abs(k - torch.round(k)) < 1e-12
            odd = torch.remainder(torch.round(k), 2.0) != 0.0
            base = torch.where(isint, torch.abs(x), torch.clamp(x, min=0.0))
            sgn = torch.where(isint & odd & (x < 0), -1.0, 1.0)
            mag = torch.exp(torch.clamp(
                k * torch.log(torch.clamp(base, min=1e-300)), -700.0, 700.0))
            return sgn * mag
        raise ValueError(f"unsupported univariate op {o}")

    def _rule_der(o, x, k):
        if o is Op.EXP:
            return torch.exp(torch.clamp(x, max=700.0))
        if o is Op.CPOW:
            lk = torch.log(k)
            return lk * torch.exp(torch.clamp(x * lk, max=700.0))
        if o is Op.LOG:
            return 1.0 / torch.clamp(x, min=1e-300)
        if o is Op.LOG10:
            return 1.0 / (torch.clamp(x, min=1e-300) * np.log(10.0))
        if o is Op.SQRT:
            return 0.5 / torch.sqrt(torch.clamp(x, min=1e-300))
        if o is Op.ACOSH:
            xs = torch.clamp(x, min=1.0 + 1e-12)
            return 1.0 / torch.sqrt(xs * xs - 1.0)
        if o is Op.ABS:
            return torch.sign(x)
        if o is Op.COSH:
            return torch.sinh(torch.clamp(x, -700, 700))
        if o is Op.SINH:
            return torch.cosh(torch.clamp(x, -700, 700))
        if o is Op.TANH:
            t = torch.tanh(x)
            return 1.0 - t * t
        if o is Op.ATAN:
            return 1.0 / (1.0 + x * x)
        if o is Op.ASINH:
            return 1.0 / torch.sqrt(1.0 + x * x)
        if o is Op.ASIN:
            xc = torch.clamp(x, -1 + 1e-12, 1 - 1e-12)
            return 1.0 / torch.sqrt(1.0 - xc * xc)
        if o is Op.ACOS:
            xc = torch.clamp(x, -1 + 1e-12, 1 - 1e-12)
            return -1.0 / torch.sqrt(1.0 - xc * xc)
        if o is Op.ATANH:
            xc = torch.clamp(x, -1 + 1e-12, 1 - 1e-12)
            return 1.0 / (1.0 - xc * xc)
        if o is Op.SIN:
            return torch.cos(x)
        if o is Op.COS:
            return -torch.sin(x)
        if o is Op.TAN:
            c = torch.cos(x)
            return 1.0 / torch.clamp(c * c, min=1e-300)
        if o is Op.SQR:
            return 2.0 * x
        if o is Op.POWK:
            return k * _rule_val(Op.POWK, x, k - 1.0)
        raise ValueError

    def _per_group(rule, x):
        out = torch.zeros_like(x)
        for c, idx in gidx.items():
            out[:, idx] = rule(Op(c), x[:, idx], gk[c])
        return out

    def fval(x):
        return _per_group(_rule_val, x)

    def fder(x):
        return _per_group(_rule_der, x)

    # ---- forward interval range: [rlo, rhi] ⊇ f([lo,hi]) per term ------
    metas = [term_meta(int(c), float(k)) for c, k in zip(codes, ks)]
    mono = np.asarray([m["mono"] for m in metas])
    even = np.asarray([m["even"] for m in metas], dtype=bool)
    negpow = np.asarray([Op(int(c)) is Op.POWK and k < 0
                         for c, k in zip(codes, ks)], dtype=bool)
    oddpole = negpow & ~even
    even_t = torch.as_tensor(even, device=dev)
    negpow_t = torch.as_tensor(negpow, device=dev)
    oddpole_t = torch.as_tensor(oddpole, device=dev)

    sin_like = np.asarray([Op(int(c)) in (Op.SIN, Op.COS) for c in codes],
                          dtype=bool)
    sin_shift = np.asarray([math.pi / 2 if Op(int(c)) is Op.COS else 0.0
                            for c in codes])
    tan_like = np.asarray([Op(int(c)) is Op.TAN for c in codes], dtype=bool)
    # LOG and LOG10 at the smallest positive double: below fval's clamp
    # of x at 1e-300 they keep falling to these values
    log_floor = np.asarray([LOG_FLOOR.get(Op(int(c)), -_INF) for c in codes])
    log_t = torch.as_tensor(np.isfinite(log_floor), device=dev)
    log_floor_t = torch.as_tensor(log_floor, **f64)
    sin_t = torch.as_tensor(sin_like, device=dev)
    shf_t = torch.as_tensor(sin_shift, **f64)
    tan_t = torch.as_tensor(tan_like, device=dev)

    def frange(lo, hi):
        flo = fval(lo)
        fhi = fval(hi)
        rlo = torch.minimum(flo, fhi)
        rhi = torch.maximum(flo, fhi)
        rlo = torch.where(log_t & (lo < 1e-300), log_floor_t, rlo)
        spans = (lo <= 0.0) & (hi >= 0.0)
        # even (incl. 1/x^even): min at 0 or +inf at the pole
        f0 = fval(torch.zeros_like(lo))
        rlo = torch.where(even_t & spans & ~negpow_t, f0, rlo)
        rhi = torch.where(even_t & spans & negpow_t, inf, rhi)
        # 1/x^odd across the pole: anything
        rlo = torch.where(oddpole_t & spans, -inf, rlo)
        rhi = torch.where(oddpole_t & spans, inf, rhi)
        if sin_like.any():
            two_pi = 2 * math.pi
            s_lo = lo + shf_t
            s_hi = hi + shf_t
            has_max = torch.floor((s_hi - math.pi / 2) / two_pi) >= \
                torch.ceil((s_lo - math.pi / 2) / two_pi)
            has_min = torch.floor((s_hi + math.pi / 2) / two_pi) >= \
                torch.ceil((s_lo + math.pi / 2) / two_pi)
            rhi = torch.where(sin_t & has_max, 1.0, rhi)
            rlo = torch.where(sin_t & has_min, -1.0, rlo)
        if tan_like.any():
            same = torch.floor((lo + math.pi / 2) / math.pi) == \
                torch.floor((hi + math.pi / 2) / math.pi)
            rlo = torch.where(tan_t & ~same, -inf, rlo)
            rhi = torch.where(tan_t & ~same, inf, rhi)
        return rlo, rhi

    # ---- backward: x-range from y in [ylo, yhi] (monotone ops only) ----
    inv_codes = {
        int(Op.EXP): lambda y, k: torch.log(torch.clamp(y, min=1e-300)),
        int(Op.LOG): lambda y, k: torch.exp(torch.clamp(y, -700, 700)),
        int(Op.LOG10): lambda y, k: torch.exp(
            torch.clamp(y * np.log(10.0), -700, 700)),
        int(Op.SQRT): lambda y, k: torch.square(torch.clamp(y, min=0.0)),
        int(Op.TANH): lambda y, k: torch.atanh(
            torch.clamp(y, -1 + 1e-15, 1 - 1e-15)),
        int(Op.ATAN): lambda y, k: torch.tan(
            torch.clamp(y, -math.pi / 2 + 1e-12, math.pi / 2 - 1e-12)),
        int(Op.SINH): lambda y, k: torch.asinh(y),
        int(Op.ASINH): lambda y, k: torch.sinh(torch.clamp(y, -700, 700)),
        int(Op.ASIN): lambda y, k: torch.sin(
            torch.clamp(y, -math.pi / 2, math.pi / 2)),
        int(Op.ATANH): lambda y, k: torch.tanh(y),
    }

    def fback(ylo, yhi):
        """x-interval implied by y in [ylo,yhi]; (-inf,inf) when no rule."""
        xlo = torch.full_like(ylo, -inf)
        xhi = torch.full_like(ylo, inf)
        for c, idx in gidx.items():
            o = Op(c)
            k = gk[c]
            yl, yh = ylo[:, idx], yhi[:, idx]
            if c in inv_codes and int(mono[groups[c][0]]) == 1:
                inv = inv_codes[c]
                a = inv(yl, k)
                b = inv(yh, k)
                a = torch.where(torch.isfinite(yl) & torch.isfinite(a),
                                a, -inf)
                b = torch.where(torch.isfinite(yh) & torch.isfinite(b),
                                b, inf)
                xlo[:, idx] = a
                xhi[:, idx] = b
            elif o in (Op.ABS, Op.SQR):
                if o is Op.ABS:
                    r = torch.clamp(yh, min=0.0)
                else:
                    r = torch.sqrt(torch.clamp(yh, min=0.0))
                r = torch.where(torch.isfinite(yh), r, inf)
                xlo[:, idx] = -r
                xhi[:, idx] = r
            elif o is Op.POWK:
                # per-term parity: even k>0 -> |x| <= yhi^(1/k);
                # odd k>=3 -> monotone root; else no backward rule
                ev = even_t[idx] & (k > 0)
                od = ~even_t[idx] & (k >= 3) & \
                    (torch.abs(k - torch.round(k)) < 1e-12)

                def root(y):
                    return torch.sign(y) * torch.exp(torch.clamp(torch.log(
                        torch.clamp(torch.abs(y), min=1e-300)) / k,
                        -700, 700))
                r = torch.where(torch.isfinite(yh),
                                root(torch.clamp(yh, min=0.0)), inf)
                a_od = torch.where(torch.isfinite(yl), root(yl), -inf)
                b_od = torch.where(torch.isfinite(yh), root(yh), inf)
                xlo[:, idx] = torch.where(ev, -r, torch.where(od, a_od, -inf))
                xhi[:, idx] = torch.where(ev, r, torch.where(od, b_od, inf))
        return xlo, xhi

    return fval, fder, frange, fback
