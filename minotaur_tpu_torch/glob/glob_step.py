"""Batched spatial-B&B superstep for the global (factorable) pipeline.

Port of minotaur_tpu/glob/glob_step.py.  The JAX step is a one-box
function vmapped over the batch; here every function takes (B, nz)
boxes, so each lane builds its own envelope rows and the IPM solves B
LPs whose constraint matrices differ (`engines/ipm.py` on (B, m, nz)
operators).

Reference: QuadHandler.{h,cpp} — secant + tangent relaxation of squares
(getNewSqLf_ :771), McCormick envelopes for bilinear terms
(getNewBilLf_ :702), FBBT over terms (propSqrBnds_/propBilBnds_
:1271-1361), spatial branching candidates from violated terms (:473) —
plus CxUnivarHandler / kPowHandler (secant over/under-estimators and
tangent cuts for univariate y=f(x) terms).

Envelope rows are computed on the device from each node's (vlb, vub)
box — 4 rows per term whose coefficients are functions of the bounds —
so a batch of nodes each gets its own envelopes without shipping
per-node matrices from the host, and tightening a box tightens its
relaxation.  SecantMod — the reference's mutable secant-update
machinery — disappears entirely.  Univariate terms carry static
curvature metadata (glob/univariate.py); the shape selection (convex /
concave / none) depends only on the sign of the box, so S-shaped
functions regain full envelopes after one branch at their inflection.

Each row builder writes its block of the (B, m, nz) matrix in place and
returns the block's row ranges, so one step holds one dense per-lane
matrix, not one per block plus their concatenation.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from ..device import F64, resolve_device
from ..engines.ipm import IPMOptions, build_single_solver, to_device
from ..engines.staging import StagedProblem
from ..ops.interval import _TorchNP, _idiv, _imul, linear_fbbt
from ..utils.types import EngineStatus
from .transformer import GlobStaged
from .univariate import CONVEX, NOENV, make_uni_fns, term_meta

_BIG = 1e20
_XCAP = 1e8
_INF = float("inf")

# packed result: these per-lane scalars, then x, new_vlb, new_vub
_SCALARS = ("status", "obj", "dual_bound", "int_feasible", "term_feasible",
            "branch_var", "branch_val", "is_spatial", "fbbt_infeas")


class GlobStepResult(NamedTuple):
    status: "np.ndarray"
    obj: "np.ndarray"
    dual_bound: "np.ndarray"
    x: "np.ndarray"             # (B, nz)
    int_feasible: "np.ndarray"
    term_feasible: "np.ndarray"
    branch_var: "np.ndarray"    # int or spatial variable (-1 none)
    branch_val: "np.ndarray"
    is_spatial: "np.ndarray"    # bool
    new_vlb: "np.ndarray"
    new_vub: "np.ndarray"
    fbbt_infeas: "np.ndarray"


@dataclasses.dataclass(frozen=True)
class GlobStepOptions:
    int_tol: float = 1e-6
    term_tol: float = 1e-6
    fbbt_rounds: int = 2
    rlt_cuts: int = 0            # max RLT bound-factor cut candidates
    ipm: IPMOptions = IPMOptions()


# A row builder: (vlb, vub, A, r0) -> (lb, ub); writes its rows into
# A[:, r0:r0 + rows] (zero on entry) and returns their (B, rows) ranges.
Builder = Tuple[int, Callable]


def _long(a, dev):
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)


def _uni_static(gs: GlobStaged, dev) -> dict:
    """The univariate terms' static metadata on the device: input and
    output columns, domain, and curvature class per side of 0."""
    metas = [term_meta(int(f), float(k)) for f, k in zip(gs.uni_f, gs.uni_k)]
    out = {key: torch.as_tensor([m[key] for m in metas], dtype=F64,
                                device=dev) for key in ("dom_lo", "dom_hi")}
    out.update({key: _long([m[key] for m in metas], dev)
                for key in ("shape_neg", "shape_span", "shape_pos")})
    out.update(ux=_long(gs.uni_x, dev), uy=_long(gs.uni_y, dev))
    return out


def _scatter(A, r0, rows, cols, vals):
    """A[b, r0 + rows[k], cols[k]] += vals[b, k] for every lane b."""
    lanes = torch.arange(A.shape[0], device=A.device)[:, None]
    A.index_put_((lanes, r0 + rows, cols), vals, accumulate=True)


def _row_builders(gs: GlobStaged, opts: GlobStepOptions,
                  dev: torch.device, fns=None) -> List[Builder]:
    """The step's envelope blocks in row order: McCormick and square
    rows, univariate rows, RLT rows, trilinear and quadrilinear
    lambda-hull link rows (each present only when its terms are)."""
    nz, n_y, n_u, n_t, n_q = gs.n, gs.n_y, gs.n_u, gs.n_t, gs.n_q
    out: List[Builder] = []

    if n_y:
        # row layout per term t: [4t, 4t+1] lower rows (>= rhs),
        # [4t+2, 4t+3] upper rows (<= rhs); squares: 0,1,2 lower
        # (tangents), 3 upper (secant)
        m_env = 4 * n_y
        rows = np.arange(m_env)
        tidx, kind = rows // 4, rows % 4
        xi = _long(gs.term_i[tidx], dev)
        xj = _long(gs.term_j[tidx], dev)
        sq = torch.as_tensor((gs.term_i == gs.term_j)[tidx], device=dev)
        k0, k1, k2 = (torch.as_tensor(kind == v, device=dev)
                      for v in (0, 1, 2))
        lower_row = torch.as_tensor(
            np.where(gs.term_i[tidx] == gs.term_j[tidx], kind < 3, kind < 2),
            device=dev)
        rows3 = _long(np.concatenate([rows, rows, rows]), dev)
        cols3 = torch.cat([xi, xj, _long(gs.term_y[tidx], dev)])

        def envelopes(vlb, vub, A, r0):
            """squares  y = x^2 (li, ui finite where used):
              k=0: tangent at li : -2 li x + y >= -li^2
              k=1: tangent at ui : -2 ui x + y >= -ui^2
              k=2: tangent at mid: -2 t  x + y >= -t^2
              k=3: secant        : -(l+u) x + y <= -l u
            bilinear y = xi xj (McCormick):
              k=0: -lj xi - li xj + y >= -li lj
              k=1: -uj xi - ui xj + y >= -ui uj
              k=2: -uj xi - li xj + y <= -li uj
              k=3: -lj xi - ui xj + y <= -ui lj
            rows touching an infinite bound deactivate ((-inf, inf))."""
            li, ui = vlb[:, xi], vub[:, xi]
            lj, uj = vlb[:, xj], vub[:, xj]
            fin_li, fin_ui = li.abs() < _BIG, ui.abs() < _BIG
            fin_lj, fin_uj = lj.abs() < _BIG, uj.abs() < _BIG
            cl_li = torch.clamp(li, -1e8, 1e8)
            cl_ui = torch.clamp(ui, -1e8, 1e8)
            mid = 0.5 * (torch.where(fin_li, cl_li, 0.0) +
                         torch.where(fin_ui, cl_ui, 0.0))
            w = torch.where
            a_xi_sq = w(k0, -2 * cl_li, w(k1, -2 * cl_ui,
                                          w(k2, -2 * mid, -(cl_li + cl_ui))))
            a_xi_bil = w(k0, -lj, w(k1, -uj, w(k2, -uj, -lj)))
            a_xj_bil = w(k0, -li, w(k1, -ui, w(k2, -li, -ui)))
            rhs_sq = w(k0, -cl_li ** 2, w(k1, -cl_ui ** 2,
                                          w(k2, -mid ** 2, -cl_li * cl_ui)))
            rhs_bil = w(k0, -li * lj, w(k1, -ui * uj,
                                        w(k2, -li * uj, -ui * lj)))
            ok_sq = w(k0, fin_li, w(k1, fin_ui,
                                    w(k2, fin_li | fin_ui, fin_li & fin_ui)))
            ok_bil = w(k0, fin_lj & fin_li, w(k1, fin_uj & fin_ui,
                       w(k2, fin_uj & fin_li, fin_lj & fin_ui)))
            ok = w(sq, ok_sq, ok_bil)
            a_xi = w(sq, a_xi_sq, a_xi_bil)
            a_xj = w(sq, 0.0, a_xj_bil)
            rhs = w(sq, rhs_sq, rhs_bil)
            vals = torch.cat([w(ok, a_xi, 0.0), w(ok, a_xj, 0.0),
                              ok.to(F64)], dim=1)
            _scatter(A, r0, rows3, cols3, vals)
            return (w(ok & lower_row, rhs, -_INF),
                    w(ok & ~lower_row, rhs, _INF))

        out.append((m_env, envelopes))

    if n_u:
        u = _uni_static(gs, dev)
        u_dom_lo, u_dom_hi, ux, uy = u["dom_lo"], u["dom_hi"], u["ux"], u["uy"]
        fval, fder = fns[0], fns[1]
        m_uenv = 4 * n_u
        urows = _long(np.arange(m_uenv), dev)
        rows2 = torch.cat([urows, urows])
        cols2 = torch.cat([ux.repeat_interleave(4), uy.repeat_interleave(4)])

        def uni_envelopes(vlb, vub, A, r0):
            """4 rows per univariate term y = f(x): tangents at lo/mid/hi
            + the secant.  Shape (convex/concave/none over this box)
            selects row direction; tangents of a convex (concave) f at
            any point of the box are global under-(over-)estimators on
            the box, so tangent points may be clipped; the secant
            requires both true endpoints finite (reference
            CxUnivarHandler secant/tangent logic)."""
            lo = torch.minimum(torch.maximum(vlb[:, ux], u_dom_lo), u_dom_hi)
            hi = torch.minimum(torch.maximum(vub[:, ux], u_dom_lo), u_dom_hi)
            shape = torch.where(lo >= 0.0, u["shape_pos"],
                                torch.where(hi <= 0.0, u["shape_neg"],
                                            u["shape_span"]))
            lo_c = torch.clamp(lo, -_XCAP, _XCAP)
            hi_c = torch.clamp(hi, -_XCAP, _XCAP)
            mid = 0.5 * (lo_c + hi_c)
            flo, fhi, fmid = fval(lo_c), fval(hi_c), fval(mid)
            dlo, dhi, dmid = fder(lo_c), fder(hi_c), fder(mid)
            width = hi - lo
            sec_ok = torch.isfinite(lo) & torch.isfinite(hi) & \
                (lo.abs() < _BIG) & (hi.abs() < _BIG) & \
                torch.isfinite(flo) & torch.isfinite(fhi) & \
                (flo.abs() < _BIG) & (fhi.abs() < _BIG) & (width > 1e-12)
            sec = torch.where(sec_ok, (fhi - flo) /
                              torch.clamp(width, min=1e-12), 0.0)
            # the 4 row kinds: 0=tan@lo, 1=tan@hi, 2=tan@mid, 3=secant
            slope = torch.stack([dlo, dhi, dmid, sec], dim=2)  # (B, n_u, 4)
            fv = torch.stack([flo, fhi, fmid, flo], dim=2)
            pt = torch.stack([lo_c, hi_c, mid, lo_c], dim=2)
            # row:  -slope * x + y  {>=,<=}  f(pt) - slope*pt
            rhs = fv - slope * pt
            env = (shape != NOENV)[:, :, None]
            ok4 = env & torch.isfinite(slope) & (slope.abs() < _BIG) & \
                torch.isfinite(rhs) & (rhs.abs() < _BIG)
            ok4[:, :, 3] &= sec_ok
            # convex: tangents lower rows, secant upper; concave mirrored
            convex = (shape == CONVEX)[:, :, None]
            lower = torch.cat([convex.expand(-1, -1, 3), ~convex], dim=2)
            B = vlb.shape[0]
            slope_f = slope.reshape(B, m_uenv)
            rhs_f = rhs.reshape(B, m_uenv)
            ok_f = ok4.reshape(B, m_uenv)
            lower_f = lower.reshape(B, m_uenv)
            vals = torch.cat([torch.where(ok_f, -slope_f, 0.0),
                              ok_f.to(F64)], dim=1)
            _scatter(A, r0, rows2, cols2, vals)
            return (torch.where(ok_f & lower_f, rhs_f, -_INF),
                    torch.where(ok_f & ~lower_f, rhs_f, _INF))

        out.append((m_uenv, uni_envelopes))

    if opts.rlt_cuts > 0 and n_y:
        from .rlt import build_rlt_rows_fn, enumerate_rlt
        cand = enumerate_rlt(gs, max_cuts=opts.rlt_cuts)
        if cand is not None:
            rlt_fn = build_rlt_rows_fn(cand, nz, dev)

            def rlt_rows(vlb, vub, A, r0):
                rA, lb, ub = rlt_fn(vlb, vub)
                A[:, r0:r0 + rA.shape[1]] = rA
                return lb, ub

            out.append((4 * cand.count, rlt_rows))

    for arity, n_g, vars_, ys, lam0 in (
            (3, n_t, gs.tri_vars, gs.tri_y, gs.tri_lam0),
            (4, n_q, gs.quad_vars, gs.quad_y, gs.quad_lam0)):
        if n_g:
            out.append(_hull_rows(arity, n_g, vars_, ys, lam0, dev))
    return out


def _hull_rows(k: int, n_g: int, vars_, ys, lam0, dev) -> Builder:
    """x_i = sum_v val_i(v) lam_v and y = sum_v prod(v) lam_v — the exact
    convex hull of a k-linear monomial over the box (vertex/lambda
    formulation; k = 3 trilinear, k = 4 the arity-4 member of the
    reference's grouped multilinear hulls, MultilinearTermsHandler
    `ml_*`).  Equality rhs 0 is static; only the lambda coefficients
    depend on the box.  Rows: k + 1 per group (the x_i rows, then y)."""
    nv = 1 << k
    per = k + 1
    tv = torch.as_tensor(np.asarray(vars_, dtype=np.int64), device=dev)
    lam = np.asarray(lam0, dtype=np.int64)[:, None] + np.arange(nv)[None]
    bits = np.array([[(v >> i) & 1 for i in range(k)] for v in range(nv)])
    bits_t = torch.as_tensor(bits[None, :, :] == 1, device=dev)
    xrows = np.arange(n_g)[:, None] * per + np.arange(k)[None, :]  # (G, k)
    yrow = np.arange(n_g) * per + k
    # static entries e_{x_i} and e_y, then per x_i row its nv lambda
    # columns, then the y row's
    rows = np.concatenate(
        [xrows.reshape(-1), yrow] +
        [np.repeat(xrows[:, i], nv) for i in range(k)] +
        [np.repeat(yrow, nv)])
    cols = np.concatenate(
        [np.asarray(vars_, dtype=np.int64).reshape(-1),
         np.asarray(ys, dtype=np.int64)] + [lam.reshape(-1)] * (k + 1))
    rows_t = torch.as_tensor(rows, device=dev)
    cols_t = torch.as_tensor(cols, device=dev)
    n_static = n_g * per

    def hull_rows(vlb, vub, A, r0):
        B = vlb.shape[0]
        lo, hi = vlb[:, tv], vub[:, tv]                    # (B, G, k)
        vals = torch.where(bits_t, hi[:, :, None, :], lo[:, :, None, :])
        prod = vals[..., 0]
        for i in range(1, k):
            prod = prod * vals[..., i]                     # (B, G, nv)
        dyn = [-vals[..., i].reshape(B, -1) for i in range(k)]
        v = torch.cat([vlb.new_ones((B, n_static))] + dyn +
                      [-prod.reshape(B, -1)], dim=1)
        _scatter(A, r0, rows_t, cols_t, v)
        zeros = vlb.new_zeros((B, n_g * per))
        return zeros, zeros

    return n_g * per, hull_rows


def build_envelope_fn(gs: GlobStaged,
                      opts: GlobStepOptions = GlobStepOptions(),
                      device="cuda") -> Callable:
    """(vlb, vub) (B, nz) -> (env_A (B, rows, nz), env_lb, env_ub) over ALL
    terms (bilinear, univariate, RLT, multilinear hulls), for callers
    outside the step (root OBBT uses the node envelopes at the root
    box)."""
    dev = resolve_device(device)
    fns = make_uni_fns(gs.uni_f, gs.uni_k, dev) if gs.n_u else None
    builders = _row_builders(gs, opts, dev, fns)
    m_env = sum(r for r, _ in builders)

    def env_fn(vlb, vub):
        vlb, vub = to_device(vlb, dev), to_device(vub, dev)
        A = torch.zeros((vlb.shape[0], m_env, gs.n), dtype=F64, device=dev)
        lbs, ubs = [], []
        r0 = 0
        for rows, fn in builders:
            lb, ub = fn(vlb, vub, A, r0)
            lbs.append(lb)
            ubs.append(ub)
            r0 += rows
        if not builders:
            empty = vlb.new_zeros((vlb.shape[0], 0))
            return A, empty, empty
        return A, torch.cat(lbs, dim=1), torch.cat(ubs, dim=1)

    return env_fn


def build_glob_step(gs: GlobStaged, opts: GlobStepOptions = GlobStepOptions(),
                    device="cuda") -> Callable:
    """Returns step(vlb_b, vub_b, x0_b) -> GlobStepResult with numpy
    fields for a batch of (B, nz) boxes.  `step.dispatch` returns the
    packed (B, 9 + 3 nz) float64 device tensor (the scalars of
    `_SCALARS`, then x, new_vlb, new_vub) and `step.unpack` makes its
    one device-to-host copy."""
    dev = resolve_device(device)
    n_y, n_u, nz = gs.n_y, gs.n_u, gs.n
    m_base = gs.A.shape[0]
    f64 = dict(dtype=F64, device=dev)
    fns = make_uni_fns(gs.uni_f, gs.uni_k, dev) if n_u else None
    builders = _row_builders(gs, opts, dev, fns)
    m_extra = sum(r for r, _ in builders)
    n_hull = 4 * gs.n_t + 5 * gs.n_q
    # engine over the extended row space; envelope rows staged as free
    # rows, the lambda-hull link rows as STATIC equalities (rhs 0) whose
    # coefficients vary per lane: the IPM classifies equality rows once,
    # from these static clb/cub
    sp_ext = StagedProblem(
        name=gs.name, n=nz, m=m_base + m_extra, c=gs.c,
        obj_const=gs.obj_const, Qobj=None, obj_nl=None,
        A=np.vstack([gs.A, np.zeros((m_extra, nz))]),
        clb=np.concatenate([gs.clb, np.full(m_extra - n_hull, -np.inf),
                            np.zeros(n_hull)]),
        cub=np.concatenate([gs.cub, np.full(m_extra - n_hull, np.inf),
                            np.zeros(n_hull)]),
        vlb=gs.vlb, vub=gs.vub, int_mask=gs.int_mask,
        nl_rows=np.zeros(0, np.int32), con_nl=None, nl_graphs=[])
    solve_one = build_single_solver(sp_ext, opts.ipm, dev)
    A_base = torch.as_tensor(gs.A, **f64)
    clb_base = torch.as_tensor(gs.clb, **f64)
    cub_base = torch.as_tensor(gs.cub, **f64)
    int_mask = torch.as_tensor(gs.int_mask, device=dev)
    has_ints = bool(gs.int_mask.any())
    jnp = _TorchNP

    ti, tj, ty = (_long(a, dev) for a in (gs.term_i, gs.term_j, gs.term_y))
    is_sq = torch.as_tensor(gs.term_i == gs.term_j, device=dev)
    if n_u:
        fval, _, frange, fback = fns
        u = _uni_static(gs, dev)
        u_dom_lo, u_dom_hi, ux, uy = u["dom_lo"], u["dom_hi"], u["ux"], u["uy"]
        u_sh_span = u["shape_span"]

    def smax(v, idx, src):
        return v.scatter_reduce(1, idx.expand(v.shape[0], -1), src, "amax")

    def smin(v, idx, src):
        return v.scatter_reduce(1, idx.expand(v.shape[0], -1), src, "amin")

    def term_fbbt(vlb, vub, infeas):
        """Interval propagation through y = xi*xj both ways (reference
        propSqrBnds_/propBilBnds_), on all terms of all lanes; factor
        bounds take the max/min over the terms touching the variable."""
        li, ui = vlb[:, ti], vub[:, ti]
        lj, uj = vlb[:, tj], vub[:, tj]
        ylo, yhi = vlb[:, ty], vub[:, ty]
        # forward: y in product interval
        plo, phi = _imul(jnp, li, ui, lj, uj)
        sq_lo = torch.where((li <= 0) & (ui >= 0), 0.0,
                            torch.minimum(li * li, ui * ui))
        sq_hi = torch.maximum(li * li, ui * ui)
        plo = torch.where(is_sq, sq_lo, plo)
        phi = torch.where(is_sq, sq_hi, phi)
        nylo = torch.maximum(ylo, plo)
        nyhi = torch.minimum(yhi, phi)
        infeas = infeas | (nylo > nyhi + 1e-9).any(dim=1)

        # backward: xi from y / xj ; xj from y / xi ; squares via sqrt
        bi_lo, bi_hi = _idiv(jnp, nylo, nyhi, lj, uj)
        bj_lo, bj_hi = _idiv(jnp, nylo, nyhi, li, ui)
        s = torch.sqrt(torch.clamp(nyhi, min=0.0))
        smin_ = torch.sqrt(torch.clamp(nylo, min=0.0))
        sq_xlo = torch.where(li >= 0.0, smin_, -s)
        sq_xhi = torch.where(ui <= 0.0, -smin_, s)
        bi_lo = torch.where(is_sq, sq_xlo, bi_lo)
        bi_hi = torch.where(is_sq, sq_xhi, bi_hi)

        nvlb = smax(vlb, ty, nylo)
        nvub = smin(vub, ty, nyhi)
        nvlb = smax(nvlb, ti, torch.where(torch.isnan(bi_lo), -_INF, bi_lo))
        nvub = smin(nvub, ti, torch.where(torch.isnan(bi_hi), _INF, bi_hi))
        keep = ~is_sq
        nvlb = smax(nvlb, tj, torch.where(keep & ~torch.isnan(bj_lo),
                                          bj_lo, -_INF))
        nvub = smin(nvub, tj, torch.where(keep & ~torch.isnan(bj_hi),
                                          bj_hi, _INF))
        infeas = infeas | (nvlb > nvub + 1e-9).any(dim=1)
        return nvlb, nvub, infeas

    def uni_fbbt(vlb, vub, infeas):
        """Interval propagation through y = f(x) both ways + domain
        clamping (x must lie in dom(f) for the term to be defined)."""
        lo = torch.maximum(vlb[:, ux], u_dom_lo)
        hi = torch.minimum(vub[:, ux], u_dom_hi)
        infeas = infeas | (lo > hi + 1e-9).any(dim=1)
        lo_s = torch.minimum(lo, hi)
        rlo, rhi = frange(lo_s, hi)
        nylo = torch.maximum(vlb[:, uy], rlo)
        nyhi = torch.minimum(vub[:, uy], rhi)
        infeas = infeas | (nylo > nyhi + 1e-9).any(dim=1)
        bxlo, bxhi = fback(nylo, nyhi)
        bxlo = torch.where(torch.isnan(bxlo), -_INF, bxlo)
        bxhi = torch.where(torch.isnan(bxhi), _INF, bxhi)
        nvlb = smax(vlb, ux, torch.minimum(torch.maximum(lo, bxlo), hi))
        nvub = smin(vub, ux, torch.maximum(torch.minimum(hi, bxhi), lo_s))
        nvlb = smax(nvlb, uy, nylo)
        nvub = smin(nvub, uy, nyhi)
        infeas = infeas | (nvlb > nvub + 1e-9).any(dim=1)
        return nvlb, nvub, infeas

    def fbbt_rounds(vlb, vub):
        """`fbbt_rounds` sweeps of linear rows, terms and integer
        rounding; returns (vlb, vub, infeasible (B,))."""
        infeas = torch.zeros(vlb.shape[0], dtype=torch.bool, device=dev)
        for _ in range(opts.fbbt_rounds):
            vlb, vub, bad = linear_fbbt(A_base, clb_base, cub_base, vlb, vub)
            infeas = infeas | bad
            if n_y:
                vlb, vub, infeas = term_fbbt(vlb, vub, infeas)
            if n_u:
                vlb, vub, infeas = uni_fbbt(vlb, vub, infeas)
            if has_ints:
                vlb = torch.where(int_mask, torch.ceil(vlb - opts.int_tol),
                                  vlb)
                vub = torch.where(int_mask, torch.floor(vub + opts.int_tol),
                                  vub)
                infeas = infeas | (vlb > vub + 1e-9).any(dim=1)
        return vlb, vub, infeas

    def relaxation(vlb, vub):
        """The lanes' LP rows: (A (B, m, nz), clb, cub (B, m))."""
        B = vlb.shape[0]
        A = torch.zeros((B, m_base + m_extra, nz), **f64)
        A[:, :m_base] = A_base
        lbs, ubs = [clb_base.expand(B, m_base)], [cub_base.expand(B, m_base)]
        r0 = m_base
        for rows, fn in builders:
            lb, ub = fn(vlb, vub, A, r0)
            lbs.append(lb)
            ubs.append(ub)
            r0 += rows
        return A, torch.cat(lbs, dim=1), torch.cat(ubs, dim=1)

    def branching(x, vlb, vub):
        """Integer first, else the worst term's spatial variable and
        its safeguarded branch point; (int_ok, term_ok, bvar, bval,
        is_spatial)."""
        B = x.shape[0]
        lane = torch.arange(B, device=dev)
        full = lambda v, dt=F64: torch.full((B,), v, dtype=dt,  # noqa
                                            device=dev)
        if has_ints:
            frac = torch.where(int_mask, (x - torch.round(x)).abs(), 0.0)
            int_bvar = frac.argmax(dim=1)
            int_ok = frac.amax(dim=1) <= opts.int_tol
        else:
            int_ok = full(True, torch.bool)
            int_bvar = full(-1, torch.long)

        # term violations -> spatial branching candidate
        xscale = torch.clamp(x.abs().amax(dim=1), min=1.0)
        bil_viol, uni_viol = full(0.0), full(0.0)
        sp_var_bil = sp_var_uni = full(-1, torch.long)
        sp_val_uni = full(0.0)
        uni_bias0 = full(False, torch.bool)
        if n_y:
            viol = (x[:, ty] - x[:, ti] * x[:, tj]).abs()
            worst = viol.argmax(dim=1)
            bil_viol = viol.amax(dim=1)
            # branch on the factor with the wider box
            vi, vj = ti[worst], tj[worst]
            wi = torch.clamp(vub[lane, vi], -1e8, 1e8) - \
                torch.clamp(vlb[lane, vi], -1e8, 1e8)
            wj = torch.clamp(vub[lane, vj], -1e8, 1e8) - \
                torch.clamp(vlb[lane, vj], -1e8, 1e8)
            sp_var_bil = torch.where(wi >= wj, vi, vj)
        if n_u:
            xc = torch.minimum(torch.maximum(x[:, ux], u_dom_lo), u_dom_hi)
            uviol = (x[:, uy] - fval(xc)).abs()
            uworst = uviol.argmax(dim=1)
            uni_viol = uviol.amax(dim=1)
            sp_var_uni = ux[uworst]
            # bias the branch point to the inflection when the box spans
            # it and the spanning shape has no envelope (x^odd, tanh, ...)
            spans = (vlb[lane, sp_var_uni] < -1e-12) & \
                (vub[lane, sp_var_uni] > 1e-12)
            uni_bias0 = spans & (u_sh_span[uworst] == NOENV)
            sp_val_uni = torch.where(uni_bias0, 0.0, x[lane, sp_var_uni])
        term_ok = torch.maximum(bil_viol, uni_viol) <= opts.term_tol * xscale
        use_uni = uni_viol > bil_viol
        sp_var = torch.where(use_uni, sp_var_uni, sp_var_bil)

        use_int = ~int_ok if has_ints else full(False, torch.bool)
        bvar = torch.where(use_int, int_bvar,
                           torch.where(term_ok, -1, sp_var))
        is_spatial = ~use_int & ~term_ok
        bsafe = torch.clamp(bvar, min=0)
        bval_raw = torch.where(use_uni & is_spatial, sp_val_uni,
                               x[lane, bsafe])
        # safeguarded spatial branch point (reference keeps it interior)
        lo_b = torch.clamp(vlb[lane, bsafe], -1e8, 1e8)
        hi_b = torch.clamp(vub[lane, bsafe], -1e8, 1e8)
        w = hi_b - lo_b
        bval = torch.where(
            is_spatial,
            torch.minimum(torch.maximum(bval_raw, lo_b + 0.1 * w),
                          hi_b - 0.1 * w),
            bval_raw)
        # branch exactly at an interior inflection (restores envelopes in
        # both children for S-shaped univariate terms)
        bval = torch.where(is_spatial & use_uni & uni_bias0, 0.0, bval)
        return int_ok, term_ok, bvar, bval, is_spatial

    def step_b(vlb, vub, x0):
        vlb, vub, infeas = fbbt_rounds(vlb, vub)
        A, clb, cub = relaxation(vlb, vub)
        svlb = torch.where(vlb > vub, vub, vlb)
        res = solve_one(A, clb, cub, svlb, vub, x0)
        del A
        int_ok, term_ok, bvar, bval, is_spatial = branching(res.x, vlb, vub)
        status = torch.where(
            infeas, int(EngineStatus.SOLVED_INFEASIBLE), res.status)
        db = torch.where(infeas, _BIG, res.dual_bound)
        return dict(
            status=status, obj=res.obj, dual_bound=db, x=res.x,
            int_feasible=int_ok & ~infeas, term_feasible=term_ok & ~infeas,
            branch_var=bvar, branch_val=bval, is_spatial=is_spatial,
            new_vlb=vlb, new_vub=vub, fbbt_infeas=infeas)

    def dispatch(vlb_b, vub_b, x0_b):
        r = step_b(to_device(vlb_b, dev), to_device(vub_b, dev),
                   to_device(x0_b, dev))
        return torch.cat([torch.stack([r[k].to(F64) for k in _SCALARS],
                                      dim=1),
                          r["x"], r["new_vlb"], r["new_vub"]], dim=1)

    def unpack(packed) -> GlobStepResult:
        a = packed.cpu().numpy()
        s = {k: a[:, i] for i, k in enumerate(_SCALARS)}
        o = len(_SCALARS)
        return GlobStepResult(
            status=s["status"].astype(np.int32), obj=s["obj"],
            dual_bound=s["dual_bound"], x=a[:, o:o + nz],
            int_feasible=s["int_feasible"] > 0.5,
            term_feasible=s["term_feasible"] > 0.5,
            branch_var=s["branch_var"].astype(np.int32),
            branch_val=s["branch_val"], is_spatial=s["is_spatial"] > 0.5,
            new_vlb=a[:, o + nz:o + 2 * nz], new_vub=a[:, o + 2 * nz:],
            fbbt_infeas=s["fbbt_infeas"] > 0.5)

    def step(vlb_b, vub_b, x0_b) -> GlobStepResult:
        return unpack(dispatch(vlb_b, vub_b, x0_b))

    step.dispatch = dispatch
    step.unpack = unpack
    step.device = dev
    return step
