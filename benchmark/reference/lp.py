"""A plain batched primal-dual interior-point LP solver in PyTorch.

    min c.z  s.t.  G z <= h,  l <= z <= u      (l, u finite; l == u fixes z)

Mehrotra's predictor-corrector on the normal equations
(G' Y/S G + A/P + Bq/Q) dz = rhs, one dense Cholesky a lane and an
iteration, with separate primal and dual step lengths.  It shares nothing
with the program under test: it is the yardstick the node relaxations are
held to.  `dtype` float32 gives the control (the same LP one precision
down).
"""

from __future__ import annotations

import torch

STEP = 0.995


def _max_step(v, dv):
    """Largest alpha in (0, 1] with v + alpha dv >= 0, per lane."""
    ratio = torch.where(dv < 0, -v / dv, torch.full_like(v, float("inf")))
    return torch.clamp(ratio.amin(dim=1), max=1.0)


def solve(c, G, h, l, u, tol=None, max_iters=120):
    """Batched LP: c, l, u (L, n); G (L, m, n); h (L, m), all one dtype and
    device.  Returns (value (L,), z (L, n), converged (L,)).  The value is
    the least primal objective over the iterates whose rows hold to `tol`
    (an upper bound on the optimum); every iterate's duals y >= 0 also give
    a lower bound, -h.y + sum_j min(r_j l_j, r_j u_j) with r = c + G'y,
    valid whatever the dual residual, since the box is finite.  A lane has
    converged where the two bounds meet to `accept` (100 tol: 1e-6 in
    float64), relatively: on some boxes the iterates stall with the two
    bounds 1.2e-7 apart, the dual residual left once mu has gone.  Iterations
    stop where they meet to `tol` or where the factorization breaks.  Lanes
    whose rows cannot hold (a row with no free column and h < 0) get
    +inf."""
    dt = c.dtype
    f64 = dt == torch.float64
    tol = tol if tol is not None else (1e-8 if f64 else 1e-5)
    accept = 100 * tol
    fixed = (u - l) <= 1e-12
    free = ~fixed
    zf = torch.where(fixed, l, torch.zeros_like(l))
    h = h - (G @ zf[:, :, None])[:, :, 0]
    G = G * free[:, None, :].to(dt)
    c_free = torch.where(free, c, torch.zeros_like(c))
    const = (c * zf).sum(dim=1)
    dead = ((G.abs().amax(dim=2) == 0) & (h < 0)).any(dim=1)
    L, m, n = G.shape
    one = torch.ones_like(l)
    width = torch.where(free, u - l, one)
    z = torch.where(free, l + 0.5 * width, l)
    s = torch.clamp(h - (G @ z[:, :, None])[:, :, 0], min=1.0)
    y = torch.ones_like(h)
    a = torch.where(free, one, 0 * one)
    bq = torch.where(free, one, 0 * one)
    stop = torch.zeros(L, dtype=torch.bool, device=c.device)
    inf = float("inf")
    best_ub = torch.full((L,), inf, dtype=dt, device=c.device)
    best_lb = torch.full((L,), -inf, dtype=dt, device=c.device)
    best_z = z.clone()
    hn = 1.0 + h.abs().amax(dim=1)
    eye = torch.eye(n, dtype=dt, device=c.device)
    for _ in range(max_iters):
        p = torch.where(free, z - l, one)
        q = torch.where(free, u - z, one)
        r = c_free + (G.transpose(1, 2) @ y[:, :, None])[:, :, 0]
        rd = torch.where(free, r - a + bq, 0 * r)
        rp = (G @ z[:, :, None])[:, :, 0] + s - h
        mu = ((s * y).sum(1) + (torch.where(free, p * a + q * bq, 0 * p))
              .sum(1)) / (m + 2 * free.sum(1)).clamp(min=1)
        pobj = (c_free * z).sum(1)
        held = torch.clamp((G @ z[:, :, None])[:, :, 0] - h, min=0
                           ).amax(1) / hn <= tol
        lower = -(h * y).sum(1) + torch.where(
            free, torch.minimum(r * l, r * u), 0 * r).sum(1)
        better = held & (pobj < best_ub) & ~stop
        best_ub = torch.where(better, pobj, best_ub)
        best_z = torch.where(better[:, None], z, best_z)
        best_lb = torch.where(~stop & torch.isfinite(lower),
                              torch.maximum(best_lb, lower), best_lb)
        gap = (best_ub - best_lb) / (1.0 + best_ub.abs())
        stop = stop | (gap < tol)
        if bool(stop.all()):
            break
        d = torch.where(free, a / p + bq / q, one)
        M = G.transpose(1, 2) @ ((y / s)[:, :, None] * G) + \
            torch.diag_embed(d)
        M = M + eye * (1e-14 if dt == torch.float64 else 1e-7) * \
            M.diagonal(dim1=1, dim2=2).amax(dim=1)[:, None, None]
        chol, info = torch.linalg.cholesky_ex(M)
        stop = stop | (info != 0) | ~torch.isfinite(M).all(dim=2).all(dim=1)
        if bool(stop.all()):
            break
        chol = torch.where(stop[:, None, None], eye, chol)

        def direction(r_sy, r_pa, r_qb):
            rhs = -rd - (G.transpose(1, 2) @ ((r_sy + y * rp) / s)
                         [:, :, None])[:, :, 0] + r_pa / p - r_qb / q
            rhs = torch.where(free, rhs, 0 * rhs)
            dz = torch.cholesky_solve(rhs[:, :, None], chol)[:, :, 0]
            dz = torch.where(free, dz, 0 * dz)
            ds = -rp - (G @ dz[:, :, None])[:, :, 0]
            dy = (r_sy - y * ds) / s
            da = torch.where(free, (r_pa - a * dz) / p, 0 * dz)
            db = torch.where(free, (r_qb + bq * dz) / q, 0 * dz)
            return dz, ds, dy, da, db

        def steps(dz, ds, dy, da, db):
            big = torch.full_like(dz, 1.0)
            ap = torch.minimum(_max_step(s, ds), torch.minimum(
                _max_step(p, torch.where(free, dz, big)),
                _max_step(q, torch.where(free, -dz, big))))
            ad = torch.minimum(_max_step(y, dy), torch.minimum(
                _max_step(a, torch.where(free, da, big)),
                _max_step(bq, torch.where(free, db, big))))
            return ap, ad

        pa_ = torch.where(free, p * a, 0 * p)
        qb_ = torch.where(free, q * bq, 0 * q)
        aff = direction(-s * y, -pa_, -qb_)
        ap, ad = steps(*aff)
        dz, ds, dy, da, db = aff
        mu_aff = (((s + ap[:, None] * ds) * (y + ad[:, None] * dy)).sum(1) +
                  torch.where(free, (p + ap[:, None] * dz) *
                              (a + ad[:, None] * da) +
                              (q - ap[:, None] * dz) *
                              (bq + ad[:, None] * db), 0 * p).sum(1)) / \
            (m + 2 * free.sum(1)).clamp(min=1)
        sig = ((mu_aff / mu).clamp(min=0) ** 3)[:, None]
        smu = sig * mu[:, None]
        dz, ds, dy, da, db = direction(
            smu - s * y - ds * dy,
            torch.where(free, smu - p * a - dz * da, 0 * p),
            torch.where(free, smu - q * bq + dz * db, 0 * q))
        ap, ad = steps(dz, ds, dy, da, db)
        go = ~stop[:, None]
        ap, ad = STEP * ap[:, None], STEP * ad[:, None]
        z = torch.where(go, z + ap * dz, z)
        s = torch.where(go, s + ap * ds, s)
        y = torch.where(go, y + ad * dy, y)
        a = torch.where(go, a + ad * da, a)
        bq = torch.where(go, bq + ad * db, bq)
    gap = (best_ub - best_lb) / (1.0 + best_ub.abs())
    value = torch.where(dead, torch.full_like(best_ub, inf), best_ub + const)
    return value, best_z, gap < accept
