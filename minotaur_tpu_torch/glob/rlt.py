"""RLT (reformulation-linearization) cuts for the glob pipeline.

Port of minotaur_tpu/glob/rlt.py: the host-side enumeration
(`enumerate_rlt`, `enumerate_rlt_row_products`,
`append_rlt_row_products`) is the JAX package's, as it is;
`build_rlt_rows_fn` computes the rows for a whole batch of boxes.

Reference: SimplexQuadCutGen.{h,cpp} — cuts for quadratic constraints
generated by multiplying simplex-tableau rows with variable bound
factors at the LP optimum (SimplexQuadCutGen.h:27-50, the TableauInfo
machinery).  The TPU-native IPM keeps no tableau, so the design is
inverted: the *candidate set* — (base row) x (bound factor) products
whose every cross term x_k*x_i has a registered product column y_{ki} —
is enumerated once at transform time on the host, and the cut
*coefficients* are computed inside the jitted step from the node box,
exactly like the McCormick envelope rows in glob_step.py.  A batch of
nodes therefore each gets its own RLT rows, tightened automatically as
branching shrinks the box, with no host-device traffic.

Validity: for a row  l_r <= a.z <= u_r  and a factor variable k with
l_k <= z_k <= u_k, the four products

  (u_k - z_k)(u_r - a.z) >= 0      (z_k - l_k)(u_r - a.z) >= 0
  (u_k - z_k)(a.z - l_r) >= 0      (z_k - l_k)(a.z - l_r) >= 0

hold at every feasible point.  Expanding and substituting each product
z_k z_i by its defining column y_{ki} (exact at feasible points of the
reformulation) yields linear inequalities that never cut a feasible
point — pruning stays sound.  Only the +-(l_k|u_k) * a_r part and the
right-hand side depend on the box; everything else is static.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

_FIN = 1e8  # bounds beyond this are treated as infinite for RLT


@dataclasses.dataclass
class RLTCandidates:
    """Static data for C candidate (row, var) pairs over nz columns."""
    k: np.ndarray        # (C,) factor variable column
    row: np.ndarray      # (C,) base row index
    Y: np.ndarray        # (C, nz) quadratic part: sum_i a_i on column y_{ki}
    Arow: np.ndarray     # (C, nz) the base row a_r
    lr: np.ndarray       # (C,) row lower bounds
    ur: np.ndarray       # (C,) row upper bounds
    diag_c: np.ndarray   # (C,) a_k when x_k^2 has no product column, else 0

    @property
    def count(self) -> int:
        return len(self.k)


def enumerate_rlt(gs, max_cuts: int = 16, max_support: int = 24,
                  min_subs: int = 2) -> Optional[RLTCandidates]:
    """Host-side candidate enumeration (once per instance).

    A pair (row r, variable k) qualifies when every support column i of
    row r has a registered product column y_{ki}.  The diagonal term
    x_k^2 is special-cased: when no square column exists, the leftover
    +-a_k x_k^2 is over-estimated in-trace (secant for a positive
    coefficient, midpoint tangent for a negative one) which keeps the
    cut valid, just looser.  Pairs are ranked by substitution count
    (more quadratic content first, mirroring the reference's preference
    for rows rich in nonbasic quadratic terms) and capped at
    ``max_cuts``.
    """
    tmap = {}
    for t in range(gs.n_y):
        i, j = int(gs.term_i[t]), int(gs.term_j[t])
        tmap[(min(i, j), max(i, j))] = int(gs.term_y[t])
    if not tmap:
        return None
    factor_vars = sorted({i for i, _ in tmap} | {j for _, j in tmap})
    A, clb, cub = gs.A, gs.clb, gs.cub
    nz = gs.n
    scored = []
    for r in range(A.shape[0]):
        lo_fin = np.isfinite(clb[r]) and abs(clb[r]) < _FIN
        hi_fin = np.isfinite(cub[r]) and abs(cub[r]) < _FIN
        if not (lo_fin or hi_fin):
            continue
        supp = np.nonzero(np.abs(A[r]) > 1e-12)[0]
        if len(supp) == 0 or len(supp) > max_support:
            continue
        for k in factor_vars:
            subs = []
            diag = 0.0
            for i in supp:
                y = tmap.get((min(k, int(i)), max(k, int(i))))
                if y is None:
                    if int(i) == k:
                        diag = float(A[r, k])  # in-trace over-estimator
                        continue
                    subs = None
                    break
                subs.append((int(i), y))
            if subs is None or len(subs) < min_subs:
                continue
            scored.append((len(subs), r, k, subs, diag))
    if not scored:
        return None
    scored.sort(key=lambda t: (-t[0], t[1], t[2]))
    scored = scored[:max_cuts]
    C = len(scored)
    kk = np.zeros(C, np.int32)
    rr = np.zeros(C, np.int32)
    dc = np.zeros(C)
    Y = np.zeros((C, nz))
    for c, (_, r, k, subs, diag) in enumerate(scored):
        kk[c] = k
        rr[c] = r
        dc[c] = diag
        for i, y in subs:
            Y[c, y] += A[r, i]
    return RLTCandidates(k=kk, row=rr, Y=Y, Arow=np.asarray(A[rr]),
                         lr=np.asarray(clb[rr]), ur=np.asarray(cub[rr]),
                         diag_c=dc)


def enumerate_rlt_row_products(gs, max_cuts: int = 8,
                               max_support: int = 12):
    """Row x row RLT products — the IPM-compatible analogue of the
    reference's simplex-TABLEAU row products (SimplexQuadCutGen.cpp:640:
    products of tableau rows at the LP optimum).  With no tableau, the
    basis-free reshape takes products of the PROBLEM rows' slack
    factors: for rows r, s with finite sides, each side is a nonnegative
    factor f = beta - alpha.z with (alpha, beta) in
    {(a_r, u_r), (-a_r, -l_r)}, and

        (beta_r - alpha_r.z)(beta_s - alpha_s.z) >= 0

    expands into a STATIC valid linear row of the lifted (z, y) space
    once every support product z_i z_j has a registered column y_{ij}
    (exact at feasible points of the reformulation, so the rows never
    cut a feasible point).  Self-products (r == s) give the square rows
    (beta_r - alpha_r.z)^2 >= 0.  Unlike the bound-factor family these
    rows have NO box dependence, so they are appended to the master
    once, at transform time.

    Returns (A_new (R, nz), lb (R,), ub (R,)) or None.
    """
    tmap = {}
    for t in range(gs.n_y):
        i, j = int(gs.term_i[t]), int(gs.term_j[t])
        tmap[(min(i, j), max(i, j))] = int(gs.term_y[t])
    if not tmap:
        return None
    A, clb, cub = gs.A, gs.clb, gs.cub
    nz = gs.n
    # eligible rows: small support, at least one finite side
    rows = []
    for r in range(A.shape[0]):
        supp = np.nonzero(np.abs(A[r]) > 1e-12)[0]
        if len(supp) == 0 or len(supp) > max_support:
            continue
        sides = []
        if np.isfinite(cub[r]) and abs(cub[r]) < _FIN:
            sides.append((A[r], float(cub[r])))           # u_r - a.z >= 0
        if np.isfinite(clb[r]) and abs(clb[r]) < _FIN:
            sides.append((-A[r], -float(clb[r])))         # a.z - l_r >= 0
        if sides:
            rows.append((r, supp, sides))
    out_rows = []
    scored = []
    for ri in range(len(rows)):
        for si in range(ri, len(rows)):
            r, supp_r, sides_r = rows[ri]
            s, supp_s, sides_s = rows[si]
            # every cross product needs a registered column
            subs = {}
            ok = True
            for i in supp_r:
                for j in supp_s:
                    y = tmap.get((min(int(i), int(j)),
                                  max(int(i), int(j))))
                    if y is None:
                        ok = False
                        break
                    subs[(int(i), int(j))] = y
                if not ok:
                    break
            if not ok:
                continue
            scored.append((len(subs), r, s, supp_r, supp_s,
                           sides_r, sides_s, subs))
    if not scored:
        return None
    scored.sort(key=lambda t: (-t[0], t[1], t[2]))
    for _, r, s, supp_r, supp_s, sides_r, sides_s, subs in scored:
        for ar, br in sides_r:
            for as_, bs in sides_s:
                row = np.zeros(nz)
                # linear part: -(b_r * alpha_s + b_s * alpha_r)
                row -= br * as_ + bs * ar
                # quadratic part through the product columns
                for i in supp_r:
                    for j in supp_s:
                        row[subs[(int(i), int(j))]] += \
                            ar[int(i)] * as_[int(j)]
                out_rows.append((row, -br * bs))
                if len(out_rows) >= max_cuts:
                    break
            if len(out_rows) >= max_cuts:
                break
        if len(out_rows) >= max_cuts:
            break
    if not out_rows:
        return None
    A_new = np.stack([t[0] for t in out_rows])
    lb = np.array([t[1] for t in out_rows])
    ub = np.full(len(out_rows), np.inf)
    return A_new, lb, ub


def append_rlt_row_products(gs, max_cuts: int = 8) -> int:
    """Append the static row-product family to the staged master in
    place (A/clb/cub grow by R rows).  Returns R."""
    got = enumerate_rlt_row_products(gs, max_cuts=max_cuts)
    if got is None:
        return 0
    A_new, lb, ub = got
    gs.A = np.concatenate([gs.A, A_new], axis=0)
    gs.clb = np.concatenate([gs.clb, lb])
    gs.cub = np.concatenate([gs.cub, ub])
    return len(lb)


def build_rlt_rows_fn(cand: RLTCandidates, nz: int, device="cpu"):
    """Returns rlt_rows(vlb, vub) -> (A (B, 4C, nz), lb (B, 4C),
    ub (B, 4C)) for (B, nz) boxes.  All four kinds are >= rows; rows
    whose bound factor or row side is unavailable (infinite) come back
    free and zeroed.  Static parts (Y, the e_k column scaled by the
    static row bound) are precomputed; only +-(l_k|u_k)*a_r and the rhs
    depend on the box.
    """
    dev = torch.device(device)
    f64 = dict(dtype=torch.float64, device=dev)
    inf = float("inf")

    C = cand.count
    kk = torch.as_tensor(cand.k.astype(np.int64), device=dev)
    Arow = torch.as_tensor(cand.Arow, **f64)
    # sign of the substituted quadratic part per kind (see module doc)
    s4 = np.array([1.0, -1.0, -1.0, 1.0])
    diag_coef = s4[:, None] * cand.diag_c[None, :]        # (4, C) static
    diag_pos = diag_coef > 1e-15
    diag_coef_t = torch.as_tensor(diag_coef, **f64)
    diag_pos_t = torch.as_tensor(diag_pos, device=dev)
    lr = np.where(np.isfinite(cand.lr), cand.lr, 0.0)
    ur = np.where(np.isfinite(cand.ur), cand.ur, 0.0)
    lr_fin = np.isfinite(cand.lr) & (np.abs(cand.lr) < _FIN)
    ur_fin = np.isfinite(cand.ur) & (np.abs(cand.ur) < _FIN)
    idx = np.arange(C)
    # static parts S_kind = (+-Y) + (static row bound) * e_k
    S0 = cand.Y.copy()
    S0[idx, cand.k] -= ur           # (u_k - z_k)(u_r - a.z)
    S1 = -cand.Y.copy()
    S1[idx, cand.k] += ur           # (z_k - l_k)(u_r - a.z)
    S2 = -cand.Y.copy()
    S2[idx, cand.k] += lr           # (u_k - z_k)(a.z - l_r)
    S3 = cand.Y.copy()
    S3[idx, cand.k] -= lr           # (z_k - l_k)(a.z - l_r)
    S = torch.as_tensor(np.stack([S0, S1, S2, S3]), **f64)   # (4, C, nz)
    lr_t = torch.as_tensor(lr, **f64)
    ur_t = torch.as_tensor(ur, **f64)
    lr_fin_t = torch.as_tensor(lr_fin, device=dev)
    ur_fin_t = torch.as_tensor(ur_fin, device=dev)
    cidx = torch.arange(C, device=dev)

    def rlt_rows(vlb, vub):
        B = vlb.shape[0]
        lk = vlb[:, kk]                                   # (B, C)
        uk = vub[:, kk]
        lk_fin = torch.isfinite(lk) & (torch.abs(lk) < _FIN)
        uk_fin = torch.isfinite(uk) & (torch.abs(uk) < _FIN)
        lk = torch.where(lk_fin, lk, 0.0)
        uk = torch.where(uk_fin, uk, 0.0)
        dyn = torch.stack([-uk[:, :, None] * Arow, lk[:, :, None] * Arow,
                           uk[:, :, None] * Arow, -lk[:, :, None] * Arow],
                          dim=1)                          # (B, 4, C, nz)
        rows = S + dyn
        rhs = torch.stack([-uk * ur_t, lk * ur_t, uk * lr_t, -lk * lr_t],
                          dim=1)                          # (B, 4, C)
        ok = torch.stack([uk_fin & ur_fin_t, lk_fin & ur_fin_t,
                          uk_fin & lr_fin_t, lk_fin & lr_fin_t], dim=1)
        # leftover +-a_k x_k^2 (no square column): replace with a linear
        # over-estimator h >= coef*x_k^2 so the >= row stays valid.
        # coef>0: secant (needs both bounds); coef<0: midpoint tangent
        # (globally valid, no bounds needed).
        mid = (0.5 * (lk + uk))[:, None, :]   # lk/uk zeroed when infinite
        lk3, uk3 = lk[:, None, :], uk[:, None, :]
        alpha = torch.where(diag_pos_t, diag_coef_t * (lk3 + uk3),
                            2.0 * diag_coef_t * mid)
        beta = torch.where(diag_pos_t, -diag_coef_t * lk3 * uk3,
                           -diag_coef_t * mid * mid)
        ok = ok & (~diag_pos_t | (lk_fin & uk_fin)[:, None, :])
        rows[:, :, cidx, kk] += alpha
        rhs = rhs - beta
        rows = torch.where(ok[..., None], rows, 0.0)
        lb = torch.where(ok, rhs, -inf)
        ub = torch.full((B, 4, C), inf, **f64)
        return (rows.reshape(B, 4 * C, nz), lb.reshape(B, 4 * C),
                ub.reshape(B, 4 * C))

    return rlt_rows
