"""Root linearization schemes for QG branch-and-cut.

Reference: Linearizations.{h,cpp} (2791 LoC — root linearization scheme
library rs1/rs2/rs3, ESH-style boundary points) and AnalyticalCenter
.{h,cpp} (analytic-center NLP), feeding QGHandlerAdvance.

The analytic center is the IPM's solution of a log-barrier objective
over the linear relaxation; ESH boundary points for ALL nonlinear rows
are found by ONE vectorized bisection along the segment from the center
to an exterior point (the reference bisects one constraint at a time on
the host); the sampled scheme evaluates gradients of every nonlinear
body at a batch of interior points in one AD call.

Port of minotaur_tpu/bnb/linearizations.py.  The barrier is a purely
functional torch closure on a trailing variable axis (the IPM
differentiates it with `torch.func`), solved as one lane of the port's
lane-batched `build_single_solver`; the 40-step bisection runs as torch
ops on the solver's device (the JAX package's `jax.lax.fori_loop`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import F64, resolve_device
from ..engines.ipm import IPMOptions, build_single_solver
from ..engines.staging import StagedProblem

_INF = float("inf")


class RootLinearizer:
    def __init__(self, sp: StagedProblem, ipm: IPMOptions = IPMOptions(),
                 seed: int = 0, device="cuda"):
        self.sp = sp
        self.device = resolve_device(device)
        self._ipm = ipm
        self._rng = np.random.default_rng(seed)
        self._center_solver = None
        self._esh = None

    # -------------------------------------------------- analytic center
    def analytic_center(self, vlb: np.ndarray, vub: np.ndarray
                        ) -> Optional[np.ndarray]:
        """Analytic center of the linear relaxation: minimize the log
        barrier of the finite variable bounds + finite linear row slacks
        as an NLP (reference AnalyticalCenter solves max sum log s the
        same way, AnalyticalCenter.cpp)."""
        sp = self.sp
        dev = self.device
        t = lambda a: torch.as_tensor(a, dtype=F64, device=dev)  # noqa: E731
        if self._center_solver is None:
            nl_set = set(int(r) for r in sp.nl_rows)
            lin_rows = np.asarray([i for i in range(sp.m)
                                   if i not in nl_set], dtype=np.int64)
            A_l = t(sp.A[lin_rows]) if len(lin_rows) else None
            cub_l = sp.cub[lin_rows] if len(lin_rows) else np.zeros(0)
            clb_l = sp.clb[lin_rows] if len(lin_rows) else np.zeros(0)
            fin_ru = np.isfinite(cub_l)
            fin_rl = np.isfinite(clb_l)
            fin_vl = np.isfinite(vlb) & (np.abs(vlb) < 1e15)
            fin_vu = np.isfinite(vub) & (np.abs(vub) < 1e15)
            cub_j = t(np.where(fin_ru, cub_l, 0.0))
            clb_j = t(np.where(fin_rl, clb_l, 0.0))
            vlb_j = t(np.where(fin_vl, vlb, 0.0))
            vub_j = t(np.where(fin_vu, vub, 0.0))
            m_ru = torch.as_tensor(fin_ru, device=dev)
            m_rl = torch.as_tensor(fin_rl, device=dev)
            m_vl = torch.as_tensor(fin_vl, device=dev)
            m_vu = torch.as_tensor(fin_vu, device=dev)
            floor = t(1e-9)

            def safe_log(s):
                return torch.log(torch.maximum(s, floor))

            def barrier(x):
                # x (..., n) -> (...); no in-place writes (torch.func)
                b = -torch.where(m_vl, safe_log(x - vlb_j), 0.0).sum(-1)
                b = b - torch.where(m_vu, safe_log(vub_j - x), 0.0).sum(-1)
                if A_l is not None:
                    ax = x @ A_l.T
                    b = b - torch.where(m_ru, safe_log(cub_j - ax),
                                        0.0).sum(-1)
                    b = b - torch.where(m_rl, safe_log(ax - clb_j),
                                        0.0).sum(-1)
                return b

            lin = dataclasses.replace(
                sp, c=np.zeros(sp.n), Qobj=None, obj_nl=barrier,
                obj_const=0.0, con_nl=None, nl_graphs=[],
                nl_rows=np.zeros(0, np.int32), nl_Q=[], nl_body=[],
                obj_graph=None, clb=sp.clb.copy(), cub=sp.cub.copy())
            for r in sp.nl_rows:
                lin.clb[r] = -_INF
                lin.cub[r] = _INF
            self._center_solver = (
                lin, build_single_solver(lin, self._ipm, dev))
        lin, solver = self._center_solver
        lo = np.clip(vlb, -1e4, 1e4)
        hi = np.clip(vub, -1e4, 1e4)
        x0 = 0.5 * (lo + hi)
        res = solver(t(lin.A), t(lin.clb), t(lin.cub), t(vlb)[None],
                     t(vub)[None], t(x0)[None])
        x = res.x[0].cpu().numpy()
        if not np.all(np.isfinite(x)):
            return None
        # must be strictly interior to be an ESH anchor
        lin_ok = True
        nl_set = set(int(r) for r in self.sp.nl_rows)
        for i in range(self.sp.m):
            if i in nl_set:
                continue
            v = float(self.sp.A[i] @ x)
            if (np.isfinite(self.sp.cub[i]) and v > self.sp.cub[i]) or \
                    (np.isfinite(self.sp.clb[i]) and v < self.sp.clb[i]):
                lin_ok = False
                break
        return x if lin_ok else None

    # ----------------------------------------------------- ESH bisection
    def _build_esh(self):
        sp = self.sp
        dev = self.device
        K = len(sp.nl_rows)
        t = lambda a: torch.as_tensor(a, dtype=F64, device=dev)  # noqa: E731
        A_nl = t(sp.A[sp.nl_rows])
        clb_nl = t(sp.clb[sp.nl_rows])
        cub_nl = t(sp.cub[sp.nl_rows])
        con_nl = sp.con_nl

        def row_vals(x):
            # x (..., n) -> (..., K)
            return x @ A_nl.T + con_nl(x)

        def esh(xc, xo):
            """Per-row boundary points along [xc, xo].

            Returns (pts (K, n), valid (K,)); valid rows are those where
            xo violates the row, xc satisfies it strictly, and the
            bisection bracketed the crossing."""
            v_c = row_vals(xc)
            v_o = row_vals(xo)
            up = v_o > cub_nl                  # crossing at the upper bound
            dn = v_o < clb_nl
            tgt = torch.where(up, cub_nl, clb_nl)
            valid = (up & (v_c < cub_nl - 1e-12)) | \
                (dn & (v_c > clb_nl + 1e-12))
            lo = torch.zeros(K, dtype=F64, device=dev)
            hi = torch.ones(K, dtype=F64, device=dev)
            for _ in range(40):
                mid = 0.5 * (lo + hi)
                xm = xc[None, :] + mid[:, None] * (xo - xc)[None, :]
                v = torch.diagonal(row_vals(xm))
                over = torch.where(up, v > tgt, v < tgt)
                lo, hi = torch.where(over, lo, mid), torch.where(over, mid, hi)
            s = 0.5 * (lo + hi)
            pts = xc[None, :] + s[:, None] * (xo - xc)[None, :]
            return pts, valid

        return lambda xc, xo: esh(t(xc), t(xo))

    def esh_points(self, xc: np.ndarray, xo: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Boundary points of all violated nonlinear rows on [xc, xo]."""
        if self._esh is None:
            self._esh = self._build_esh()
        pts, valid = self._esh(xc, xo)
        return pts.cpu().numpy(), valid.cpu().numpy()

    # ------------------------------------------------- sampled scheme
    def sample_points(self, vlb: np.ndarray, vub: np.ndarray,
                      around: Optional[np.ndarray], count: int
                      ) -> np.ndarray:
        """Interior sample points for rs1/rs2-style extra root cuts:
        uniform in the (clipped) box, pulled halfway toward `around`."""
        lo = np.clip(vlb, -1e4, 1e4)
        hi = np.clip(vub, -1e4, 1e4)
        pts = self._rng.uniform(size=(count, self.sp.n)) * (hi - lo) + lo
        if around is not None and np.all(np.isfinite(around)):
            pts = 0.5 * (pts + around[None, :])
        return pts


# ----------------------------------------------- rs1/rs2/rs3 schemes

def _univariate_rows(sp: StagedProblem):
    """(k, row, var) for nonlinear rows whose graph touches ONE variable
    — the rows the reference's rootLinScheme1_/2_ target
    (Linearizations.cpp:2195,2415 take a single nVarIdx)."""
    out = []
    for k, r in enumerate(sp.nl_rows):
        g = sp.nl_graphs[k] if k < len(sp.nl_graphs) else None
        if g is None:
            continue
        vs = g.vars_used()
        if len(vs) == 1:
            out.append((k, int(r), int(vs[0])))
    return out


class RootSchemes:
    """Vectorized analogues of the reference's root linearization
    scheme family (Linearizations.h:30-96).

    rs1 — univariate tangent FAN: the reference recursively inserts a
      tangent at the intersection of adjacent tangents until the
      envelope gap closes (rootLinScheme1_ :2195); the fixed-point of
      that recursion is a dense set of tangents across the variable's
      range, so the batched form places all `rs1` abscissae at once and
      evaluates every gradient in one batched AD call.
    rs2 — NEIGHBORHOOD cuts around the root NLP solution
      (rootLinScheme2_ :2415, parameters rs2Per_/rs2NbhSize_): sampled
      perturbations of x* along each row's nonlinear variables.
    rs3 — LP-guided ESH rounds (rootLinScheme3_: solve the LP, walk
      toward the feasible region, cut at the boundary, resolve): the
      driver loop lives in QG (`_root_linearizations`), which re-solves
      the master between rounds; this class supplies the boundary
      points of one round (vectorized bisection over all rows).
    """

    def __init__(self, rl: RootLinearizer):
        self.rl = rl

    def rs1_points(self, x_star: np.ndarray, fan: int = 6) -> np.ndarray:
        sp = self.rl.sp
        uni = _univariate_rows(sp)
        pts = []
        for _, r, v in uni:
            lo, hi = sp.vlb[v], sp.vub[v]
            xs = x_star[v] if np.isfinite(x_star[v]) else 0.0
            lo = xs - 50.0 if not np.isfinite(lo) else lo   # :2218 window
            hi = xs + 50.0 if not np.isfinite(hi) else hi
            for t in np.linspace(0.0, 1.0, fan):
                p = x_star.copy()
                p[v] = lo + t * (hi - lo)
                pts.append(p)
        return np.asarray(pts).reshape(-1, sp.n)

    def rs2_points(self, x_star: np.ndarray, nbh: float = 0.25,
                   count: int = 4) -> np.ndarray:
        sp = self.rl.sp
        rng = self.rl._rng
        nl_vars = sorted({int(v) for k, r in enumerate(sp.nl_rows)
                          for v in (sp.nl_graphs[k].vars_used()
                                    if k < len(sp.nl_graphs) else [])})
        if not nl_vars or not np.all(np.isfinite(x_star)):
            return np.zeros((0, sp.n))
        span = np.where(np.isfinite(sp.vub) & np.isfinite(sp.vlb),
                        sp.vub - sp.vlb, 2.0)
        pts = np.tile(x_star, (count, 1))
        for v in nl_vars:
            d = nbh * span[v]
            pts[:, v] = np.clip(
                x_star[v] + rng.uniform(-d, d, size=count),
                sp.vlb[v] if np.isfinite(sp.vlb[v]) else -1e12,
                sp.vub[v] if np.isfinite(sp.vub[v]) else 1e12)
        return pts
