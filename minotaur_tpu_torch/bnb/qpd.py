"""QP-diving (QPDProcessor equivalent).

Port of minotaur_tpu/bnb/qpd.py.  The QP model is built on the host's
CPU from the staged torch code (`torch.func` gradient, Hessian and row
Jacobian at the reference point); the dives' QP batches and the true-NLP
polish run on the caller's device.

Reference: QPDProcessor.{h,cpp} (2136 LoC, research) — process/dive
through nodes on a cheap QUADRATIC APPROXIMATION of the NLP instead of
full NLP solves, verifying with the real NLP at the end.

TPU-native shape: build ONE QP model of the staged problem at a
reference point (PSD-projected Hessian of the objective, Jacobian
linearization of every nonlinear row), then dive a whole POPULATION of
lanes at once — each superstep solves all lanes' QPs in one vmapped
batch and fixes one fractional integer per lane (lanes use different
tie-breaking ranks, so they explore different fixings).  Terminal points
are verified against the true problem; QP objective values are never
used as bounds (the approximation is not a relaxation), so this is a
primal heuristic — exactly the role QP-diving plays in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, hessian, jacfwd

from ..engines.ipm import IPMOptions, build_batch_solver
from ..engines.staging import StagedProblem
from ..utils.types import EngineStatus

_INF = float("inf")


def qp_row_linearization(sp: StagedProblem, x0: np.ndarray):
    """First-order linearization of every nonlinear row at x0:
    returns (A, clb, cub) value arrays with the SAME shapes as the
    staged problem's (the QPD node processor writes them into its QP
    model in place when it re-linearizes)."""
    x0 = np.asarray(x0, dtype=np.float64)
    A = sp.A.copy()
    clb = sp.clb.copy()
    cub = sp.cub.copy()
    if sp.con_nl is not None and len(sp.nl_rows):
        xt = torch.as_tensor(x0, dtype=torch.float64)
        gvals = sp.con_nl(xt).detach().numpy()
        J = jacfwd(sp.con_nl)(xt).detach().numpy()
        for k, r in enumerate(sp.nl_rows):
            if not np.all(np.isfinite(J[k])):
                clb[r], cub[r] = -_INF, _INF
                continue
            A[r] = sp.A[r] + J[k]
            shift = float(gvals[k] - J[k] @ x0)
            clb[r] = sp.clb[r] - shift if np.isfinite(sp.clb[r]) else -_INF
            cub[r] = sp.cub[r] - shift if np.isfinite(sp.cub[r]) else _INF
    return A, clb, cub


def build_qp_approx(sp: StagedProblem, x0: np.ndarray) -> StagedProblem:
    """Quadratic model at x0: objective = f(x0) + g.(x-x0) + 1/2 dx'H dx
    with H projected to PSD; every nonlinear row replaced by its
    first-order linearization (QPDProcessor builds the same model from
    the Lagrangian Hessian)."""
    n = sp.n
    x0 = np.asarray(x0, dtype=np.float64)
    f = sp.objective_fn()
    xt = torch.as_tensor(x0, dtype=torch.float64)
    g = grad(f)(xt).detach().numpy()
    H = hessian(f)(xt).detach().numpy()
    if not np.all(np.isfinite(H)):
        H = np.zeros((n, n))
    H = 0.5 * (H + H.T)
    w, V = np.linalg.eigh(H)
    H_psd = (V * np.clip(w, 0.0, None)) @ V.T   # PSD projection

    A, clb, cub = qp_row_linearization(sp, x0)

    # min g.x + 1/2 (x-x0)' H (x-x0)  =  x'(H/2)x + (g - H x0).x + const
    Qobj = 0.5 * H_psd
    c = g - H_psd @ x0
    return StagedProblem(
        name=sp.name + "-qpd", n=n, m=sp.m, c=c, obj_const=0.0,
        Qobj=Qobj if np.abs(Qobj).max() > 0 else None, obj_nl=None,
        A=A, clb=clb, cub=cub, vlb=sp.vlb.copy(), vub=sp.vub.copy(),
        int_mask=sp.int_mask, nl_rows=np.zeros(0, np.int32),
        con_nl=None, nl_graphs=[])


class QPDiver:
    """Population QP diving: `lanes` parallel dives, one vmapped QP batch
    per depth level (the reference dives one node at a time)."""

    def __init__(self, problem, sp: StagedProblem, x_ref: np.ndarray,
                 ipm: IPMOptions = IPMOptions(), lanes: int = 8,
                 device="cuda"):
        self.problem = problem
        self.sp = sp
        self.lanes = lanes
        self.sp_qp = build_qp_approx(sp, x_ref)
        self._qp_solve = build_batch_solver(self.sp_qp, ipm, device)
        self._nlp_solve = build_batch_solver(sp, ipm, device) \
            if (len(sp.nl_rows) or sp.obj_nl is not None) else None
        self._ipm = ipm

    def run(self, vlb: np.ndarray, vub: np.ndarray, x_start: np.ndarray,
            max_depth: Optional[int] = None, int_tol: float = 1e-6
            ) -> List[Tuple[np.ndarray, float]]:
        """Returns [(x, val)] feasible candidates, best first."""
        sp = self.sp
        ints = np.where(sp.int_mask)[0]
        if not len(ints):
            return []
        L = self.lanes
        depth_cap = max_depth or min(len(ints), 40)
        vlb_b = np.tile(vlb, (L, 1))
        vub_b = np.tile(vub, (L, 1))
        x_b = np.tile(x_start, (L, 1))
        alive = np.ones(L, dtype=bool)
        finals: List[np.ndarray] = []
        for _ in range(depth_cap):
            if not alive.any():
                break
            res = self._qp_solve(self.sp_qp.A, self.sp_qp.clb,
                                 self.sp_qp.cub, vlb_b, vub_b, x_b)
            xs = np.asarray(res.x)
            sts = np.asarray(res.status)
            frac = np.where(sp.int_mask[None, :],
                            np.abs(xs - np.round(xs)), 0.0)
            for b in range(L):
                if not alive[b]:
                    continue
                if sts[b] == EngineStatus.SOLVED_INFEASIBLE:
                    alive[b] = False
                    continue
                if frac[b].max() <= int_tol:
                    xr = np.clip(xs[b], vlb_b[b], vub_b[b])
                    xr[sp.int_mask] = np.round(xr[sp.int_mask])
                    finals.append(xr)
                    alive[b] = False
                    continue
                # lane b fixes its (rank b mod n_frac)-th most fractional
                order = np.argsort(-frac[b])
                nf = int((frac[b] > int_tol).sum())
                j = int(order[b % max(nf, 1)])
                v = float(np.round(xs[b, j]))
                v = min(max(v, vlb_b[b, j]), vub_b[b, j])
                vlb_b[b, j] = v
                vub_b[b, j] = v
                x_b[b] = xs[b]
        out: List[Tuple[np.ndarray, float]] = []
        cands = list(finals)
        if self._nlp_solve is not None and cands:
            # polish: fix ints, solve the TRUE NLP from the QP point
            B = len(cands)
            vl = np.tile(vlb, (B, 1))
            vu = np.tile(vub, (B, 1))
            for b, xc in enumerate(cands):
                vl[b, ints] = xc[ints]
                vu[b, ints] = xc[ints]
            res = self._nlp_solve(sp.A, sp.clb, sp.cub, vl, vu,
                                  np.stack(cands))
            xs = np.asarray(res.x)
            sts = np.asarray(res.status)
            for b in range(B):
                if sts[b] in (EngineStatus.SOLVED_OPTIMAL,
                              EngineStatus.ITERATION_LIMIT) and \
                        np.all(np.isfinite(xs[b])):
                    cands.append(xs[b])
        for xc in cands:
            if self.problem.is_feasible(xc, atol=1e-5, int_tol=int_tol):
                out.append((xc.copy(),
                            float(self.problem.eval_objective(xc))))
        out.sort(key=lambda t: t[1])
        return out[:10]
