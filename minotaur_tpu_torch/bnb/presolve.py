"""Root presolve: linear presolve + FBBT fixpoint.

Port of minotaur_tpu/bnb/presolve.py.  `linear_presolve`,
`nl_coef_improve` and the unsafe-variable scan are host code as in the
JAX package (the interval sweeps of `nl_coef_improve` run on the CPU);
`presolve` runs the FBBT fixpoint, nonlinear rows included, with two
batched sweeps (one lane) per call on the port's device.  `obbt` solves
all 2n bound LPs of the linear relaxation as one lane-batched IPM call
(one lane per LP, 2n lanes of K1 and K2) and tightens with their
certified dual bounds (reference QuadHandler::tightenLP_,
QuadHandler.cpp:2218, solves them one at a time).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..device import F64, resolve_device
from ..engines.ipm import IPMOptions, build_single_solver
from ..engines.staging import StagedProblem
from ..ir.problem import Problem
from ..ops.interval import stage_interval
from ..utils.types import SolveStatus
from .step import build_fbbt_sweep

_INF = float("inf")


@dataclasses.dataclass
class PresolveStats:
    rounds: int = 0
    bounds_tightened: int = 0
    obbt_tightened: int = 0
    infeasible: bool = False
    dup_rows: int = 0
    redundant_rows: int = 0
    singleton_rows: int = 0
    coefs_improved: int = 0
    dual_fixed: int = 0


class Presolver:
    def __init__(self, problem: Problem, sp: StagedProblem,
                 max_iters: int = 5, int_tol: float = 1e-6,
                 ipm: IPMOptions = IPMOptions(), device="cuda"):
        self.problem = problem
        self.sp = sp
        self.max_iters = max_iters
        self.int_tol = int_tol
        self.stats = PresolveStats()
        self.device = resolve_device(device)
        sweep = build_fbbt_sweep(sp, int_tol, self.device)
        dev = self.device

        def run(A, clb, cub, vlb, vub):
            t = lambda a: torch.as_tensor(a, dtype=F64, device=dev)  # noqa: E731
            A_t, clb_t, cub_t = t(A).reshape(sp.m, sp.n), t(clb), t(cub)
            lo, hi = t(vlb)[None], t(vub)[None]
            infeas = torch.zeros(1, dtype=torch.bool, device=dev)
            for _ in range(2):  # two sweeps per device call
                lo, hi, infeas = sweep(A_t, clb_t, cub_t, lo, hi, infeas)
            return lo[0].cpu().numpy(), hi[0].cpu().numpy(), bool(infeas[0])

        self._sweep2 = run
        self._ipm = ipm
        self._obbt_solver = None
        # variables that linear-only reasoning may NOT touch: anything in
        # a nonlinear/quadratic body (its constraint is not fully visible
        # in A), anything in the objective when the objective has a
        # nonlinear part (QG masters re-introduce those vars via cuts),
        # SOS members, and any staged column beyond the original vars
        # (eta / aux columns).
        unsafe = np.zeros(sp.n, dtype=bool)
        unsafe[problem.n_vars:] = True
        obj_has_nl = problem.obj is not None and (
            (problem.obj.fun.qf and len(problem.obj.fun.qf)) or
            (problem.obj.fun.nlf is not None and
             problem.obj.fun.nlf.root >= 0))
        for con in problem.cons:
            nl = (con.fun.qf and len(con.fun.qf)) or \
                (con.fun.nlf is not None and con.fun.nlf.root >= 0)
            if not nl:
                continue
            if con.fun.lf:
                for v, _ in con.fun.lf:
                    unsafe[v] = True
            if con.fun.qf:
                for (i2, j2) in con.fun.qf.terms:
                    unsafe[i2] = unsafe[j2] = True
            if con.fun.nlf is not None and con.fun.nlf.root >= 0:
                unsafe[con.fun.nlf.vars_used()] = True
        if obj_has_nl and problem.obj is not None:
            if problem.obj.fun.lf:
                for v, _ in problem.obj.fun.lf:
                    unsafe[v] = True
            if problem.obj.fun.qf:
                for (i2, j2) in problem.obj.fun.qf.terms:
                    unsafe[i2] = unsafe[j2] = True
            if problem.obj.fun.nlf is not None and \
                    problem.obj.fun.nlf.root >= 0:
                unsafe[problem.obj.fun.nlf.vars_used()] = True
        for w, idxs in getattr(problem, "_sos1", []) + \
                getattr(problem, "_sos2", []):
            unsafe[np.asarray(idxs, dtype=np.int64)] = True
        self._lin_unsafe = unsafe

    # ------------------------------------------------- linear presolve
    def linear_presolve(self, vlb: np.ndarray, vub: np.ndarray
                        ) -> Tuple[SolveStatus, np.ndarray, np.ndarray]:
        """Linear presolve suite on the staged rows, mutating sp.A/clb/cub
        in place.

        Reference: LinearHandler.{h,cpp} — duplicate rows
        (`dupRows_` :882), redundant-row deletion, coefficient
        improvement for binaries (`coeffImpr_` :600) and dual fixing
        (`dualFix_` :786).  All passes are vectorized; rows are "deleted"
        by setting their bounds to (-inf, inf), which disables them in
        the static-shape relaxation.
        """
        sp = self.sp
        A, clb, cub = sp.A, sp.clb, sp.cub
        m, n = A.shape
        lin_row = np.ones(m, dtype=bool)
        if len(sp.nl_rows):
            lin_row[sp.nl_rows] = False
        active = lin_row & ~((clb <= -_INF) & (cub >= _INF))

        # activity bounds per row (inf-safe: masked products)
        def activities():
            with np.errstate(invalid="ignore"):
                tmin = np.where(A > 0, A * vlb[None, :],
                                np.where(A < 0, A * vub[None, :], 0.0))
                tmax = np.where(A > 0, A * vub[None, :],
                                np.where(A < 0, A * vlb[None, :], 0.0))
            return tmin.sum(axis=1), tmax.sum(axis=1)

        # --- singleton rows: a*x in [lb, ub] tightens x directly and the
        # row becomes redundant (reference: LinearHandler.cpp:362)
        nnz = (A != 0).sum(axis=1)
        for i in np.where(active & (nnz == 1))[0]:
            j = int(np.nonzero(A[i])[0][0])
            a = A[i, j]
            lo, hi = clb[i] / a, cub[i] / a
            if a < 0:
                lo, hi = hi, lo
            if lo > vlb[j] + 1e-12:
                vlb[j] = lo
                self.stats.bounds_tightened += 1
            if hi < vub[j] - 1e-12:
                vub[j] = hi
                self.stats.bounds_tightened += 1
            if sp.int_mask[j]:
                vlb[j] = np.ceil(vlb[j] - self.int_tol)
                vub[j] = np.floor(vub[j] + self.int_tol)
            if vlb[j] > vub[j] + 1e-9:
                self.stats.infeasible = True
                return SolveStatus.SOLVED_INFEASIBLE, vlb, vub
            clb[i], cub[i] = -_INF, _INF
            active[i] = False
            self.stats.singleton_rows += 1

        # --- duplicate rows: identical coefficient vectors merge bounds
        seen: dict = {}
        for i in np.where(active)[0]:
            key = A[i].tobytes()
            j = seen.get(key)
            if j is None:
                seen[key] = int(i)
                continue
            clb[j] = max(clb[j], clb[i])
            cub[j] = min(cub[j], cub[i])
            clb[i], cub[i] = -_INF, _INF
            active[i] = False
            self.stats.dup_rows += 1
            if clb[j] > cub[j] + 1e-9:
                self.stats.infeasible = True
                return SolveStatus.SOLVED_INFEASIBLE, vlb, vub

        minact, maxact = activities()
        if np.any(active & ((minact > cub + 1e-9) | (maxact < clb - 1e-9))):
            self.stats.infeasible = True
            return SolveStatus.SOLVED_INFEASIBLE, vlb, vub
        # --- redundant rows (activity range inside the bounds; bounds
        # only shrink down the tree so this stays valid in descendants)
        red = active & (minact >= clb - 1e-12) & (maxact <= cub + 1e-12)
        if red.any():
            clb[red] = -_INF
            cub[red] = _INF
            active &= ~red
            self.stats.redundant_rows += int(red.sum())

        # --- coefficient improvement for binaries on one-sided rows
        is_bin = sp.int_mask & (vlb >= -1e-9) & (vub <= 1 + 1e-9) & \
            (vub - vlb > 0.5)
        if is_bin.any():
            for sign in (1.0, -1.0):
                # view every candidate row as  a.x <= b
                if sign > 0:
                    rows = np.where(active & (cub < _INF) &
                                    (clb <= -_INF))[0]
                else:
                    rows = np.where(active & (clb > -_INF) &
                                    (cub >= _INF))[0]
                if not len(rows):
                    continue
                Ar = sign * A[rows]
                b = (cub[rows] if sign > 0 else -clb[rows])
                with np.errstate(invalid="ignore"):
                    tmax = np.where(Ar > 0, Ar * vub[None, :],
                                    np.where(Ar < 0, Ar * vlb[None, :],
                                             0.0))
                U = tmax.sum(axis=1)
                fin = np.isfinite(U)
                if not fin.any():
                    continue
                a = Ar[:, is_bin]                       # (R, nb)
                U_rest = U[:, None] - np.maximum(a, 0.0)
                ok = fin[:, None] & (np.abs(a) > 1e-12)
                # a > 0, x_j=0 side slack: a' = a - (b - U_rest)
                pos = ok & (a > 0) & (U_rest <= b[:, None] + 1e-12) & \
                    (a > b[:, None] - U_rest + 1e-9)
                # a < 0, x_j=1 side slack: a' = b - U_rest
                neg = ok & (a < 0) & (U_rest <= b[:, None] - a + 1e-12) & \
                    (b[:, None] < U_rest - 1e-9)
                if not (pos.any() or neg.any()):
                    continue
                new_a = np.where(pos, a - (b[:, None] - U_rest),
                                 np.where(neg, b[:, None] - U_rest, a))
                # write back (at most one improvement per row per round
                # keeps U consistent; pick the first improved column)
                for ri, r in enumerate(rows):
                    cols = np.where(pos[ri] | neg[ri])[0]
                    if not len(cols):
                        continue
                    cj = np.where(is_bin)[0][cols[0]]
                    A[r, cj] = sign * new_a[ri, cols[0]]
                    if pos[ri, cols[0]]:
                        if sign > 0:
                            cub[r] = U_rest[ri, cols[0]]
                        else:
                            clb[r] = -U_rest[ri, cols[0]]
                    self.stats.coefs_improved += 1

        # --- dual fixing (minimization): c_j >= 0 and nothing can push
        # x_j up -> fix at lower bound; mirror for c_j <= 0.  NOTE: this
        # preserves some optimal solution but not all feasible ones, so
        # the debug_sol oracle is intentionally not applied here (the
        # reference's dualFix_ has the same property).
        lower_rows = clb > -_INF
        upper_rows = cub < _INF
        push_up = ((A > 0) & lower_rows[:, None]) | \
            ((A < 0) & upper_rows[:, None])
        push_dn = ((A > 0) & upper_rows[:, None]) | \
            ((A < 0) & lower_rows[:, None])
        safe = ~self._lin_unsafe
        cvec = sp.c
        fix_lo = safe & ~push_up.any(axis=0) & (cvec >= 0) & \
            np.isfinite(vlb) & (vub > vlb)
        fix_hi = safe & ~push_dn.any(axis=0) & (cvec <= 0) & \
            np.isfinite(vub) & (vub > vlb) & ~fix_lo
        if fix_lo.any():
            vub = np.where(fix_lo, vlb, vub)
        if fix_hi.any():
            vlb = np.where(fix_hi, vub, vlb)
        self.stats.dual_fixed += int(fix_lo.sum() + fix_hi.sum())

        if self.problem.debug_sol is not None:
            # duplicate/redundant/coef-improvement must keep any feasible
            # integral point feasible; check the staged rows directly
            ds = self.problem.debug_sol
            if len(ds) == n:
                act = A @ ds
                viol = (act < clb - 1e-5) | (act > cub + 1e-5)
                if len(sp.nl_rows):
                    viol[sp.nl_rows] = False
                if viol.any():
                    raise AssertionError(
                        "linear presolve cut off the debug solution "
                        f"(rows {np.where(viol)[0][:5]})")
        return SolveStatus.FINISHED, vlb, vub

    def nl_coef_improve(self, vlb: np.ndarray, vub: np.ndarray) -> None:
        """Coefficient improvement on NONLINEAR rows (reference:
        NlPresHandler::coeffImpr_, NlPresHandler.cpp:212): for a
        one-sided nonlinear row with a binary z in its LINEAR part (and
        absent from the nonlinear body), the implied activity bound of
        body-without-z tightens both z's coefficient and the row bound.

        Validity (ub side; lb mirrors): with uu = sup(body | z = 0)
        from interval arithmetic, replacing (a0, cu) by
        (a0 + uu - cu, uu) keeps the z=1 constraint IDENTICAL
        (rest + a0 + uu - cu <= uu  <=>  rest + a0 <= cu) and makes the
        z=0 constraint valid-by-interval (rest <= uu holds for every
        box point), while the continuous relaxation tightens.  The
        reference conditions uu < cu and uu + a0 >= cu restrict to the
        binds-only-when-z=1 regime (they imply a0 > 0).  The interval
        sweeps run on the host's CPU (one box, a few rows)."""
        sp = self.sp
        if not len(sp.nl_rows):
            return
        A, clb, cub = sp.A, sp.clb, sp.cub
        is_bin = sp.int_mask & (vlb >= -1e-9) & (vub <= 1 + 1e-9) & \
            (vub - vlb > 0.5)
        if not is_bin.any():
            return
        t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
        vlb_j = t(vlb)
        vub_j = t(vub)
        for k, r in enumerate(sp.nl_rows):
            r = int(r)
            one_ub = np.isfinite(cub[r]) and not np.isfinite(clb[r])
            one_lb = np.isfinite(clb[r]) and not np.isfinite(cub[r])
            if not (one_ub or one_lb):
                continue
            g = sp.nl_graphs[k]
            gvars = set(int(v) for v in g.vars_used())
            glo, ghi = stage_interval(g)(vlb_j, vub_j)
            glo, ghi = float(glo), float(ghi)
            with np.errstate(invalid="ignore"):
                tmin = np.where(A[r] > 0, A[r] * vlb,
                                np.where(A[r] < 0, A[r] * vub, 0.0))
                tmax = np.where(A[r] > 0, A[r] * vub,
                                np.where(A[r] < 0, A[r] * vlb, 0.0))
            # row-local validity: z need only be absent from THIS row's
            # nonlinear body (checked below); the global _lin_unsafe
            # mask is for transforms that reason across rows.  Staged
            # aux columns (eta etc.) are still excluded.
            cand = np.zeros(sp.n, dtype=bool)
            cand[:self.problem.n_vars] = True
            cand = np.where(is_bin & (np.abs(A[r]) > 1e-12) & cand)[0]
            for j in cand:
                if int(j) in gvars:
                    continue
                a0 = A[r, j]
                if one_ub:
                    uu = float(tmax.sum() - tmax[j]) + ghi
                    if np.isfinite(uu) and uu < cub[r] - 1e-9 and \
                            uu + a0 >= cub[r] - 1e-9:
                        A[r, j] = a0 + uu - cub[r]
                        cub[r] = uu
                        self.stats.coefs_improved += 1
                        break   # one per row per round
                else:
                    ll = float(tmin.sum() - tmin[j]) + glo
                    if np.isfinite(ll) and ll > clb[r] + 1e-9 and \
                            ll + a0 <= clb[r] + 1e-9:
                        A[r, j] = a0 + ll - clb[r]
                        clb[r] = ll
                        self.stats.coefs_improved += 1
                        break
        if self.problem.debug_sol is not None:
            ds = self.problem.debug_sol
            if len(ds) == sp.n:
                for k, r in enumerate(sp.nl_rows):
                    r = int(r)
                    gval = float(stage_interval(sp.nl_graphs[k])(
                        t(ds), t(ds))[0])
                    act = float(sp.A[r] @ ds) + gval
                    if act < clb[r] - 1e-5 or act > cub[r] + 1e-5:
                        raise AssertionError(
                            "nl coefficient improvement cut off the "
                            f"debug solution (row {r})")

    # ------------------------------------------------------------- FBBT
    def presolve(self, vlb: np.ndarray, vub: np.ndarray
                 ) -> Tuple[SolveStatus, np.ndarray, np.ndarray]:
        """FBBT to fixpoint (<= max_iters rounds of two sweeps)."""
        sp = self.sp
        for _ in range(self.max_iters):
            nlo, nhi, infeas = self._sweep2(sp.A, sp.clb, sp.cub, vlb, vub)
            if infeas:
                self.stats.infeasible = True
                return SolveStatus.SOLVED_INFEASIBLE, vlb, vub
            changed = np.sum(nlo > vlb + 1e-9) + np.sum(nhi < vub - 1e-9)
            self.stats.rounds += 1
            self.stats.bounds_tightened += int(changed)
            vlb, vub = nlo, nhi
            if changed == 0:
                break
            if self.problem.debug_sol is not None and \
                    not np.all((self.problem.debug_sol >= vlb - 1e-6) &
                               (self.problem.debug_sol <= vub + 1e-6)):
                raise AssertionError(
                    "presolve cut off the debug solution (FBBT bug)")
        return SolveStatus.FINISHED, vlb, vub

    # ------------------------------------------------------------- OBBT
    def obbt(self, vlb: np.ndarray, vub: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray]:
        """Optimality-based bound tightening over the LINEAR relaxation:
        min/max each variable subject to the linear rows.  One
        lane-batched solve of 2n LPs (lane j minimizes x_j, lane n + j
        maximizes it)."""
        sp = self.sp
        n = sp.n
        if self._obbt_solver is None:
            # linear-only staged view: nonlinear rows vacuous
            lin = dataclasses.replace(
                sp, Qobj=None, obj_nl=None, con_nl=None, nl_graphs=[],
                nl_rows=np.zeros(0, np.int32), nl_Q=[], nl_body=[],
                obj_graph=None, clb=sp.clb.copy(), cub=sp.cub.copy())
            for r in sp.nl_rows:
                lin.clb[r] = -_INF
                lin.cub[r] = _INF
            self._obbt_solver = (lin, build_single_solver(
                lin, self._ipm, self.device).with_objective)
        lin, solver = self._obbt_solver
        t = lambda a: torch.as_tensor(a, dtype=F64,  # noqa: E731
                                      device=self.device)
        cs = np.zeros((2 * n, n))
        cs[np.arange(n), np.arange(n)] = 1.0       # min x_j
        cs[n + np.arange(n), np.arange(n)] = -1.0  # min -x_j = max x_j
        res = solver(t(lin.A), t(lin.clb), t(lin.cub),
                     t(np.tile(vlb, (2 * n, 1))), t(np.tile(vub, (2 * n, 1))),
                     t(np.zeros((2 * n, n))), t(cs))
        db = res.dual_bound.cpu().numpy()  # certified lower bounds
        new_lo = np.maximum(vlb, db[:n] - lin.obj_const - 1e-9)
        new_hi = np.minimum(vub, -(db[n:] - lin.obj_const) + 1e-9)
        ok = new_lo <= new_hi + 1e-9
        new_lo = np.where(ok, new_lo, vlb)
        new_hi = np.where(ok, new_hi, vub)
        self.stats.obbt_tightened += int(
            np.sum(new_lo > vlb + 1e-7) + np.sum(new_hi < vub - 1e-7))
        if self.problem.debug_sol is not None and \
                not np.all((self.problem.debug_sol >= new_lo - 1e-6) &
                           (self.problem.debug_sol <= new_hi + 1e-6)):
            raise AssertionError("OBBT cut off the debug solution")
        return new_lo, new_hi
