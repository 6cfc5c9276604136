"""Quesada-Grossmann LP/NLP single-tree outer approximation.

Reference: QGHandler.{h,cpp} — root NLP linearization (initLinear_ :224,
linearAt_ :333), objective handled via an added eta variable
(linearizeObj_ :308), fix-ints NLP at integral LP solutions (fixInts_
:205, solveNLP_ :627), cuts at the NLP solution (cutToCons_/cutToObj_
:356,506), prune when the LP bound reaches the NLP value (:161-200).

Differences from the reference:
- the master LP carries a PREALLOCATED cut pool: cut rows live in the
  master A matrix (static shape), disabled rows have (-inf, inf) bounds;
  adding a cut writes a row + bound in place (host numpy), and the
  device copies of A/clb/cub are refreshed whenever the pool changed
  (`_consts_version`, the cut epoch);
- fix-ints NLP subproblems from *different* nodes solve as ONE
  lane-batched IPM call (the reference does them one at a time);
- cut coefficients (values + gradients of all nonlinear bodies) come from
  one batched AD evaluation over the batch of NLP solutions;
- instead of an inner separate/resolve loop, a node whose bound is not
  yet closed is re-queued and re-solved next superstep against the
  enriched pool — same fixpoint, batch-friendly.

Port of minotaur_tpu/bnb/qg.py: the JAX package's host code as it is;
the device seams are the cut generator (`torch.func.vmap` of `grad` and
`jacfwd` over the staged objective and rows), the single-lane root LP
(a one-lane call of the lane-batched solver), the master's device
copies, and the CPU f64 root anchor, which runs on the CPU by the
reference's design (only after the device root NLP and the multistart
rescue both failed to converge).  Everything else runs on the device
named by the caller (`device=`, default "cuda").
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

from ..engines.ipm import (IPMOptions, build_batch_solver,
                           build_single_solver, to_device)
from ..engines.staging import StagedProblem, stage_problem
from ..ir.problem import Problem
from ..utils.environment import Environment
from ..utils.types import EngineStatus, NodeStatus, SolveStatus
from .bnb import BranchAndBound
from .node import Node

_INF = float("inf")


@dataclasses.dataclass
class QGStats:
    """(reference: QGStats, QGHandler.h:28)"""
    nlp_solves: int = 0
    nlp_feasible: int = 0
    nlp_infeasible: int = 0
    cuts_added: int = 0
    cuts_duplicate: int = 0
    cuts_evicted: int = 0
    requeues: int = 0


def _build_master(sp: StagedProblem, max_cuts: int) -> StagedProblem:
    """Master LP: linear rows of the problem + eta + empty cut pool."""
    has_obj_nl = sp.Qobj is not None or sp.obj_nl is not None
    n_m = sp.n + (1 if has_obj_nl else 0)
    m_m = sp.m + max_cuts
    A = np.zeros((m_m, n_m))
    A[:sp.m, :sp.n] = sp.A
    clb = np.full(m_m, -_INF)
    cub = np.full(m_m, _INF)
    clb[:sp.m] = sp.clb
    cub[:sp.m] = sp.cub
    # nonlinear rows are dropped from the LP (their cuts replace them)
    for r in sp.nl_rows:
        clb[r] = -_INF
        cub[r] = _INF
    c = np.zeros(n_m)
    if has_obj_nl:
        c[sp.n] = 1.0  # min eta
    else:
        c[:sp.n] = sp.c
    vlb = np.concatenate([sp.vlb, [-_INF]] if has_obj_nl else [sp.vlb])
    vub = np.concatenate([sp.vub, [_INF]] if has_obj_nl else [sp.vub])
    int_mask = np.concatenate(
        [sp.int_mask, [False]] if has_obj_nl else [sp.int_mask])
    return StagedProblem(
        name=sp.name + "-qg-master", n=n_m, m=m_m, c=c,
        obj_const=sp.obj_const if has_obj_nl else sp.obj_const,
        Qobj=None, obj_nl=None, A=A, clb=clb, cub=cub, vlb=vlb, vub=vub,
        int_mask=int_mask, nl_rows=np.zeros(0, np.int32), con_nl=None,
        nl_graphs=[], nl_Q=[], nl_body=[], obj_graph=None)


class QGBranchAndBound(BranchAndBound):
    """LP-tree branch-and-cut with NLP separation oracle."""

    # QG applies persp_ref itself (before staging) and always pumps
    _handled_options = ("persp_ref", "fpump")

    def __init__(self, problem: Problem, env: Optional[Environment] = None,
                 device="cuda"):
        env = env or Environment()
        if env.options.get("persp_ref"):
            # structure-rewriting perspective reformulation must run
            # BEFORE staging (reference NlPresHandler::perspRef_ :837)
            from .persp import perspective_reform
            npr = perspective_reform(problem)
            if npr:
                env.logger.info(f"presolve: {npr} on/off rows "
                                f"perspective-reformulated (perspRef)")
        sp = stage_problem(problem)
        self.sp_orig = sp
        # qg_max_cuts sizes the QG pool; cut_pool_capacity is the global
        # cut budget across ALL generators (reference CutManager capacity)
        self.max_cuts = min(int(env.options.get("qg_max_cuts")),
                            int(env.options.get("cut_pool_capacity")))
        master = _build_master(sp, self.max_cuts)
        self.has_eta = master.n == sp.n + 1
        super().__init__(problem, env=env, staged=master, device=device)
        # master arrays are mutable pool storage (traced engine args)
        self.mA = master.A
        self.mclb = master.clb
        self.mcub = master.cub
        self.n_cuts = 0
        self._cut_base = sp.m
        self._cut_keys = set()
        self._cut_slot_key = [None] * self.max_cuts
        self._cut_last_active = np.zeros(self.max_cuts, dtype=np.int64)
        self.qg_stats = QGStats()
        # NLP oracle on the original space
        ipm = IPMOptions(max_iters=int(env.options.get("ipm_max_iters")),
                         tol=float(env.options.get("ipm_tol")))
        self._ipm_opts = ipm
        self._nlp_solve = build_batch_solver(sp, ipm, self.device)
        self._root_lp_solver = None
        self._cut_gen = self._build_cut_gen()
        self._requeue_cap = 50
        self._heur_lanes_cap = 16   # rounding-dive lanes per superstep
        self._heur_cut_lanes = 4    # how many heur solutions also add cuts
        self._feas_witness: Optional[np.ndarray] = None
        self._fp: Optional[object] = None
        self._fp_period = 12        # supersteps between pump attempts
        self._ecp_period = 2        # ECP fractional-cut cadence (0 = off)
        self._max_vio_per = float(env.options.get("max_vio_per"))
        from .heuristics import find_partition_rows
        self._part_rows = find_partition_rows(sp.A, sp.clb, sp.cub,
                                              sp.int_mask, sp.nl_rows)
        from .cuts import find_gub_rows, find_knapsack_rows
        self._knap_rows = find_knapsack_rows(sp.A, sp.clb, sp.cub,
                                             sp.int_mask, sp.vlb, sp.vub,
                                             sp.nl_rows)
        self._gub_rows = find_gub_rows(sp.A, sp.clb, sp.cub,
                                       sp.int_mask, sp.vlb, sp.vub,
                                       sp.nl_rows)
        self._rng = np.random.default_rng(int(env.options.get("rand_seed")))
        from .persp import detect_perspective
        self._persp = detect_perspective(sp) \
            if env.options.get("persp_cuts") else []
        if self._persp:
            env.logger.info(
                f"perspective structure: {len(self._persp)} nonlinear "
                f"rows controlled by indicators "
                f"(reference PerspCon/PerspCutHandler)")
        if env.options.get("fpump") or True:  # pump on by default for QG
            from .heuristics import FeasibilityPump
            self._fp = FeasibilityPump(
                master, ipm, population=16,
                seed=int(env.options.get("rand_seed")), device=self.device)
        if problem.initial_point is not None and self.has_eta:
            problem.initial_point = None  # dimension mismatch with master

    # ---------------------------------------------------------- cut math
    def _build_cut_gen(self):
        """points (B, n) -> {"f", "gf", "g", "Jg"} as numpy: objective
        values and gradients, nonlinear row values and Jacobians, all
        lanes in one batched AD evaluation on the device."""
        sp = self.sp_orig
        dev = self.device
        f_full = sp.objective_fn(dev)
        grad_f = vmap(grad(f_full))
        con_nl = sp.con_nl
        if con_nl is not None:
            jac_nl = vmap(jacfwd(con_nl))

        def gen(xs):
            x = to_device(xs, dev)
            out = {"f": f_full(x), "gf": grad_f(x)}
            if con_nl is not None:
                out["g"] = con_nl(x)
                out["Jg"] = jac_nl(x)
            return {k: v.cpu().numpy() for k, v in out.items()}

        return gen

    def _add_cut(self, coefs: np.ndarray, lb: float, ub: float) -> bool:
        """Append one cut row; when the pool is full, evict the least
        recently active cut (reference: CutMan2 activity aging)."""
        key = (tuple(np.round(coefs / max(1.0, np.abs(coefs).max()), 9)),
               round(lb, 9), round(ub, 9))
        if key in self._cut_keys:
            self.qg_stats.cuts_duplicate += 1
            return False
        if self.n_cuts >= self.max_cuts:
            slot = int(np.argmin(self._cut_last_active[:self.n_cuts]))
            if self._cut_last_active[slot] >= self.stats.batches - 2:
                return False  # everything recently active: drop new cut
            r = self._cut_base + slot
            old_key = self._cut_slot_key[slot]
            if old_key in self._cut_keys:
                self._cut_keys.discard(old_key)
            self.qg_stats.cuts_evicted += 1
        else:
            slot = self.n_cuts
            r = self._cut_base + slot
            self.n_cuts += 1
        self.mA[r, :] = coefs
        self.mclb[r] = lb
        self.mcub[r] = ub
        # bump the cut epoch on EVERY pool write: slot replacement keeps
        # n_cuts constant, so versioning on the count alone would serve
        # stale device arrays after an eviction
        self._cut_epoch = getattr(self, "_cut_epoch", 0) + 1
        self._cut_keys.add(key)
        self._cut_slot_key[slot] = key
        self._cut_last_active[slot] = self.stats.batches
        self.qg_stats.cuts_added += 1
        return True

    def _update_cut_activity(self, xs: np.ndarray) -> None:
        """Mark cuts tight at any of the batch's LP solutions as active
        (host-side; reference CutMan2::updatePool)."""
        if self.n_cuts == 0 or not len(xs):
            return
        rows = slice(self._cut_base, self._cut_base + self.n_cuts)
        vals = xs @ self.mA[rows].T            # (B, n_cuts)
        ub = self.mcub[rows][None, :]
        lb = self.mclb[rows][None, :]
        scale = 1.0 + np.abs(np.where(np.isfinite(ub), ub, 0.0))
        tight = (vals >= ub - 1e-6 * scale) | (vals <= lb + 1e-6 * scale)
        active = tight.any(axis=0)
        self._cut_last_active[:self.n_cuts][active] = self.stats.batches

    def _nudge_interior(self, xh: np.ndarray) -> np.ndarray:
        """Move a point strictly inside the variable box.  Used when a
        gradient is non-finite at xh (e.g. sqrt(x*y) rows of tls4 have a
        singular Jacobian on the y=0 face): a gradient plane of a convex
        body is a valid cut at ANY point, so linearizing at a nearby
        interior point recovers a finite, valid cut where the reference
        (and round 1) silently dropped the row."""
        sp = self.sp_orig
        lo, hi = sp.vlb, sp.vub
        w = np.where(np.isfinite(hi - lo), hi - lo, 1.0)
        eps = np.minimum(1e-4 * (1.0 + np.abs(xh)), 0.1 * np.maximum(w, 0.0))
        lo2 = np.where(np.isfinite(lo), lo + eps, xh)
        hi2 = np.where(np.isfinite(hi), hi - eps, xh)
        return np.clip(xh, np.minimum(lo2, hi2), np.maximum(lo2, hi2))

    def _cuts_at(self, xhat_batch: np.ndarray) -> int:
        """Add linearization cuts at a batch of x-space points
        (reference: linearAt_/cutToCons_/cutToObj_)."""
        sp = self.sp_orig
        out = self._cut_gen(xhat_batch)
        added = 0
        B = xhat_batch.shape[0]
        xhat_batch = xhat_batch.copy()  # lanes may be re-anchored below
        f = np.asarray(out["f"])
        gf = np.asarray(out["gf"])
        g = np.asarray(out["g"]) if "g" in out else None
        Jg = np.asarray(out["Jg"]) if "Jg" in out else None
        # second pass at interior-nudged points for lanes whose gradients
        # came back non-finite (boundary singularities)
        bad = np.zeros(B, dtype=bool)
        if Jg is not None:
            bad |= ~np.isfinite(Jg).all(axis=(1, 2))
        if self.has_eta:
            bad |= ~np.isfinite(gf).all(axis=1)
        bad &= np.isfinite(xhat_batch).all(axis=1)
        if bad.any():
            xn = np.stack([self._nudge_interior(xhat_batch[b])
                           for b in np.where(bad)[0]])
            out2 = self._cut_gen(xn)
            f2, gf2 = out2["f"], out2["gf"]
            g2, Jg2 = out2.get("g"), out2.get("Jg")
            # replace the lane's WHOLE evaluation (all rows + objective)
            # so every cut of the lane is anchored at the same point
            for j, b in enumerate(np.where(bad)[0]):
                xhat_batch[b] = xn[j]
                f[b], gf[b] = f2[j], gf2[j]
                if Jg is not None:
                    g[b], Jg[b] = g2[j], Jg2[j]
        for b in range(B):
            xh = xhat_batch[b]
            if not np.all(np.isfinite(xh)):
                continue
            if self.has_eta and np.all(np.isfinite(gf[b])):
                # eta >= f(xh) + gf.(x - xh):  gf.x - eta <= gf.xh - f(xh)
                coefs = np.zeros(self.sp.n)
                coefs[:sp.n] = gf[b]
                coefs[sp.n] = -1.0
                added += self._add_cut(coefs, -_INF,
                                       float(gf[b] @ xh - f[b]))
            if g is not None:
                for k, r in enumerate(sp.nl_rows):
                    if not np.all(np.isfinite(Jg[b, k])):
                        continue
                    added += self._add_row_cut(r, xh, g[b, k], Jg[b, k])
        if self._persp and g is not None:
            added += self._persp_cuts_at(xhat_batch)
        return added

    def _persp_cuts_at(self, xhat_batch: np.ndarray) -> int:
        """Perspective cuts for indicator-controlled nonlinear rows
        (reference PerspCutGenerator):  grad(u).x + (g(u) - grad(u).u
        - c) z <= 0 with u = xhat scaled into the z=1 slice."""
        sp = self.sp_orig
        pts = []
        meta = []
        for b in range(xhat_batch.shape[0]):
            xh = xhat_batch[b]
            if not np.all(np.isfinite(xh)):
                continue
            for pr in self._persp:
                zbar = float(np.clip(xh[pr.z], 0.0, 1.0))
                if zbar < 1e-4 or zbar > 1.0 - 1e-9:
                    continue  # at z=1 it coincides with the plain cut
                u = xh.copy()
                u[pr.vars] = xh[pr.vars] / zbar
                u = np.clip(u, sp.vlb, sp.vub)
                pts.append(u)
                meta.append(pr)
        if not pts:
            return 0
        out = self._cut_gen(np.stack(pts))
        gv = np.asarray(out["g"])
        Jg = np.asarray(out["Jg"])
        added = 0
        for i, pr in enumerate(meta):
            if not np.all(np.isfinite(Jg[i, pr.k])):
                continue
            u = pts[i]
            grad_full = sp.A[pr.row] + Jg[i, pr.k]
            gval_full = float(gv[i, pr.k] + sp.A[pr.row] @ u)
            c = sp.cub[pr.row]
            coefs = np.zeros(self.sp.n)
            coefs[:sp.n] = grad_full
            coefs[pr.z] += gval_full - float(grad_full @ u) - c
            added += self._add_cut(coefs, -_INF, 0.0)
        return added

    def _add_row_cut(self, r: int, xh: np.ndarray, gval: float,
                     grow: np.ndarray) -> int:
        """One linearization cut of nonlinear row r at point xh.

        ONE-SIDED, like the reference (QGHandler.cpp:104-108 only ever
        emits (-inf, cUb - c]): under QG's convexity assumption the
        gradient plane underestimates g, so only the ub side is a valid
        cut.  Linearizing both sides of a two-sided/equality row stacks
        near-equality hyperplanes from different points whose
        intersection is empty — the master then reports CERTIFIED
        infeasibility on a feasible problem (seen on minlp_eg0)."""
        sp = self.sp_orig
        coefs = np.zeros(self.sp.n)
        coefs[:sp.n] = sp.A[r] + grow
        shift = float(gval - grow @ xh)
        if np.isfinite(sp.cub[r]):
            return int(self._add_cut(coefs, -_INF, sp.cub[r] - shift))
        if np.isfinite(sp.clb[r]):
            # lb-only row (g >= lb, g concave under the QG assumption):
            # the gradient plane overestimates g, so >= its lb is valid
            return int(self._add_cut(coefs, sp.clb[r] - shift, _INF))
        return 0

    def _cut_rows_at(self, pts: np.ndarray, valid: np.ndarray) -> int:
        """Per-row cuts: point k linearizes ONLY nonlinear row k (used by
        the ESH boundary-point scheme, where each row has its own
        supporting point)."""
        sp = self.sp_orig
        out = self._cut_gen(pts)
        g = np.asarray(out["g"])
        Jg = np.asarray(out["Jg"])
        added = 0
        for k, r in enumerate(sp.nl_rows):
            if not valid[k] or not np.all(np.isfinite(pts[k])) or \
                    not np.all(np.isfinite(Jg[k, k])):
                continue
            added += self._add_row_cut(r, pts[k], g[k, k], Jg[k, k])
        return added

    def _root_linearizations(self, x0: np.ndarray) -> None:
        """Extra root linearization schemes (reference: Linearizations
        rs1-3/ESH + AnalyticalCenter, wired by QGHandlerAdvance)."""
        sp = self.sp_orig
        scheme = str(self.env.options.get("root_linearizations"))
        if scheme not in ("esh", "sample", "both", "rs1", "rs2", "rs3") \
                or not len(sp.nl_rows):
            return
        from .linearizations import RootLinearizer, RootSchemes
        rl = RootLinearizer(sp, self._ipm_opts,
                            seed=int(self.env.options.get("rand_seed")),
                            device=self.device)
        added = 0
        if scheme in ("esh", "both"):
            xc = rl.analytic_center(sp.vlb, sp.vub)
            if xc is None:
                xc = x0 if np.all(np.isfinite(x0)) else None
            xo = self._root_lp_solution()
            if xc is not None and xo is not None:
                pts, valid = rl.esh_points(xc, xo)
                if valid.any():
                    added += self._cut_rows_at(pts, valid)
        if scheme in ("sample", "both"):
            cnt = int(self.env.options.get("root_linearization_samples"))
            pts = rl.sample_points(sp.vlb, sp.vub, x0, cnt)
            added += self._cuts_at(pts)
        if scheme == "rs1":
            # univariate tangent fans (rootLinScheme1_ :2195)
            pts = RootSchemes(rl).rs1_points(x0)
            if len(pts):
                added += self._cuts_at(pts)
        if scheme == "rs2":
            # neighborhood cuts around the root NLP point (:2415)
            pts = RootSchemes(rl).rs2_points(x0)
            if len(pts):
                added += self._cuts_at(pts)
        if scheme == "rs3":
            # LP-guided ESH rounds: solve LP -> boundary cuts -> resolve
            xc = rl.analytic_center(sp.vlb, sp.vub)
            if xc is None:
                xc = x0 if np.all(np.isfinite(x0)) else None
            if xc is not None:
                for _ in range(max(1, int(self.env.options.get(
                        "root_linearization_samples")) // 4)):
                    xo = self._root_lp_solution()
                    if xo is None:
                        break
                    pts, valid = rl.esh_points(xc, xo)
                    if not valid.any():
                        break
                    got = self._cut_rows_at(pts, valid)
                    added += got
                    if not got:
                        break
        if added:
            self._log.info(f"root linearizations ({scheme}): "
                           f"{added} cuts")

    def _root_lp_solution(self) -> Optional[np.ndarray]:
        """Solve the current master LP once (exterior point for ESH): one
        lane of the lane-batched solver."""
        if self._root_lp_solver is None:
            self._root_lp_solver = build_single_solver(
                self.sp, self._ipm_opts, self.device)
        dev = self.device
        # fresh copies, not _device_consts(): the root presolve still
        # edits the master rows in place after this call
        A, clb, cub = (to_device(a, dev) for a in
                       (self.mA, self.mclb, self.mcub))
        res = self._root_lp_solver(
            A, clb, cub, to_device(self.sp.vlb, dev)[None],
            to_device(self.sp.vub, dev)[None],
            torch.zeros((1, self.sp.n), dtype=torch.float64, device=dev))
        if int(res.status[0]) not in (EngineStatus.SOLVED_OPTIMAL,
                                      EngineStatus.ITERATION_LIMIT):
            return None
        x = res.x[0].cpu().numpy()[:self.sp_orig.n]
        return x if np.all(np.isfinite(x)) else None

    # --------------------------------------------------------- overrides
    def solve(self) -> SolveStatus:
        st = self._qg_root()
        if st is not None:
            return st
        st = super().solve()
        if st == SolveStatus.SOLVED_INFEASIBLE and \
                self._feas_witness is not None and \
                self._witness_violates_pool(self._feas_witness):
            # A point feasible for the continuous NLP relaxation violates
            # the cut pool: the cuts are NOT valid for this model (it
            # breaks QG's convexity assumption), so neither is the
            # infeasibility conclusion built on them.  Report FINISHED
            # (unknown) instead of a wrong infeasibility claim.
            self._log.error(
                "cut pool cuts off a known NLP-feasible point: the model "
                "is NONCONVEX and QG linearizations are invalid for it. "
                "Result is inconclusive — re-run with mglob (global "
                "solver).")
            self.status = SolveStatus.FINISHED
            st = self.status
        return st

    def _witness_violates_pool(self, xw: np.ndarray) -> bool:
        """True iff a continuous-relaxation-feasible point violates some
        cut row (with eta set to its true objective value) — the runtime
        signature of an invalid (nonconvex-model) linearization."""
        z = np.zeros(self.sp.n)
        z[:self.sp_orig.n] = xw
        if self.has_eta:
            z[self.sp_orig.n] = float(self.problem.eval_objective(xw))
        ax = self.mA[self._cut_base:] @ z
        tol = 1e-6 * (1.0 + np.abs(ax))
        return bool(np.any(ax > self.mcub[self._cut_base:] + tol) or
                    np.any(ax < self.mclb[self._cut_base:] - tol))

    def _qg_root(self) -> Optional[SolveStatus]:
        """Root continuous NLP + initial linearization (initLinear_).
        Returns a terminal status or None to continue into the tree."""
        sp = self.sp_orig
        if self.env.options.get("trimloss_heur"):
            # constructive heuristic for square-encoded trimloss models
            # (bnb/trimloss.py): detection no-ops on other structures;
            # on tls* it seeds the exact cutting-stock optimum as the
            # incumbent, which plain QG only reaches by deep descent
            # (QGHandler.cpp:205/:627 path)
            from .trimloss import construct_trimloss
            try:
                r = construct_trimloss(self.problem)
            except Exception as e:   # detection must never kill a solve
                self._log.debug(f"trimloss heuristic failed: {e}")
                r = None
            if r is not None:
                xh, objh = r
                self._log.info(
                    f"trimloss construction: verified incumbent {objh:.8g}")
                self._accept_incumbent(xh, objh)
            # valid knapsack rows implied by the bilinear demand
            # semantics (bnb/trimloss.py::trimloss_valid_rows): the
            # sqrt reformulation's LP is loose by ~5x on tls4; these
            # implied capacity + Chvatal-rounding rows close most of
            # that at the root.  Installed in the cut pool (cuts are
            # inequality rows; certified LP duals price them soundly).
            from .trimloss import trimloss_valid_rows
            n_vr = 0
            for coefs, lo, hi in trimloss_valid_rows(self.problem):
                c2 = np.zeros(self.sp.n)
                c2[:len(coefs)] = coefs
                n_vr += bool(self._add_cut(c2, lo, hi))
            if n_vr:
                self._log.info(f"trimloss: {n_vr} implied demand/"
                               f"capacity rows installed at the root")
        res = self._nlp_solve(sp.A, sp.clb, sp.cub,
                              sp.vlb[None, :], sp.vub[None, :])
        self.qg_stats.nlp_solves += 1
        status = int(res.status[0])
        x0 = np.asarray(res.x[0])
        if status == EngineStatus.SOLVED_INFEASIBLE:
            # The engine marks certificate-backed infeasibility (empty box
            # or Farkas ray on the linear rows) with dual_bound = +BIG; an
            # NLP lane can also report INFEASIBLE heuristically (mu
            # collapse at a locally-infeasible stationary point of a
            # NONCONVEX model), which proves nothing about the problem.
            # Only the certified kind may declare global infeasibility;
            # the heuristic kind falls through to the multistart rescue.
            if float(res.dual_bound[0]) > 1e15:
                self.status = SolveStatus.SOLVED_INFEASIBLE
                return self.status
            status = EngineStatus.ITERATION_LIMIT
        if status == EngineStatus.ITERATION_LIMIT:
            # root NLP stalled (locally-infeasible stationary point or
            # nonconvex cycling): rescue with one vmapped multistart batch
            # (reference: NLPMultiStart / QuadHandler fixNodeErr rescue)
            from .multistart import multistart_solve
            bx, bobj, info = multistart_solve(
                self.problem_sp_for_ms(), self.problem, n_starts=16,
                seed=int(self.env.options.get("rand_seed")),
                ipm=self._ipm_opts, device=self.device)
            self.qg_stats.nlp_solves += info["n_starts"]
            if bx is not None:
                x0 = bx
                self._feas_witness = bx
                self._log.info(
                    f"root NLP stalled; multistart rescue found a point "
                    f"(obj {bobj:.8g}, {info['n_feasible']}/"
                    f"{info['n_starts']} feasible lanes)")
                if info.get("best_status") == EngineStatus.SOLVED_OPTIMAL \
                        and np.isfinite(bobj):
                    # under QG's convexity contract a converged KKT
                    # point of the continuous relaxation IS its global
                    # optimum (the linearization cuts already rest on
                    # convexity), so the rescue optimum anchors the eta
                    # bound and the root floor exactly like a clean
                    # root solve — without this, a TPU-side root stall
                    # left tls4 floorless (lb dropped to loose
                    # unconverged certificates, 1.71 -> 1.47).  The gate
                    # is on the BEST lane's engine status: a merely-
                    # feasible ITERATION_LIMIT lane's objective only
                    # upper-bounds the relaxation optimum and anchoring
                    # on it could cut off the optimal region (unsound).
                    if self.has_eta:
                        self.sp.vlb[sp.n] = bobj - sp.obj_const - 1e-6
                    self._root_lb0 = bobj - 1e-6
        if status != EngineStatus.SOLVED_OPTIMAL and \
                getattr(self, "_root_lb0", -_INF) <= -_INF:
            # UNCONDITIONAL floor (round-4 regression: a TPU-side root
            # stall where the rescue's best lane also failed to converge
            # left the run floorless, and the committed sweep's tls4 lb
            # fell to 1.43 — below the proven 1.709 relaxation value the
            # tests pin).  Solve the continuous relaxation ONCE in f64 on
            # the host CPU backend (seconds at n~300) and anchor the eta
            # bound / root floor from a *converged* value only.
            anchored = self._cpu_root_anchor()
            if anchored is not None:
                self._log.info(
                    f"root NLP unconverged on device; CPU f64 anchor "
                    f"solved the relaxation: floor {anchored:.8g}")
        if status == EngineStatus.SOLVED_OPTIMAL and \
                np.all(np.isfinite(x0)) and \
                self.problem.is_feasible(x0, atol=1e-5, int_tol=_INF):
            self._feas_witness = x0.copy()
        if status in (EngineStatus.SOLVED_OPTIMAL,
                      EngineStatus.ITERATION_LIMIT):
            self._cuts_at(x0[None, :])
            self._root_linearizations(x0)
            if status == EngineStatus.SOLVED_OPTIMAL:
                if self.has_eta:
                    # eta >= continuous relaxation optimum (valid lb)
                    self.sp.vlb[sp.n] = float(res.obj[0]) - \
                        sp.obj_const - 1e-6
                # ...and every node's objective inherits it: floor the
                # root node bound so unconverged lanes' loose certified
                # duals cannot drag the reported/propagated lb below the
                # proven continuous-relaxation value (children only add
                # cuts and tighten boxes, so the floor stays valid down
                # the tree via parent-bound inheritance; valid with or
                # without an eta column — the relaxation optimum lower-
                # bounds the MINLP objective directly)
                self._root_lb0 = float(res.obj[0]) - 1e-6
            # integral root NLP solution -> incumbent
            ints = sp.int_mask
            if np.all(np.abs(x0[ints] - np.round(x0[ints])) <= self._int_tol) \
                    and status == EngineStatus.SOLVED_OPTIMAL:
                xr = x0.copy()
                xr[ints] = np.round(xr[ints])
                if self.problem.is_feasible(xr, atol=1e-5,
                                            int_tol=self._int_tol):
                    self._accept_incumbent(
                        xr, float(self.problem.eval_objective(xr)))
        return None

    def _cpu_root_anchor(self) -> Optional[float]:
        """Solve the continuous relaxation in f64 on the CPU and,
        if it CONVERGES, anchor the eta lower bound and the root floor
        (`_root_lb0`) from its objective.  Called only when both the
        device root NLP and the multistart rescue failed to converge —
        without this, the propagated lb falls back to loose unconverged
        certificates (reference analogue: the root relaxation value is
        always available because Ipopt runs on the host,
        QGHandler.cpp:224).  Returns the floor value or None.  The CPU is
        this algorithm's choice, not a stand-in for the device: a failure
        of the solve raises."""
        sp = self.sp_orig
        opts = dataclasses.replace(
            self._ipm_opts, factor_f32=False, tail_factor_f32=False,
            max_iters=max(120, self._ipm_opts.max_iters))
        solver = build_batch_solver(sp, opts, device="cpu")
        res = solver(sp.A, sp.clb, sp.cub, sp.vlb[None, :], sp.vub[None, :])
        self.qg_stats.nlp_solves += 1
        if int(res.status[0]) != EngineStatus.SOLVED_OPTIMAL or \
                not np.isfinite(float(res.obj[0])):
            self._log.info("CPU f64 root anchor did not converge either; "
                           "lb keeps unconverged certificates")
            return None
        val = float(res.obj[0])
        if self.has_eta:
            self.sp.vlb[sp.n] = val - sp.obj_const - 1e-6
        self._root_lb0 = val - 1e-6
        x0 = np.asarray(res.x[0])
        if np.all(np.isfinite(x0)):
            self._cuts_at(x0[None, :])
        return val

    def problem_sp_for_ms(self):
        """Original-space staged problem for the multistart rescue."""
        return self.sp_orig

    def _master_arrays(self):
        return self.mA, self.mclb, self.mcub

    def _consts_version(self) -> int:
        # the device copies of the master arrays are refreshed only when
        # the cut pool changed (cheap bookkeeping beats re-uploading every
        # step); every pool write bumps the epoch
        return getattr(self, "_cut_epoch", 0)

    def _try_fixint_incumbents(self, x_master_batch: np.ndarray) -> None:
        """Fix integers at the given master-space points, solve the NLPs,
        and harvest incumbents + cuts."""
        sp = self.sp_orig
        n = sp.n
        ints = sp.int_mask
        B = x_master_batch.shape[0]
        vlb2 = np.tile(sp.vlb, (B, 1))
        vub2 = np.tile(sp.vub, (B, 1))
        xr = np.round(x_master_batch[:, :n])
        fixv = np.clip(xr[:, ints], vlb2[:, ints], vub2[:, ints])
        vlb2[:, ints] = fixv
        vub2[:, ints] = fixv
        res = self._nlp_solve(sp.A, sp.clb, sp.cub, vlb2, vub2,
                              x_master_batch[:, :n])
        self.qg_stats.nlp_solves += B
        xs = np.asarray(res.x)
        sts = np.asarray(res.status)
        self._cuts_at(xs[:self._heur_cut_lanes])
        for b in range(B):
            if sts[b] in (EngineStatus.SOLVED_OPTIMAL,
                          EngineStatus.ITERATION_LIMIT) and \
                    np.all(np.isfinite(xs[b])) and \
                    self.problem.is_feasible(xs[b], atol=1e-5,
                                             int_tol=self._int_tol):
                self._accept_incumbent(
                    xs[b], float(self.problem.eval_objective(xs[b])))

    def _run_pump(self, x_start: np.ndarray) -> None:
        if self._fp is None:
            return
        pts = self._fp.run(*self._device_consts(),
                           self.sp.vlb, self.sp.vub, x_start,
                           int_tol=self._int_tol)
        if pts:
            self._try_fixint_incumbents(np.stack(pts))

    def _run_dive(self, x_start: np.ndarray, lanes: int = 16,
                  rounds: int = 22) -> None:
        """Vectorized diving on the master LP (reference: MINLPDiving.cpp
        — the four Scoretype schemes, MINLPDiving.h:47-53, with the
        backtrack_ bound flip, MINLPDiving.cpp:99).  Each round fixes
        the best-scored unfixed integers per lane and re-solves the
        master LP; the fused step's FBBT propagates the fixings through
        linking equality rows, repairing dependent integers for free.
        Under `divheur_scheme=auto` the lanes deal out the reference's
        scheme family (frac/veclen/lex/rcost) instead of running the
        combinations sequentially; `frac` lanes differ by tie-breaking
        noise."""
        from .heuristics import (DiveBacktrack, dive_round,
                                 dive_scheme_for_lane, dive_scores)
        ints = np.where(self.sp.int_mask)[0]
        if len(ints) == 0:
            return
        scheme_opt = str(self.env.options.get("divheur_scheme"))
        schemes = [dive_scheme_for_lane(scheme_opt, b) for b in range(lanes)]
        # veclen/rcost inputs: master objective gradient = c (the master
        # is an LP), column fan-out over the base rows, running-average
        # reduced costs per lane (reference avgDual_)
        c_m = self.sp.c
        ncols = (self.sp.A != 0).sum(axis=0).astype(float)
        avg_rc = np.zeros((lanes, self.sp.n))
        n_rc = 0
        vlb = np.tile(self.sp.vlb, (lanes, 1))
        vub = np.tile(self.sp.vub, (lanes, 1))
        x = np.tile(x_start, (lanes, 1))
        alive = np.ones(lanes, dtype=bool)
        bt = [DiveBacktrack() for _ in range(lanes)]
        for r in range(rounds):
            res = self._run_step(vlb, vub, x)
            status = np.asarray(res.status)
            db = np.asarray(res.dual_bound)
            x = np.asarray(res.x)
            y = np.asarray(res.y)
            nvlb = np.asarray(res.new_vlb).copy()
            nvub = np.asarray(res.new_vub).copy()
            if any(s == "rcost" for s in schemes):
                rc = c_m[None, :] - y @ self.mA
                avg_rc = (avg_rc * n_rc + rc) / (n_rc + 1)
                n_rc += 1
            died = alive & ((status == EngineStatus.SOLVED_INFEASIBLE) |
                            (db >= 1e15))
            for b in np.where(died)[0]:
                flip = bt[b].on_death(x[b])
                if flip is not None:
                    nvlb[b], nvub[b] = flip
                    died[b] = False
            alive &= ~died
            vlb, vub = nvlb, nvub
            if not alive.any():
                return
            unfixed = (vub[:, ints] - vlb[:, ints]) > 0.5
            n_unfixed = unfixed.sum(axis=1)
            if not (alive & (n_unfixed > 0)).any():
                break
            for b in np.where(alive)[0]:
                nu = int(n_unfixed[b])
                if nu == 0 or not np.isfinite(x[b]).all():
                    continue
                k = max(1, nu // max(3, rounds - 1 - r))
                frac = np.abs(x[b, ints] - np.round(x[b, ints]))
                score = dive_scores(schemes[b], x[b], ints, frac, c_m,
                                    ncols, avg_rc[b])
                if schemes[b] == "frac":
                    score = score + self._rng.uniform(
                        0, 0.05, size=len(ints)) * (b > 0)
                score = np.where(unfixed[b], score, np.inf)
                pick = ints[np.argsort(score)[:k]]
                direction = "nearest" if scheme_opt == "frac" else \
                    ("nearest", "ceil", "floor", "farthest")[(b // 4) % 4]
                v = np.clip(dive_round(direction, x[b, pick],
                                       self._int_tol),
                            vlb[b, pick], vub[b, pick])
                bt[b].push(vlb[b], vub[b], pick, v)
                vlb[b, pick] = v
                vub[b, pick] = v
            self.stats.solves += lanes
        # harvest: lanes with all ints fixed and alive
        done = alive & ((vub[:, ints] - vlb[:, ints]) <= 0.5).all(axis=1)
        if done.any():
            self._try_fixint_incumbents(x[done])

    def _run_true_dive(self, x_start: np.ndarray, lanes: int = 16,
                       rounds: int = 24) -> None:
        """Diving on the TRUE model (nonlinear rows + their interval
        FBBT), not the LP master.  Master dives produce fixings that
        violate the nonlinear rows on instances whose nl rows carry the
        demand structure (tls4's sqrt rows: every naive rounding is
        infeasible by ~1e3), because the master only sees their
        linearizations.  Each round runs the fused TRUE-model step —
        FBBT with the nonlinear-DAG projection propagates each fixing
        through the sqrt rows before the next pick — then fixes the
        least-fractional unfixed integers per lane (tie-broken with
        per-lane noise), with the same 1-level backtrack as _run_dive."""
        sp = self.sp_orig
        if not len(sp.nl_rows):
            return
        if getattr(self, "_true_step", None) is None:
            from .step import build_node_step, StepOptions
            self._true_step = build_node_step(sp, StepOptions(
                int_tol=self._int_tol, fbbt_rounds=2, ipm=self._ipm_opts),
                self.device)
        ints = np.where(sp.int_mask)[0]
        if not len(ints):
            return
        from .heuristics import (DiveBacktrack, dive_round,
                                 dive_scheme_for_lane, dive_scores)
        scheme_opt = str(self.env.options.get("divheur_scheme"))
        schemes = [dive_scheme_for_lane(scheme_opt, b) for b in range(lanes)]
        c_t = sp.c
        ncols_t = (sp.A != 0).sum(axis=0).astype(float)
        for g in sp.nl_graphs:
            ncols_t[g.vars_used()] += 1.0
        avg_rc = np.zeros((lanes, sp.n))
        n_rc = 0
        vlb = np.tile(sp.vlb, (lanes, 1))
        vub = np.tile(sp.vub, (lanes, 1))
        x = np.tile(x_start[:sp.n], (lanes, 1))
        y = np.zeros((lanes, sp.m))
        alive = np.ones(lanes, dtype=bool)
        bt = [DiveBacktrack() for _ in range(lanes)]
        for r in range(rounds):
            res = self._true_step(sp.A, sp.clb, sp.cub, vlb, vub, x, y)
            self.stats.solves += lanes
            self.qg_stats.nlp_solves += lanes
            status = np.asarray(res.status)
            db = np.asarray(res.dual_bound)
            x = np.array(res.x)
            y = np.array(res.y)
            nvlb = np.array(res.new_vlb)
            nvub = np.array(res.new_vub)
            if any(s == "rcost" for s in schemes):
                rc = c_t[None, :] - y @ sp.A
                avg_rc = (avg_rc * n_rc + rc) / (n_rc + 1)
                n_rc += 1
            died = alive & ((status == EngineStatus.SOLVED_INFEASIBLE) |
                            (db >= 1e15))
            for b in np.where(died)[0]:
                flip = bt[b].on_death(x[b])
                if flip is not None:
                    nvlb[b], nvub[b] = flip
                    died[b] = False
            alive &= ~died
            vlb, vub = nvlb, nvub
            if not alive.any():
                return
            unfixed = (vub[:, ints] - vlb[:, ints]) > 0.5
            n_unfixed = unfixed.sum(axis=1)
            done = alive & (n_unfixed == 0)
            if done.any():
                break
            for b in np.where(alive)[0]:
                nu = int(n_unfixed[b])
                if nu == 0 or not np.isfinite(x[b]).all():
                    continue
                k = max(1, nu // max(3, rounds - 1 - r))
                frac = np.abs(x[b, ints] - np.round(x[b, ints]))
                score = dive_scores(schemes[b], x[b], ints, frac, c_t,
                                    ncols_t, avg_rc[b])
                if schemes[b] == "frac":
                    score = score + self._rng.uniform(
                        0, 0.05, size=len(ints)) * (b > 0)
                score = np.where(unfixed[b], score, np.inf)
                pick = ints[np.argsort(score)[:k]]
                if scheme_opt == "frac":
                    # ceil-biased odd lanes: on monotone-decreasing rows
                    # (tls4's sqrt demand constraints) rounding UP is
                    # the feasible direction — nearest-rounding lanes
                    # die on the demand side
                    direction = "ceil" if b % 2 else "nearest"
                else:
                    direction = ("nearest", "ceil", "floor",
                                 "farthest")[(b // 4) % 4]
                v = np.clip(dive_round(direction, x[b, pick],
                                       self._int_tol),
                            vlb[b, pick], vub[b, pick])
                bt[b].push(vlb[b], vub[b], pick, v)
                vlb[b, pick] = v
                vub[b, pick] = v
        # harvest: fully-fixed alive lanes carry a true-model NLP
        # solution at an integer fixing already
        done = alive & ((vub[:, ints] - vlb[:, ints]) <= 0.5).all(axis=1)
        for b in np.where(done)[0]:
            xc = np.clip(x[b], vlb[b], vub[b])
            xc[sp.int_mask] = np.round(xc[sp.int_mask])
            if np.all(np.isfinite(xc)) and \
                    self.problem.is_feasible(xc, atol=1e-5,
                                             int_tol=self._int_tol):
                self._accept_incumbent(
                    xc, float(self.problem.eval_objective(xc)))

    def _monotone_repair(self, xr: np.ndarray, rounds: int = 3) -> np.ndarray:
        """Greedy integer repair of rounded points against the nonlinear
        rows: step every integer var one unit in the direction its
        gradient says reduces the worst violation, up to ``rounds``
        times (reference: LinFeasPump directional rounding,
        LinFeasPump.cpp).  Crucial on monotone rows — tls4's
        sqrt-demand constraints are DECREASING in every integer var, so
        plain round() is infeasible half the time while one +1 step per
        violated row repairs it."""
        sp = self.sp_orig
        if sp.con_nl is None or not len(sp.nl_rows):
            return xr
        xr = xr.copy()
        ints = sp.int_mask
        big = 1e6
        for _ in range(rounds):
            B = xr.shape[0]
            out = self._cut_gen(xr)
            g = out["g"]
            Jg = np.nan_to_num(out["Jg"], nan=0.0, posinf=big, neginf=-big)
            changed = False
            for b in range(B):
                for k, r in enumerate(sp.nl_rows):
                    act = float(sp.A[r] @ xr[b] + g[b, k])
                    grow = sp.A[r] + Jg[b, k]
                    if np.isfinite(sp.cub[r]) and act > sp.cub[r] + 1e-7:
                        sdir = -np.sign(grow)
                    elif np.isfinite(sp.clb[r]) and act < sp.clb[r] - 1e-7:
                        sdir = np.sign(grow)
                    else:
                        continue
                    mask = ints & (np.abs(grow) > 1e-9)
                    if not mask.any():
                        continue
                    xr[b, mask] = np.clip(xr[b, mask] + sdir[mask],
                                          sp.vlb[mask], sp.vub[mask])
                    changed = True
            if not changed:
                break
        return xr

    def _vio_gated_lanes(self, batch: List[Node], xs: np.ndarray,
                         lanes: List[int]) -> List[int]:
        """Violation-score ECP gating (QGHandlerAdvance.cpp:2803-2871).

        Each candidate node gets a score = mean relative violation of its
        nonlinear rows at the LP point; the score is stored on the node
        (children inherit it as their parent score), and a lane passes
        the gate when score >= max_vio_per * |parent score + 1e-3| with a
        finite parent score — i.e. cuts go where violations persist or
        grow down the tree."""
        sp = self.sp_orig
        n = sp.n
        pts = np.stack([xs[i][:n] for i in lanes])
        out = self._cut_gen(pts)
        gval = np.asarray(out["g"])                   # (L, K) nl parts
        act = pts @ sp.A[sp.nl_rows].T + gval         # row activities
        ub_r = sp.cub[sp.nl_rows][None, :]
        lb_r = sp.clb[sp.nl_rows][None, :]
        vio = np.maximum(
            np.where(np.isfinite(ub_r), act - ub_r, 0.0),
            np.where(np.isfinite(lb_r), lb_r - act, 0.0))
        scale = np.maximum(np.maximum(np.abs(ub_r), np.abs(lb_r)), 1.0)
        rel = np.where(vio > 1e-6, vio / scale, 0.0)
        n_vio = (rel > 0).sum(axis=1)
        scores = np.where(n_vio > 0, rel.sum(axis=1) / np.maximum(n_vio, 1),
                          0.0)
        passed = []
        for k, i in enumerate(lanes):
            node = batch[i]
            parent_score = node.vio_val
            node.vio_val = float(scores[k])
            if n_vio[k] and np.isfinite(parent_score) and \
                    scores[k] >= self._max_vio_per * abs(parent_score + 1e-3):
                passed.append(i)
        return passed

    def _dispatch_oracle(self, sep_lanes, heur_lanes, nvlb, nvub, xs):
        """Build and ASYNC-dispatch the batched fix-int NLP oracle
        (reference: QGHandler::fixInts_ -> solveNLP_, QGHandler.cpp:205,
        627).  Rounding-dive lanes ride the same batched call: fractional
        LP solutions get their integers rounded+fixed and solved too — a
        batch-cheap primal heuristic (reference divheur analogue) that
        supplies the incumbents plain QG only finds at integral LPs.
        Returns (handle, B2, n_harvest) or None; unpack with
        self._nlp_solve.unpack(handle)."""
        if not (sep_lanes or heur_lanes):
            return None
        sp = self.sp_orig
        n = sp.n
        all_lanes = sep_lanes + heur_lanes
        B2 = len(all_lanes)
        bucket = 1
        while bucket < B2:
            bucket *= 4
        idxs = all_lanes + [all_lanes[0]] * (bucket - B2)
        vlb2 = np.stack([nvlb[i][:n] for i in idxs])
        vub2 = np.stack([nvub[i][:n] for i in idxs])
        # heuristic lanes use partition-aware rounding with noise for
        # diversity (naive rounding always breaks set-partition rows)
        n_sep = len(sep_lanes)
        xr_list = []
        for j, i in enumerate(idxs):
            if j < n_sep or not self._part_rows:
                xr_list.append(np.round(xs[i][:n]))
            else:
                from .heuristics import partition_round
                xr_list.append(partition_round(
                    xs[i][:n], self._part_rows, sp.int_mask,
                    rng=self._rng, noise=0.0 if j == n_sep else 0.3))
        from .heuristics import partition_round as _part_round
        xr2 = np.stack(xr_list)
        # padding lanes carry monotone-REPAIRED roundings over the
        # GLOBAL box instead of wasted duplicates of lane 0
        n_pad = bucket - B2
        n_harvest = B2
        if n_pad > 0 and len(sp.nl_rows) and (heur_lanes or sep_lanes):
            srcs = (heur_lanes or sep_lanes)
            pick = [srcs[j % len(srcs)] for j in range(n_pad)]
            # partition-aware roundings on set-partition models:
            # naive rounding always breaks partition rows, so plain
            # np.round would seed every padding lane infeasible
            if self._part_rows:
                seeds = [_part_round(xs[i][:n], self._part_rows,
                                     sp.int_mask, rng=self._rng,
                                     noise=0.3) for i in pick]
            else:
                seeds = [np.round(xs[i][:n]) for i in pick]
            rep = self._monotone_repair(np.stack(seeds))
            for j in range(n_pad):
                xr2[B2 + j] = rep[j]
                vlb2[B2 + j] = sp.vlb
                vub2[B2 + j] = sp.vub
            n_harvest = bucket
        # repair heuristic/padding seeds against violated LINEAR rows
        # (separation lanes at integral LP points are already feasible
        # for the master rows and must stay untouched)
        if B2 > n_sep or n_harvest > B2:
            xr2[n_sep:] = self._linear_repair(xr2[n_sep:])
        ints = sp.int_mask
        fixv = np.clip(xr2[:, ints], vlb2[:, ints], vub2[:, ints])
        vlb2[:, ints] = fixv
        vub2[:, ints] = fixv
        x0 = np.stack([xs[i][:n] for i in idxs])
        handle = self._nlp_solve.dispatch(sp.A, sp.clb, sp.cub,
                                          vlb2, vub2, x0)
        return handle, B2, n_harvest

    def _handle_batch(self, batch: List[Node], res, next_id: int,
                      seen: Optional[set] = None) -> int:
        status = np.asarray(res.status)
        obj = np.asarray(res.obj)
        db = np.asarray(res.dual_bound)
        xs = np.asarray(res.x)
        int_feas = np.asarray(res.int_feasible)
        bvar = np.asarray(res.branch_var)
        bval = np.asarray(res.branch_val)
        nvlb = np.asarray(res.new_vlb)
        nvub = np.asarray(res.new_vub)
        sp = self.sp_orig
        n = sp.n
        self._update_cut_activity(xs)
        # --- separation: integral LP lanes -> batched fix-int NLPs ------
        # Classify lanes FIRST and dispatch the oracle ASYNCHRONOUSLY:
        # the cut separation below (ECP, covers, LGCI) overlaps with the
        # oracle's device execution and only the harvest blocks.  tls4
        # profile: the oracle is the dominant per-batch device cost.
        sep_lanes: List[int] = []
        heur_lanes: List[int] = []
        if seen is None:
            seen = set()
        seen_sep = set(seen)
        for i, node in enumerate(batch):
            if id(node) in seen:
                continue
            seen.add(id(node))
            if status[i] not in (EngineStatus.SOLVED_OPTIMAL,
                                 EngineStatus.ITERATION_LIMIT) or \
                    db[i] >= 1e15:
                continue
            if int_feas[i]:
                sep_lanes.append(i)
            elif len(heur_lanes) < self._heur_lanes_cap:
                heur_lanes.append(i)
        oracle = self._dispatch_oracle(sep_lanes, heur_lanes, nvlb, nvub,
                                       xs)

        # ECP-style linearization at fractional LP points (reference:
        # QGHandlerAdvance cutMethod_="ecp", QGHandlerAdvance.cpp:75):
        # gradient cuts are valid anywhere for convex bodies and lift the
        # eta bound without waiting for integral solutions
        frac_lanes = [i for i in range(len(batch))
                      if status[i] == EngineStatus.SOLVED_OPTIMAL
                      and not int_feas[i]
                      and np.all(np.isfinite(xs[i][:n]))]
        if self._max_vio_per > 0 and len(sp.nl_rows) and \
                sp.con_nl is not None and frac_lanes:
            # violation-gated ECP (QGHandlerAdvance.cpp:2803-2871): score
            # a node by the mean relative violation of its nl rows at the
            # LP point; cut only when it is >= max_vio_per x the parent's
            # score (violations growing down the tree = cuts pay off)
            ecp_pts = [xs[i][:n] for i in
                       self._vio_gated_lanes(batch, xs, frac_lanes)[:4]]
        elif self._ecp_period and \
                self.stats.batches % self._ecp_period == 0:
            ecp_pts = [xs[i][:n] for i in frac_lanes[:4]]
        else:
            ecp_pts = []
        if ecp_pts:
            self._cuts_at(np.stack(ecp_pts))

        # knapsack cover cuts from a few fractional LP points (reference:
        # KnapCovHandler separation)
        if self._knap_rows:
            from .cuts import separate_cover_cuts
            for i in range(min(len(batch), 4)):
                if status[i] != EngineStatus.SOLVED_OPTIMAL or int_feas[i]:
                    continue
                for vars_, rhs in separate_cover_cuts(self._knap_rows,
                                                      xs[i][:n]):
                    coefs = np.zeros(self.sp.n)
                    coefs[vars_] = 1.0
                    self._add_cut(coefs, -_INF, rhs)
            # GNS lifted GUB covers (reference: LGCIGenerator) from the
            # most fractional LP point: general-coefficient cuts that
            # dominate plain covers when lifting succeeds
            from .cuts import separate_lgci_cuts
            for i in range(min(len(batch), 2)):
                if status[i] != EngineStatus.SOLVED_OPTIMAL or int_feas[i]:
                    continue
                for vars_, lcoefs, rhs in separate_lgci_cuts(
                        self._knap_rows, self._gub_rows, xs[i][:n],
                        max_cuts=4):
                    coefs = np.zeros(self.sp.n)
                    coefs[vars_] = lcoefs
                    self._add_cut(coefs, -_INF, rhs)

        # periodic primal heuristics while no incumbent exists: diving
        # first (FBBT-guided), pump as fallback
        if self.ub >= _INF and self.stats.batches % self._fp_period == 1 \
                and len(batch):
            best_lane = int(np.argmin(np.where(
                status[:len(batch)] == EngineStatus.SOLVED_OPTIMAL,
                obj[:len(batch)], _INF)))
            if status[best_lane] == EngineStatus.SOLVED_OPTIMAL:
                self._run_dive(xs[best_lane])
                if self.ub >= _INF and len(self.sp_orig.nl_rows):
                    # master dives round against LINEARIZED rows only;
                    # the true-model dive propagates fixings through the
                    # nonlinear rows' interval FBBT (the tls4 class)
                    self._run_true_dive(xs[best_lane])
                if self.ub >= _INF and self._fp is not None:
                    self._run_pump(xs[best_lane])

        nlp_res = None
        if oracle is not None:
            handle, B2, n_harvest = oracle
            nlp_res = self._nlp_solve.unpack(handle)
            self.qg_stats.nlp_solves += B2
            self.stats.solves += B2
            nlp_x = np.asarray(nlp_res.x)[:n_harvest]
            nlp_obj = np.asarray(nlp_res.obj)[:n_harvest]
            nlp_status = np.asarray(nlp_res.status)[:n_harvest]
            # cap the cut slice at the REAL lane count: padding lanes are
            # monotone-repaired global-box seeds meant for incumbent
            # checks only, not cut anchors
            self._cuts_at(nlp_x[:min(len(sep_lanes) + self._heur_cut_lanes,
                                     B2)])
            # heuristic lanes: incumbent check only
            for j in range(len(sep_lanes), n_harvest):
                if nlp_status[j] in (EngineStatus.SOLVED_OPTIMAL,
                                     EngineStatus.ITERATION_LIMIT) and \
                        np.all(np.isfinite(nlp_x[j])) and \
                        self.problem.is_feasible(nlp_x[j], atol=1e-5,
                                                 int_tol=self._int_tol):
                    self._accept_incumbent(
                        nlp_x[j],
                        float(self.problem.eval_objective(nlp_x[j])))

        # --- per-node decisions -----------------------------------------
        sep_map = {i: j for j, i in enumerate(sep_lanes)}
        for i, node in enumerate(batch):
            if id(node) in seen_sep:
                continue
            seen_sep.add(id(node))
            if i in sep_map:
                j = sep_map[i]
                next_id = self._process_integral_lane(
                    node, float(obj[i]), float(db[i]), nlp_x[j],
                    float(nlp_obj[j]), int(nlp_status[j]),
                    nvlb[i], nvub[i], xs[i], next_id)
            else:
                next_id = self._process_result(
                    node, status[i], obj[i], db[i], xs[i],
                    bool(int_feas[i]), int(bvar[i]), float(bval[i]),
                    nvlb[i], nvub[i], next_id)
        return next_id

    def _process_integral_lane(self, node: Node, lp_obj: float, lp_db: float,
                               x_nlp: np.ndarray, nlp_obj: float,
                               nlp_status: int, nvlb, nvub, x_lp,
                               next_id: int) -> int:
        """Reference: QGHandler::cutIntSol_ (:143) semantics."""
        sp = self.sp_orig
        node_bound = max(node.lb, lp_db if lp_db > -_INF else node.lb)

        feasible_nlp = False
        if nlp_status in (EngineStatus.SOLVED_OPTIMAL,
                          EngineStatus.ITERATION_LIMIT) and \
                np.all(np.isfinite(x_nlp)):
            feasible_nlp = self.problem.is_feasible(
                x_nlp, atol=1e-5, int_tol=self._int_tol)
        if feasible_nlp:
            self.qg_stats.nlp_feasible += 1
            self._accept_incumbent(
                x_nlp, float(self.problem.eval_objective(x_nlp)))
        else:
            self.qg_stats.nlp_infeasible += 1

        # bound closed? (reference :161-200)
        ref = max(abs(nlp_obj), 1.0)
        if feasible_nlp and nlp_status == EngineStatus.SOLVED_OPTIMAL and \
                lp_obj >= nlp_obj - self._abs_tol - self._rel_tol * ref:
            node.status = NodeStatus.PRUNED_OPTIMAL
            return next_id
        if node_bound >= self._cutoff():
            node.status = NodeStatus.PRUNED_BY_BOUND
            return next_id

        # not closed: re-queue against the enriched cut pool
        node.tb_score += 1.0
        if node.tb_score > self._requeue_cap:
            self.unresolved_lb = min(self.unresolved_lb, node_bound)
            self.stats.unresolved += 1
            node.status = NodeStatus.DOMINATED
            return next_id
        self.qg_stats.requeues += 1
        node.lb = node_bound
        node.vlb = nvlb.copy()
        node.vub = nvub.copy()
        node.warm_x = x_lp.copy()
        self.tm.insert_candidate(node)
        return next_id


def solve_file_qg(path: str, env: Optional[Environment] = None,
                  device="cuda") -> QGBranchAndBound:
    from ..io.nl_reader import read_nl
    p = read_nl(path)
    bab = QGBranchAndBound(p, env=env, device=device)
    bab.solve()
    return bab
