"""Multi-tree Outer Approximation.

Reference: OAHandler.{h,cpp} + OA.cpp (the `moa` solver, not built by the
reference's CMake but shipped): alternate a MILP master (linearizations of
the nonlinear parts) with fixed-integer NLP subproblems until the master
bound meets the incumbent.

Here the MILP master is our own batched LP-based B&B over the shared
QG-style master problem (same preallocated cut pool), and the fixed-int
NLP is the batched IPM — so one OA iteration is: solve master MILP to
optimality, fix its integer solution, solve the NLP, add linearization
cuts at the NLP solution, repeat.

Port of minotaur_tpu/bnb/oa.py: the JAX package's code, on the device
named by the caller (`device=`, default "cuda").  The master MILP's
supersteps read the master arrays through `_device_consts` like every
other superstep (the JAX `_MasterMILP._run_step` passes the same arrays
explicitly).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..ir.problem import Problem
from ..utils.environment import Environment
from ..utils.types import EngineStatus, SolveStatus
from .bnb import BranchAndBound
from .qg import QGBranchAndBound

_INF = float("inf")


@dataclasses.dataclass
class OAStats:
    major_iters: int = 0
    milp_nodes: int = 0
    nlp_solves: int = 0
    cuts_added: int = 0
    mip_starts: int = 0


class OABranchAndBound(QGBranchAndBound):
    """Multi-tree OA driver reusing the QG master/cut machinery.

    Each major iteration re-runs the master MILP B&B from scratch against
    the enriched cut pool (multi-tree), with the incumbent as cutoff."""

    def __init__(self, problem: Problem, env: Optional[Environment] = None,
                 device="cuda"):
        super().__init__(problem, env=env, device=device)
        self.oa_stats = OAStats()
        self._max_major = 50

    def solve(self) -> SolveStatus:
        st = self._qg_root()
        if st is not None:
            return st
        sp = self.sp_orig
        n = sp.n
        import time
        t0 = time.monotonic()

        for it in range(self._max_major):
            self.oa_stats.major_iters = it + 1
            # --- master MILP over the current cut pool -------------------
            master_bab = _MasterMILP(self)
            mstatus = master_bab.solve()
            self.oa_stats.milp_nodes += master_bab.stats.nodes_processed
            self.lb = max(self.lb, master_bab.lb) if master_bab.lb > -_INF \
                else self.lb
            if master_bab.best_x is None:
                # no fixing candidate to continue with.  Claim
                # optimality/infeasibility ONLY when the master tree was
                # genuinely exhausted under the cutoff: the driver maps
                # an empty tree to SOLVED_OPTIMAL/SOLVED_INFEASIBLE only
                # when unresolved_lb >= cutoff (bnb.py), so those two
                # statuses certify "nothing below the incumbent".  Every
                # other no-incumbent ending (TIME/NODE limit, or
                # GAP_LIMIT/FINISHED where unresolved leaves were capped
                # BELOW the cutoff) is a limit outcome — treating it as
                # exhaustion would be unsound.
                if mstatus in (SolveStatus.SOLVED_OPTIMAL,
                               SolveStatus.SOLVED_INFEASIBLE):
                    self.status = SolveStatus.SOLVED_OPTIMAL \
                        if self.ub < _INF else SolveStatus.SOLVED_INFEASIBLE
                    if self.ub < _INF:
                        self.lb = self.ub
                else:
                    self.unresolved_lb = min(self.unresolved_lb,
                                             master_bab.lb)
                    self.status = mstatus if mstatus in (
                        SolveStatus.SOLVED_TIME_LIMIT,
                        SolveStatus.SOLVED_NODE_LIMIT) \
                        else SolveStatus.SOLVED_GAP_LIMIT
                break
            ref = max(abs(self.ub), 1.0)
            if self.ub < _INF and \
                    master_bab.ub >= self.ub - self._abs_tol - \
                    self._rel_tol * ref:
                # master found nothing better than the (MIP-started)
                # incumbent.  That proves optimality ONLY if the master
                # tree was exhausted; a time/node-limited master that
                # merely failed to improve is a limit outcome (claiming
                # OPTIMAL would be unsound — the gap stays open).
                if mstatus in (SolveStatus.SOLVED_OPTIMAL,
                               SolveStatus.SOLVED_INFEASIBLE):
                    self.lb = max(self.lb, min(master_bab.ub, self.ub))
                    self.status = SolveStatus.SOLVED_OPTIMAL
                else:
                    self.unresolved_lb = min(self.unresolved_lb,
                                             master_bab.lb)
                    self.status = mstatus if mstatus in (
                        SolveStatus.SOLVED_TIME_LIMIT,
                        SolveStatus.SOLVED_NODE_LIMIT) \
                        else SolveStatus.SOLVED_GAP_LIMIT
                break

            # --- fixed-integer NLP at the master solution ----------------
            xm = master_bab.best_x
            vlb2 = sp.vlb[None, :].copy()
            vub2 = sp.vub[None, :].copy()
            ints = sp.int_mask
            fix = np.clip(np.round(xm[:n][ints]), sp.vlb[ints], sp.vub[ints])
            vlb2[0, ints] = fix
            vub2[0, ints] = fix
            res = self._nlp_solve(sp.A, sp.clb, sp.cub, vlb2, vub2,
                                  xm[None, :n])
            self.oa_stats.nlp_solves += 1
            self.qg_stats.nlp_solves += 1
            x_nlp = np.asarray(res.x[0])
            before = self.qg_stats.cuts_added
            self._cuts_at(x_nlp[None, :])
            self.oa_stats.cuts_added += self.qg_stats.cuts_added - before
            if int(res.status[0]) in (EngineStatus.SOLVED_OPTIMAL,
                                      EngineStatus.ITERATION_LIMIT) and \
                    np.all(np.isfinite(x_nlp)) and \
                    self.problem.is_feasible(x_nlp, atol=1e-5,
                                             int_tol=self._int_tol):
                self._accept_incumbent(
                    x_nlp, float(self.problem.eval_objective(x_nlp)))
            if self.qg_stats.cuts_added == before:
                # no new cuts and not converged: avoid cycling
                self.unresolved_lb = min(self.unresolved_lb,
                                         master_bab.lb)
                self.status = SolveStatus.SOLVED_GAP_LIMIT
                break
            if time.monotonic() - t0 > self._time_limit:
                self.status = SolveStatus.SOLVED_TIME_LIMIT
                break
        else:
            self.status = SolveStatus.SOLVED_ITERATION_LIMIT
        self.stats.time = time.monotonic() - t0
        return self.status


class _MasterMILP(BranchAndBound):
    """One master MILP solve over the OA cut pool (no separation)."""

    def __init__(self, oa: OABranchAndBound):
        super().__init__(oa.problem, env=oa.env, staged=oa.sp,
                         device=oa.device)
        self._oa = oa
        self._step = oa._step                 # reuse the superstep
        self.ub = oa.ub                       # incumbent as cutoff only
        self.best_x = None
        # each master gets a SLICE of the budget, not all of it (the
        # round-2 driver let major iteration 1 consume the whole time
        # limit on tls4); the reference caps its master MILP the same
        # way (OA.cpp engine limits).  Budget knobs are options, not
        # constants — they decide whether OA terminates usefully.
        opts = oa.env.options
        self._time_limit = max(float(opts.get("oa_master_time_floor")),
                               oa._time_limit *
                               float(opts.get("oa_master_time_frac")))
        self._node_limit = min(self._node_limit,
                               int(opts.get("oa_master_node_limit")))
        # MIP-start injection (reference: CplexMILPEngine MIP starts,
        # CplexMILPEngine.cpp:688-1341 / OA's master warm start): the
        # OA incumbent, lifted into master space (eta = its true
        # objective), enters the master as a KNOWN feasible solution —
        # the cutoff is then backed by a point, so the master returns
        # it when nothing better exists instead of reporting empty.
        if oa.best_x is not None and np.isfinite(oa.ub):
            n_m = oa.sp.n
            xm = np.zeros(n_m)
            k = min(len(oa.best_x), n_m)
            xm[:k] = oa.best_x[:k]
            if oa.has_eta:
                xm[oa.sp_orig.n] = oa.ub - oa.sp_orig.obj_const
            self.best_x = xm
            oa.oa_stats.mip_starts += 1

    def _root_presolve(self):
        return None   # master bounds already tightened by the OA driver

    def _process_result(self, node, status, obj, db, x, int_feas, bvar,
                        bval, nvlb, nvub, next_id):
        # master accepts integral LP solutions directly (the MILP has no
        # nonlinear rows; feasibility w.r.t. the true problem is the OA
        # driver's job)
        from ..utils.types import NodeStatus
        bound = max(node.lb, db if db > -_INF else node.lb)
        if status == EngineStatus.SOLVED_INFEASIBLE or bound >= 1e15:
            node.status = NodeStatus.PRUNED_INFEASIBLE
            return next_id
        if bound >= self._cutoff():
            node.status = NodeStatus.PRUNED_BY_BOUND
            return next_id
        if int_feas and status in (EngineStatus.SOLVED_OPTIMAL,
                                   EngineStatus.ITERATION_LIMIT):
            val = float(obj)
            if val < self.ub - 1e-12:
                self.ub = val
                self.best_x = np.asarray(x).copy()
                self.tm.set_cutoff(self._cutoff())
                self.tm.prune_by_cutoff()
            node.status = NodeStatus.PRUNED_OPTIMAL
            return next_id
        if bvar < 0:
            self.unresolved_lb = min(self.unresolved_lb, bound)
            node.status = NodeStatus.DOMINATED
            return next_id
        return super()._process_result(node, status, obj, db, x, False,
                                       bvar, bval, nvlb, nvub, next_id)
