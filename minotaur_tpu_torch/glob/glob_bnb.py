"""Spatial branch-and-bound driver for nonconvex MIQCQP.

Port of minotaur_tpu/glob/glob_bnb.py.  The host code is the JAX
package's, as it is; the device seam is the step (glob_step.py: one
packed result a batch), the fix-int polish (`build_batch_solver`) and
root OBBT (`with_objective` on 2 nz lanes), and the device is named by
the caller (`device=`, default "cuda").

Reference: Glob.{h,cpp} createBab_ (:134) — B&B over the McCormick/secant
LP relaxation with spatial + integrality branching, node FBBT and
envelope refresh (the reference mutates SecantMods; we recompute
envelopes from the box inside the step).
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np

from ..bnb.node import Node
from ..bnb.tree import TreeManager
from ..device import resolve_device
from ..engines.ipm import IPMOptions
from ..ir.problem import Problem
from ..utils.environment import Environment
from ..utils.types import EngineStatus, NodeStatus, SolveStatus, \
    TreeSearchOrder
from .glob_step import GlobStepOptions, build_glob_step
from .transformer import GlobStaged, transform

_INF = float("inf")


class GlobBranchAndBound:
    def __init__(self, problem: Problem, env: Optional[Environment] = None,
                 device="cuda"):
        self.env = env or Environment()
        self.device = resolve_device(device)
        self.problem = problem
        opts = self.env.options
        self.gs: GlobStaged = transform(
            problem, multilinear_hull=int(opts.get("multilinear_hull")),
            multilinear_group=int(opts.get("multilinear_group")))
        n_rp = int(opts.get("rlt_row_products"))
        if n_rp > 0:
            # static row x row RLT products (the basis-free analogue of
            # the reference's simplex-tableau row products,
            # SimplexQuadCutGen.cpp:640) append to the master once
            from .rlt import append_rlt_row_products
            added = append_rlt_row_products(self.gs, max_cuts=n_rp)
            if added:
                self.env.logger.info(
                    f"rlt: {added} static row-product cuts appended")
        order = {"dfs": TreeSearchOrder.DFS, "bfs": TreeSearchOrder.BFS,
                 "BthenD": TreeSearchOrder.BEST_THEN_DIVE}.get(
                     opts.get("tree_search"), TreeSearchOrder.BEST_THEN_DIVE)
        self.tm = TreeManager(order)
        from ..bnb.solpool import SolutionPool
        self.sol_pool = SolutionPool(int(opts.get("sol_pool_size")))
        self.ub = _INF
        self.best_x: Optional[np.ndarray] = None
        self.lb = -_INF
        self.unresolved_lb = _INF
        self.status = SolveStatus.NOT_STARTED
        self._abs_tol = float(opts.get("solAbs_tol"))
        self._rel_tol = float(opts.get("solRel_tol"))
        self._int_tol = float(opts.get("int_tol"))
        self._node_limit = int(opts.get("bnb_node_limit"))
        self._time_limit = float(opts.get("bnb_time_limit"))
        self._batch = max(1, int(opts.get("node_batch")))
        self._log = self.env.logger
        self._log_interval = float(opts.get("bnb_log_interval"))
        self.nodes_processed = 0
        step_opts = GlobStepOptions(
            int_tol=self._int_tol,
            fbbt_rounds=int(opts.get("fbbt_rounds")),
            rlt_cuts=int(opts.get("rlt_cuts")),
            ipm=IPMOptions(max_iters=int(opts.get("ipm_max_iters")),
                           tol=float(opts.get("ipm_tol")),
                           use_pallas=bool(opts.get("ipm_use_pallas"))))
        self._step_opts = step_opts
        self._step = build_glob_step(self.gs, step_opts, self.device)
        # primal polish: fix integers at rounded batch solutions and
        # locally solve the ORIGINAL problem (QG's _try_fixint_incumbents
        # pattern; the reference glob path gets incumbents from
        # QuadHandler::fixNodeErr NLP rescues)
        self._ipm_opts = step_opts.ipm
        self._polish_solve = None
        self._polish_period = 4     # supersteps between polish batches
        self._polish_lanes = 8
        self._steps_done = 0

    def _fixint_polish(self, xs_glob: np.ndarray) -> None:
        """xs_glob: (B, nz) glob-space batch solutions; fix rounded ints
        in the original space, solve the continuous rest, harvest."""
        from ..engines.ipm import build_batch_solver
        from ..engines.staging import stage_problem
        p = self.problem
        if self._polish_solve is None:
            self._sp_orig = stage_problem(p)
            self._polish_solve = build_batch_solver(
                self._sp_orig, self._ipm_opts, self.device)
        sp = self._sp_orig
        ints = sp.int_mask
        n = sp.n
        B = min(self._polish_lanes, xs_glob.shape[0])
        xs = xs_glob[:B, :n]
        # dedup candidate roundings
        seen = set()
        cands = []
        for b in range(B):
            if not np.all(np.isfinite(xs[b])):
                continue
            key = tuple(np.round(xs[b][ints]).astype(np.int64))
            if key in seen:
                continue
            seen.add(key)
            cands.append(xs[b])
        if not cands:
            return
        Bc = len(cands)
        vlb2 = np.tile(sp.vlb, (Bc, 1))
        vub2 = np.tile(sp.vub, (Bc, 1))
        x0 = np.stack(cands)
        if ints.any():
            fixv = np.clip(np.round(x0[:, ints]), vlb2[:, ints],
                           vub2[:, ints])
            vlb2[:, ints] = fixv
            vub2[:, ints] = fixv
        res = self._polish_solve(sp.A, sp.clb, sp.cub, vlb2, vub2, x0)
        rx = np.asarray(res.x)
        sts = np.asarray(res.status)
        for b in range(Bc):
            for cand in (rx[b] if sts[b] in (1, 4) and
                         np.all(np.isfinite(rx[b])) else None,
                         np.clip(x0[b], vlb2[b], vub2[b])):
                if cand is None:
                    continue
                if self.problem.is_feasible(cand, atol=1e-5,
                                            int_tol=self._int_tol):
                    val = float(self.problem.eval_objective(cand))
                    self.sol_pool.add(cand, val)
                    if val < self.ub - 1e-12:
                        self.ub = val
                        self.best_x = cand.copy()
                        self.tm.set_cutoff(self._cutoff())
                        self.tm.prune_by_cutoff()

    def _root_obbt(self, vlb: np.ndarray, vub: np.ndarray):
        """Root OBBT over the envelope LP relaxation: min/max every
        extended variable (x AND aux terms) as ONE vmapped batch of
        2*nz LPs (reference: QuadHandler::postSolveRootNode ->
        tightenLP_, QuadHandler.cpp:2218, which solves them serially).
        Certified dual bounds make the tightening sound even on
        unconverged lanes."""
        from ..engines.ipm import build_single_solver, to_device
        from ..engines.staging import StagedProblem
        from .glob_step import build_envelope_fn
        gs = self.gs
        nz = gs.n
        dev = self.device
        env_fn = build_envelope_fn(gs, self._step_opts, dev)
        eA, elb, eub = (a[0].cpu().numpy()
                        for a in env_fn(vlb[None], vub[None]))
        sp = StagedProblem(
            name=gs.name + "-obbt", n=nz, m=gs.A.shape[0] + eA.shape[0],
            c=np.zeros(nz), obj_const=0.0, Qobj=None, obj_nl=None,
            A=np.vstack([gs.A, eA]),
            clb=np.concatenate([gs.clb, elb]),
            cub=np.concatenate([gs.cub, eub]),
            vlb=vlb, vub=vub, int_mask=gs.int_mask,
            nl_rows=np.zeros(0, np.int32), con_nl=None, nl_graphs=[])
        solver = build_single_solver(sp, self._ipm_opts, dev).with_objective
        cs = np.zeros((2 * nz, nz))
        cs[np.arange(nz), np.arange(nz)] = 1.0
        cs[nz + np.arange(nz), np.arange(nz)] = -1.0
        x0 = np.zeros((2 * nz, nz))
        lanes = lambda a: to_device(np.tile(a, (2 * nz, 1)), dev)  # noqa
        res = solver(to_device(sp.A, dev), to_device(sp.clb, dev),
                     to_device(sp.cub, dev), lanes(vlb), lanes(vub),
                     to_device(x0, dev), to_device(cs, dev))
        db = res.dual_bound.cpu().numpy()
        new_lo = np.maximum(vlb, db[:nz] - 1e-9)
        new_hi = np.minimum(vub, -db[nz:] + 1e-9)
        ok = new_lo <= new_hi + 1e-9
        new_lo = np.where(ok, new_lo, vlb)
        new_hi = np.where(ok, new_hi, vub)
        ints = gs.int_mask
        new_lo[ints] = np.ceil(new_lo[ints] - self._int_tol)
        new_hi[ints] = np.floor(new_hi[ints] + self._int_tol)
        nt = int(np.sum(new_lo > vlb + 1e-7) +
                 np.sum(new_hi < vub - 1e-7))
        if nt:
            self._log.info(f"root OBBT: {nt} bound changes over "
                           f"{2 * nz} batched LPs")
        ds = self.problem.debug_sol
        if ds is not None and not np.all(
                (ds >= new_lo[:gs.n_x] - 1e-6) &
                (ds <= new_hi[:gs.n_x] + 1e-6)):
            raise AssertionError("glob OBBT cut off the debug solution")
        return new_lo, new_hi

    def _gap(self) -> float:
        if self.ub >= _INF or self.lb <= -_INF:
            return _INF
        return (self.ub - self.lb) / max(abs(self.ub), 1e-10)

    def _cutoff(self) -> float:
        if self.ub >= _INF:
            return _INF
        return self.ub - min(self._abs_tol, abs(self.ub) * self._rel_tol)

    def solve(self) -> SolveStatus:
        t0 = time.monotonic()
        last_log = t0
        nz = self.gs.n
        self.status = SolveStatus.STARTED
        vlb0, vub0 = self.gs.vlb.copy(), self.gs.vub.copy()
        if self.env.options.get("obbt"):
            vlb0, vub0 = self._root_obbt(vlb0, vub0)
        self.tm.insert_root(Node(nid=0, depth=0, lb=-_INF,
                                 vlb=vlb0, vub=vub0))
        next_id = 1
        while len(self.tm):
            if self._gap() <= self._rel_tol or \
                    (self.ub - self.lb) <= self._abs_tol:
                self.status = SolveStatus.SOLVED_OPTIMAL
                break
            if self.nodes_processed >= self._node_limit:
                self.status = SolveStatus.SOLVED_NODE_LIMIT
                break
            if time.monotonic() - t0 > self._time_limit:
                self.status = SolveStatus.SOLVED_TIME_LIMIT
                break
            self.tm.set_cutoff(self._cutoff())
            batch = self.tm.pop_batch(self._batch)
            if not batch:
                break
            B = len(batch)
            bucket = 1
            while bucket < B:
                bucket *= 4
            bucket = min(bucket, self._batch)
            while B < bucket:
                batch.append(batch[0])
                B += 1
            vlb_b = np.stack([nd.vlb for nd in batch])
            vub_b = np.stack([nd.vub for nd in batch])
            x0_b = np.stack([nd.warm_x if nd.warm_x is not None
                             else np.zeros(nz) for nd in batch])
            res = self._step(vlb_b, vub_b, x0_b)
            self.nodes_processed += len(set(id(nd) for nd in batch))
            self._steps_done += 1
            if self._steps_done % self._polish_period == 1 or \
                    self.ub >= _INF:
                self._fixint_polish(np.asarray(res.x))

            status = np.asarray(res.status)
            obj = np.asarray(res.obj)
            db = np.asarray(res.dual_bound)
            xs = np.asarray(res.x)
            int_ok = np.asarray(res.int_feasible)
            term_ok = np.asarray(res.term_feasible)
            bvar = np.asarray(res.branch_var)
            bval = np.asarray(res.branch_val)
            spat = np.asarray(res.is_spatial)
            nvlb = np.asarray(res.new_vlb)
            nvub = np.asarray(res.new_vub)

            seen = set()
            for i, node in enumerate(batch):
                if id(node) in seen:
                    continue
                seen.add(id(node))
                next_id = self._process(
                    node, status[i], obj[i], db[i], xs[i], bool(int_ok[i]),
                    bool(term_ok[i]), int(bvar[i]), float(bval[i]),
                    bool(spat[i]), nvlb[i], nvub[i], next_id)

            open_lb = min(self.tm.best_lb(), self.unresolved_lb)
            self.lb = min(open_lb, self.ub)
            now = time.monotonic()
            if now - last_log >= self._log_interval:
                last_log = now
                self._log.info(
                    f"  {now - t0:8.1f}s nodes {self.nodes_processed:8d} "
                    f"open {len(self.tm):6d} lb {self.lb:.8g} "
                    f"ub {self.ub:.8g} gap {self._gap() * 100:.4g}%")

        if self.status in (SolveStatus.STARTED, SolveStatus.NOT_STARTED):
            if self.unresolved_lb < self._cutoff():
                self.lb = min(self.unresolved_lb, self.ub)
                self.status = SolveStatus.SOLVED_GAP_LIMIT \
                    if self.ub < _INF else SolveStatus.FINISHED
            elif self.ub < _INF:
                self.status = SolveStatus.SOLVED_OPTIMAL
                self.lb = self.ub
            else:
                self.status = SolveStatus.SOLVED_INFEASIBLE
        return self.status

    def _process(self, node: Node, status: int, obj: float, db: float,
                 x: np.ndarray, int_ok: bool, term_ok: bool, bvar: int,
                 bval: float, spatial: bool, nvlb, nvub, next_id: int) -> int:
        bound = max(node.lb, db if db > -_INF else node.lb)
        if status == EngineStatus.SOLVED_INFEASIBLE or bound >= 1e15:
            node.status = NodeStatus.PRUNED_INFEASIBLE
            return next_id
        if bound >= self._cutoff():
            node.status = NodeStatus.PRUNED_BY_BOUND
            return next_id

        if int_ok and term_ok and status in (
                EngineStatus.SOLVED_OPTIMAL, EngineStatus.ITERATION_LIMIT):
            xx = np.clip(x[:self.gs.n_x], nvlb[:self.gs.n_x],
                         nvub[:self.gs.n_x])
            ints = self.gs.int_mask[:self.gs.n_x]
            xx[ints] = np.round(xx[ints])
            cand = None
            if self.problem.is_feasible(xx, atol=1e-5,
                                        int_tol=self._int_tol):
                cand = xx
            elif self.problem.is_feasible(x[:self.gs.n_x], atol=1e-5,
                                          int_tol=self._int_tol):
                cand = x[:self.gs.n_x].copy()
            if cand is not None:
                val = float(self.problem.eval_objective(cand))
                self.sol_pool.add(cand, val)
                if val < self.ub - 1e-12:
                    self.ub = val
                    self.best_x = cand
                    self.tm.set_cutoff(self._cutoff())
                    self.tm.prune_by_cutoff()
                node.status = NodeStatus.PRUNED_OPTIMAL
                return next_id
            self.unresolved_lb = min(self.unresolved_lb, bound)
            node.status = NodeStatus.DOMINATED
            return next_id

        if bvar < 0:
            self.unresolved_lb = min(self.unresolved_lb, bound)
            node.status = NodeStatus.DOMINATED
            return next_id

        children: List[Node] = []
        if spatial:
            w = nvub[bvar] - nvlb[bvar]
            if not np.isfinite(w) or w < 1e-9:
                self.unresolved_lb = min(self.unresolved_lb, bound)
                node.status = NodeStatus.DOMINATED
                return next_id
            for side in (0, 1):
                cvlb = nvlb.copy()
                cvub = nvub.copy()
                if side == 0:
                    cvub[bvar] = bval
                else:
                    cvlb[bvar] = bval
                children.append(Node(nid=next_id + side,
                                     depth=node.depth + 1, lb=bound,
                                     vlb=cvlb, vub=cvub, warm_x=x.copy(),
                                     branch_var=bvar))
        else:
            lo = math.floor(bval + self._int_tol)
            if math.isfinite(nvlb[bvar]):
                lo = max(lo, int(math.ceil(nvlb[bvar] - 1e-9)))
            if math.isfinite(nvub[bvar]):
                lo = min(lo, int(math.floor(nvub[bvar] + 1e-9)) - 1)
            for side in (0, 1):
                cvlb = nvlb.copy()
                cvub = nvub.copy()
                if side == 0:
                    cvub[bvar] = lo
                else:
                    cvlb[bvar] = lo + 1
                children.append(Node(nid=next_id + side,
                                     depth=node.depth + 1, lb=bound,
                                     vlb=cvlb, vub=cvub, warm_x=x.copy(),
                                     branch_var=bvar))
        node.status = NodeStatus.BRANCHED
        self.tm.branch(children, node)
        return next_id + 2
