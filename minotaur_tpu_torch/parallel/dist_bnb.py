"""Distributed branch-and-bound over a list of devices.

Reference: MpiBranchAndBound (the fork's core addition).  Mapping:

  rank-local node pools          -> per-partition TreeManagers
  tag-1 async incumbent gossip   -> min of the partitions' best objectives
                                    inside the sharded step
  LoadBalance_ (Allgather+deal)  -> host-side global sort + round-robin deal
                                    every `lb_frequency` supersteps
  termination (all lb infinite)  -> all pools empty

With a single controller the partitions share an address space, but the
structure is the multi-host one: each partition only contributes its own
nodes to a superstep, and nodes migrate only at deal points, so the
search trajectory matches what a true multi-host run would produce.

Port of minotaur_tpu/parallel/dist_bnb.py.  The host loop is the JAX
package's; the device seam is `devices` (a list of `torch.device`,
repeats allowed) in place of the mesh, and the distributed step takes
the IPM options the base driver built (`_step_opts`: `dtype`,
`ipm_chol_retry`, the KKT and refinement rounds), where the JAX driver
builds its own `StepOptions` from three options and drops the rest.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from ..bnb.bnb import BranchAndBound
from ..bnb.node import Node
from ..bnb.step import StepResult
from ..bnb.tree import TreeManager
from ..device import DeviceLike
from ..ir.problem import Problem
from ..utils.environment import Environment
from ..utils.types import SolveStatus
from .pool import build_sharded_step, deal_round_robin

_INF = float("inf")


class DistBranchAndBound(BranchAndBound):
    """Batched B&B where the node batch is split across devices and the
    pool is partitioned, with periodic global load balancing.  The base
    driver (root, heuristics, dives) runs on devices[0]."""

    def __init__(self, problem: Problem, devices: Sequence[DeviceLike],
                 env: Optional[Environment] = None):
        super().__init__(problem, env=env, device=devices[0])
        self._init_dist(devices)

    def _init_dist(self, devices: Sequence[DeviceLike]) -> None:
        opts = self.env.options
        self._sharded = build_sharded_step(self.sp, self._step_opts, devices)
        self.devices = self._sharded.devices
        self.n_parts = len(self.devices)
        self.pools: List[TreeManager] = [
            self._make_tree(self.tm.order, None)
            for _ in range(self.n_parts)]
        self._lb_freq = max(1, int(opts.get("lb_frequency")))
        # batch must be a multiple of the partition count
        per = max(1, self._batch // self.n_parts)
        self._batch = per * self.n_parts

    def solve(self) -> SolveStatus:
        t0 = time.monotonic()
        last_log = t0
        self.status = SolveStatus.STARTED
        root = Node(nid=0, depth=0, lb=-_INF,
                    vlb=self.sp.vlb.copy(), vub=self.sp.vub.copy())
        self.pools[0].insert_root(root)
        next_id = 1
        superstep = 0

        while any(len(p) for p in self.pools):
            stop = self._should_stop(t0)
            if stop is not None:
                self.status = stop
                break
            superstep += 1

            # periodic global load balance (reference LoadBalance_)
            if superstep % self._lb_freq == 0:
                self._rebalance()

            per = self._batch // self.n_parts
            cutoff = self._cutoff()
            batch: List[Optional[Node]] = []
            for pool in self.pools:
                pool.set_cutoff(cutoff)
                popped = pool.pop_batch(per)
                # pad each partition to `per` with its first node or a
                # dummy copy of another partition's node
                batch.extend(popped + [None] * (per - len(popped)))
            live = [nd for nd in batch if nd is not None]
            if not live:
                break
            filler = live[0]
            batch = [nd if nd is not None else filler for nd in batch]

            vlb_b = np.stack([nd.vlb for nd in batch])
            vub_b = np.stack([nd.vub for nd in batch])
            # _lane_starts: cold NL lanes get the box midpoint (a zero
            # start stalls nonconvex NLP lanes, see bnb.py:_lane_starts)
            x0_b = self._lane_starts(batch)
            y0_b = self._lane_duals(batch)
            # device copies of the master arrays, made again only when
            # the QG cut pool changed (_consts_version)
            A_d, clb_d, cub_d = self._device_consts()
            res, gub = self._sharded(A_d, clb_d, cub_d,
                                     vlb_b, vub_b, x0_b, y0_b, self.ub)
            # the fused bound is the multi-host incumbent-gossip signal;
            # in this single-controller setting the host verifies
            # candidates before accepting, so gub only serves as a
            # monotone hint/consistency check
            if gub < self.ub - 1e-9:
                self._log.debug(f"  fused gub {gub:.8g} awaiting "
                                f"host verification (ub {self.ub:.8g})")
            self.stats.batches += 1
            self.stats.solves += len(batch)

            # route each partition's slice through the algorithm's batch
            # handler (QG separation etc.) with children captured into the
            # owning partition's pool; the shared `seen` set prevents
            # cross-partition filler duplicates from being processed twice
            shared_seen: set = set()
            for part in range(self.n_parts):
                lo, hi = part * per, (part + 1) * per
                sub_batch = batch[lo:hi]
                sub_res = StepResult(*(f[lo:hi] for f in res))
                self._capture_part = part
                next_id = self._handle_batch(sub_batch, sub_res, next_id,
                                             shared_seen)

            open_lb = min([p.best_lb() for p in self.pools] +
                          [self.unresolved_lb])
            self.lb = min(open_lb, self.ub)
            self.stats.nodes_processed = sum(p.nodes_processed
                                             for p in self.pools)
            self.stats.nodes_created = sum(p.nodes_created
                                           for p in self.pools)
            now = time.monotonic()
            if now - last_log >= self._log_interval:
                last_log = now
                sizes = [len(p) for p in self.pools]
                self._log.info(
                    f"  {now - t0:8.1f}s nodes {self.stats.nodes_processed:8d}"
                    f" open {sum(sizes):6d} {sizes} lb {self.lb:.8g}"
                    f" ub {self.ub:.8g} gap {self._gap() * 100:.4g}%")

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
        self.stats.time = time.monotonic() - t0
        # per-partition report (reference: per-rank Nodes Proc / Nodes
        # Created + times balanced, MpiBranchAndBound.cpp:408-436)
        self._log.info(
            "partition nodes processed: "
            f"{[p.nodes_processed for p in self.pools]}  "
            f"created: {[p.nodes_created for p in self.pools]}  "
            f"rebalances: {self.stats.rebalances} "
            f"({self.stats.nodes_migrated} migrated)")
        return self.status

    # children go to the partition that processed the parent; the tree
    # manager seen by the serial decision logic is the partition's
    def _handle_batch(self, batch, res, next_id, seen=None):
        part = getattr(self, "_capture_part", 0)
        self.tm = self.pools[part]  # redirect branch()/requeue target
        return super()._handle_batch(batch, res, next_id, seen)

    def _rebalance(self) -> None:
        """Global sort + round-robin deal (reference LoadBalance_,
        MpiBranchAndBound.cpp:78-195).  Each partition contributes only
        its `lb_pop_cap * P` best nodes (reference pops <= 50*world_size
        per rank, :93-107): draining whole pools made every balance round
        O(total open nodes) of host churn at 10^5-node scale; the tail of
        each pool stays put and keeps its owner."""
        sizes_before = [len(p) for p in self.pools]
        cap = int(self.env.options.get("lb_pop_cap")) * self.n_parts
        nodes: List[Node] = []
        owner: List[int] = []
        for k, pool in enumerate(self.pools):
            take = len(pool) if cap <= 0 else min(len(pool), cap)
            popped = pool.pop_best_nodes(take)
            nodes.extend(popped)
            owner.extend([k] * len(popped))
        if not nodes:
            return
        lbs = np.array([nd.lb for nd in nodes])
        parts = deal_round_robin(lbs, self.n_parts)
        migrated = int(np.sum(parts != np.asarray(owner)))
        for nd, prt in zip(nodes, parts):
            self.pools[int(prt)].insert_candidate(nd)
        self.stats.rebalances += 1
        self.stats.nodes_migrated += migrated
        self._log.debug(f"  rebalance #{self.stats.rebalances}: "
                        f"{sizes_before} -> "
                        f"{[len(p) for p in self.pools]} "
                        f"({migrated} migrated)")


from ..bnb.qg import QGBranchAndBound  # noqa: E402  (no import cycle)


class DistQGBranchAndBound(DistBranchAndBound, QGBranchAndBound):
    """Distributed Quesada-Grossmann, the mqgmpi equivalent
    (reference: QGMpi.{h,cpp} + MpiBranchAndBound).  The LP tree runs as a
    partitioned pool over the devices; the cut pool is global (the
    reference broadcasts the instance and keeps per-rank relaxations
    consistent through identical cut additions; here the cut pool is
    shared memory, replicated to the devices when it grows)."""

    def __init__(self, problem: Problem, devices: Sequence[DeviceLike],
                 env: Optional[Environment] = None):
        QGBranchAndBound.__init__(self, problem, env=env, device=devices[0])
        self._init_dist(devices)

    def solve(self):
        st = self._qg_root()
        if st is not None:
            return st
        return DistBranchAndBound.solve(self)
