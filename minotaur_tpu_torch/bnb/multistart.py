"""Multistart NLP solving.

Reference: MsProcessor.{h,cpp} (per-node multistart NLP solves with
`msbnb_scheme_id` random/corner start schemes) and NLPMultiStart /
MultiStart.cpp.  All restarts of a node solve as ONE lane-batched IPM
call — the reference loops over OpenMP threads (MsProcessor.cpp:166-294).

Port of minotaur_tpu/bnb/multistart.py: the JAX package's code, with the
device named by the caller (`device=`, default "cuda").
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..engines.ipm import IPMOptions, build_batch_solver
from ..engines.staging import StagedProblem
from ..utils.types import EngineStatus


def sample_starts(vlb: np.ndarray, vub: np.ndarray, n_starts: int,
                  rng: np.random.Generator, box_cap: float = 10.0
                  ) -> np.ndarray:
    """Random interior points; infinite bounds sample in [-box_cap, cap]
    around 0 (reference scheme 0) plus corner-biased points (scheme 4)."""
    n = len(vlb)
    lo = np.where(np.isfinite(vlb), vlb, -box_cap)
    hi = np.where(np.isfinite(vub), vub, box_cap)
    hi = np.maximum(hi, lo + 1e-6)
    u = rng.uniform(size=(n_starts, n))
    starts = lo + u * (hi - lo)
    # bias a third of the starts toward corners
    k = n_starts // 3
    if k:
        corners = np.where(rng.uniform(size=(k, n)) < 0.5, lo, hi)
        starts[:k] = 0.9 * corners + 0.1 * starts[:k]
    return starts


def multistart_solve(sp: StagedProblem, problem, n_starts: int = 32,
                     seed: int = 0, ipm: IPMOptions = IPMOptions(),
                     vlb: Optional[np.ndarray] = None,
                     vub: Optional[np.ndarray] = None, device="cuda",
                     ) -> Tuple[Optional[np.ndarray], float, dict]:
    """Solve min f over the (continuous relaxation of the) box from many
    random starts in one vmapped batch; returns (best_x, best_obj, info).
    Feasibility is verified on the host problem."""
    rng = np.random.default_rng(seed)
    vlb = sp.vlb if vlb is None else vlb
    vub = sp.vub if vub is None else vub
    solve = build_batch_solver(sp, ipm, device)
    starts = sample_starts(vlb, vub, n_starts, rng)
    res = solve(sp.A, sp.clb, sp.cub,
                np.tile(vlb, (n_starts, 1)), np.tile(vub, (n_starts, 1)),
                starts)
    xs = np.asarray(res.x)
    objs = np.asarray(res.obj)
    sts = np.asarray(res.status)
    best_x, best_obj = None, float("inf")
    best_status = None
    n_feas = 0
    for b in range(n_starts):
        if sts[b] in (EngineStatus.SOLVED_OPTIMAL,
                      EngineStatus.ITERATION_LIMIT) and \
                np.all(np.isfinite(xs[b])) and \
                problem.is_feasible(xs[b], atol=1e-5, int_tol=np.inf):
            n_feas += 1
            if objs[b] < best_obj:
                best_obj = float(objs[b])
                best_x = xs[b].copy()
                best_status = int(sts[b])
    # best_status lets callers distinguish a CONVERGED best lane
    # (SOLVED_OPTIMAL: a KKT point whose objective may anchor bounds
    # under a convexity contract) from a merely-feasible stalled lane
    # (ITERATION_LIMIT: objective is an upper bound on nothing)
    info = {"n_starts": n_starts, "n_feasible": n_feas,
            "best_status": best_status,
            "distinct_objs": len(np.unique(np.round(objs[sts == 1], 6)))}
    return best_x, best_obj, info


from .bnb import BranchAndBound  # noqa: E402  (after helpers by design)


class MsBranchAndBound(BranchAndBound):
    """In-tree multistart node processing.

    Reference: MsProcessor.{h,cpp} — each node's relaxation is re-solved
    from `msbnb_restarts` start points (random + corner schemes,
    `msbnb_scheme_id`, MsProcessor.cpp:166-294), the reference looping
    over OpenMP threads.  TPU-native design: the restarts are extra
    lanes of the SAME lane-batched superstep — a popped node occupies R
    adjacent lanes with distinct starts and the lane results merge on
    the host by best converged objective.  The merged dual bound is the
    MIN over lanes (the weakest claim: restarts of a nonconvex NLP are
    local solves, so a smaller reported bound is never less sound than
    a larger one).
    """

    def __init__(self, problem, env=None, staged=None, device="cuda"):
        super().__init__(problem, env, staged, device)
        opts = self.env.options
        self._restarts = max(1, int(opts.get("msbnb_restarts")))
        self._ms_rng = np.random.default_rng(
            int(opts.get("rand_seed")) + 91)
        if self._restarts > 1:
            # keep the device batch size; pop fewer tree nodes
            self._batch = max(1, self._batch // self._restarts)

    def _expand_batch(self, batch):
        if self._restarts == 1:
            return batch
        out = []
        for nd in batch:
            out.extend([nd] * self._restarts)
        return out

    def _lane_starts(self, batch):
        if self._restarts == 1:
            return super()._lane_starts(batch)
        xs = []
        prev = None
        for nd in batch:
            first = nd is not prev
            prev = nd
            if first and nd.warm_x is not None:
                xs.append(np.asarray(nd.warm_x, dtype=float))
            else:
                xs.append(sample_starts(nd.vlb, nd.vub, 1, self._ms_rng)[0])
        return np.stack(xs)

    def _handle_batch(self, batch, res, next_id, seen=None):
        if self._restarts == 1:
            return super()._handle_batch(batch, res, next_id, seen)
        fields = {f: np.asarray(getattr(res, f)) for f in res._fields}
        lanes = {}
        order = []
        for i, nd in enumerate(batch):
            ls = lanes.setdefault(id(nd), [])
            if not ls:
                order.append(nd)
            ls.append(i)
        ok_status = (int(EngineStatus.SOLVED_OPTIMAL),
                     int(EngineStatus.ITERATION_LIMIT))
        sel = []
        dbs = []
        for nd in order:
            ls = lanes[id(nd)]
            best, bi = np.inf, ls[0]
            for i in ls:
                ob = float(fields["obj"][i])
                if int(fields["status"][i]) in ok_status and \
                        np.isfinite(ob) and ob < best:
                    best, bi = ob, i
            sel.append(bi)
            dbs.append(min(float(fields["dual_bound"][i]) for i in ls))
        sel = np.asarray(sel)
        merged = {f: arr[sel] for f, arr in fields.items()}
        merged["dual_bound"] = np.asarray(dbs)
        return super()._handle_batch(order, type(res)(**merged),
                                     next_id, seen)
