"""Device-resident multi-round B&B supersteps.

Port of minotaur_tpu/bnb/device_pool.py.  A fixed-capacity node pool
(bound boxes, inherited bounds, warm starts, pseudocosts) lives in device
memory, and one `multiround` call executes up to T complete B&B rounds —
select best nodes -> fused presolve+solve superstep -> certified prune /
incumbent candidate / branch -> insert children — before the host reads
one packed summary vector.  The host tree (`TreeManager`) remains the
overflow store: the pool is a device cache in front of it,
drained/refilled on congestion and at exit.

The JAX package compiles `multiround` into one program.  Here each round
is torch ops on the runner's device; the loop condition is read on the
host once a round, and the IPM inside the superstep still reads its
per-lane convergence mask on the host every iteration, so a round is not
free of host syncs (ROADMAP.md, Queue 2).

Reference: the serial loop this replaces is BranchAndBound::solve
(BranchAndBound.cpp:424-514): processKeepingNode / branch_ /
insertCandidate per node; here T*B of those iterations run per call.
Prune semantics mirror PCBProcessor::shouldPrune_ (PCBProcessor.cpp:
400-523) exactly as bnb.py::_process_result does.

Soundness argument:
- nodes are pruned only on *certified* dual bounds (the runner is built
  only for `_is_lp_relax or _certified_db` problems) against the
  HOST-VERIFIED cutoff, or on FBBT/Farkas infeasibility proofs;
- a device-accepted incumbent candidate (integral, converged, and
  feasible under a 2x-stricter device-side tolerance than the host
  acceptance test) may tighten the in-device cutoff immediately, but
  every prune that depended on the not-yet-host-verified value is
  tracked in `devrisk`; if the host's `Problem.is_feasible` ever rejects
  the candidate at sync (it cannot, for staged-1:1 LP/QP models, but
  belt and braces), `unresolved_lb` is capped at `devrisk`, which
  restores soundness by forfeiting the optimality claim instead of
  returning a wrong answer;
- anything unresolved (unconverged + no branching candidate) caps
  `unresolved_lb` exactly like the host path.

Spans (utils/trace.py): `pool.call` around each `multiround` call,
`pool.round` around each round in it, `pool.sync` around the
host's read of the round condition, `pool.summary` around the host
bookkeeping of a summary (count `processed`), `pool.spill` around a
congestion drain to the host tree (count `spilled`).
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from ..device import F32, F64
from ..utils import trace
from ..utils.types import EngineStatus
from .node import Node
from .step import build_node_step_unjitted

_INF = float("inf")
_OPT = int(EngineStatus.SOLVED_OPTIMAL)
_ITL = int(EngineStatus.ITERATION_LIMIT)
_INFEAS = int(EngineStatus.SOLVED_INFEASIBLE)

# state list layout (tensors on the runner's device).  The eleven pool
# fields have C + 1 rows: row C is a scratch row that absorbs the writes
# of invalid children (the JAX scatter drops writes to index C; a torch
# index out of range is a device-side assert on CUDA).  Every read uses
# the first C rows.
#  0 vlb   (C+1, n) node lower bounds
#  1 vub   (C+1, n) node upper bounds
#  2 wx    (C+1, n) primal warm start
#  3 wy    (C+1, m) dual warm start
#  4 lb    (C+1,)   inherited certified bound
#  5 depth (C+1,)   f64 depth (dive key)
#  6 bvar  (C+1,)   i32 var this node was branched on (-1 root)
#  7 bdir  (C+1,)   i32 0=down 1=up
#  8 bfrac (C+1,)   f64 fractional distance of the branch
#  9 pit   (C+1,)   f64 parent-lane IPM iteration count (difficulty
#                   estimate, Node.pred_iters)
# 10 used  (C+1,)   bool slot occupancy
# 11 pc_su (n,)     pseudocost up-gain sums
# 12 pc_cu (n,)     pseudocost up counts
# 13 pc_sd (n,)     pseudocost down-gain sums
# 14 pc_cd (n,)     pseudocost down counts
# 15 best_val ()    best device-accepted candidate value
# 16 best_x  (n,)   its point
# 17 scal  (8,)     [unres_lb, unres_cnt, processed, created,
#                    pruned_bound, pruned_infeas, closed_opt, iters]


def select_slots(key: torch.Tensor, k: int) -> torch.Tensor:
    """The k slots of smallest `key`, lower slot first on ties.

    The JAX package takes approx_max_k of -key in float32, which picks
    so where it is exact (on the CPU); here an exact stable sort on the
    card.  Sibling children have equal keys, so the tie rule decides
    which nodes are solved together.  Priority is a heuristic (any used
    slot is valid to process), so the float32 rounding of the key is
    harmless; bounds themselves stay float64."""
    prio = torch.nan_to_num((-key).to(F32), neginf=-3e38, posinf=3e38)
    return torch.sort(prio, descending=True, stable=True).indices[:k]


class DevicePoolRunner:
    """Owns the device pool and the multiround program for one
    BranchAndBound instance.  Use via `run(t0)`: consumes nodes from
    `bab.tm`, executes device-resident rounds until a stop condition or
    exhaustion, pushes any remainder back into `bab.tm`."""

    def __init__(self, bab, cap: int, batch: int, rounds: int):
        self.bab = bab
        self.sp = bab.sp
        self.device = bab.device
        self.C = int(cap)
        self.B = int(batch)
        self.T = int(rounds)
        if self.C < 4 * self.B:
            # the pool is filled to C // 2 and a round needs 2B free slots
            raise ValueError(f"device_pool_cap {self.C} is below 4 x "
                             f"node_batch ({4 * self.B})")
        self._n, self._m = self.sp.n, self.sp.m
        self._multiround, self._pack_pool = self._build()
        self._log = bab._log
        # totals over the search: multiround calls, device rounds, nodes
        # processed by device rounds
        self.calls = 0
        self.rounds = 0
        self.processed = 0

    # ------------------------------------------------------------ build
    def _build(self):
        bab, sp, dev = self.bab, self.sp, self.device
        n, C, B, T = sp.n, self.C, self.B, self.T
        step_b = build_node_step_unjitted(sp, bab._step_opts, dev)
        int_tol = float(bab._int_tol)
        abs_tol = float(bab._abs_tol)
        rel_tol = float(bab._rel_tol)
        # device acceptance is 2x stricter than the host test
        # (Problem.is_feasible with atol=max(feasAbs,1e-5)) so a device-
        # accepted point can never fail host verification at sync
        a_feas = 0.5 * max(bab._feas_atol, 1e-5)
        r_feas = 0.5 * max(bab._feas_rtol, 1e-5)
        frac_w = float(bab.env.options.get("br_frac_weight"))
        use_rel = bab._brancher in ("rel", "strong")
        rc_fix = bool(bab._is_lp_relax)
        int_mask = torch.as_tensor(sp.int_mask, dtype=torch.bool,
                                   device=dev)[None, :]
        iota_n = torch.arange(n, device=dev)
        cvec = torch.as_tensor(sp.c, dtype=F64, device=dev)
        Qsym = None
        if sp.Qobj is not None:
            Qsym = torch.as_tensor(0.5 * (sp.Qobj + sp.Qobj.T), dtype=F64,
                                   device=dev)
        obj_const = float(sp.obj_const)
        # dive-mode threshold: above half occupancy, deepest-first
        # selection (children replace parents; dives close leaves), so
        # the pool stabilizes instead of marching into a congestion drain
        # (each drain/refill moves the whole pool through the host)
        dive_hi = int(0.50 * C)
        child_dir = torch.tensor([0, 1], dtype=torch.int32,
                                 device=dev).repeat(B)
        slot_ids = torch.arange(C, device=dev)
        INF = _INF

        def pick(t, i):
            # row i (a 0-dim index tensor) of t, without a host read
            return t.index_select(0, i.reshape(1))[0]

        def eval_obj(xr):
            v = xr @ cvec + obj_const
            if Qsym is not None:
                v = v + ((xr @ Qsym) * xr).sum(dim=1)
            return v

        def one_round(A, clb, cub, cutoff_host, st, devrisk, hval, hx):
            """One B&B round on the pool, in place on `st`; returns the
            call's running (devrisk, hval, hx)."""
            (vlb, vub, wx, wy, lb, depth, bvar, bdir, bfrac, pit,
             used) = (t[:C] for t in st[:11])
            pc_su, pc_cu, pc_sd, pc_cd, best_val, best_x, scal = st[11:]
            unres_lb = scal[0]
            cut_cand = best_val - torch.clamp(best_val.abs() * rel_tol,
                                              max=abs_tol)
            cutoff = torch.clamp(cut_cand, max=cutoff_host)

            # ---- bulk prune against the freshest cutoff (the host tree
            # analogue is tm.prune_by_cutoff; here it also retires slots
            # cheaply before they cost a solve)
            kill = used & (lb >= cutoff)
            # prunes that relied on the unverified candidate cutoff
            risk0 = torch.where(kill & (lb < cutoff_host), lb, INF).amin()
            devrisk = torch.minimum(devrisk, risk0)
            n_bulk = kill.sum()
            used &= ~kill

            # ---- selection: best-then-dive (the host tree's BthenD key
            # (lb, -depth) — best bound first, DEEPER as tie-break so
            # just-created sibling children batch together with their
            # shared warm starts).  Under pool pressure switch to pure
            # deepest-first (dives close leaves and shrink the pool).
            occ = used.sum()
            bias = 1.5e-6 * (1.0 + lb.abs())
            key_best = torch.where(used, lb - bias * depth, INF)
            key_dive = torch.where(used, -depth, INF)
            key = torch.where(occ > dive_hi, key_dive, key_best)
            idx = select_slots(key, B)
            act = used[idx]
            # inactive lanes get a trivial fixed box (solves in O(1)
            # iterations; all their effects are masked)
            a2 = act[:, None]
            vlb_s = torch.where(a2, vlb[idx], 0.0)
            vub_s = torch.where(a2, vub[idx], 0.0)
            x0_s = torch.where(a2, wx[idx], 0.0)
            y0_s = torch.where(a2, wy[idx], 0.0)
            plb = torch.where(act, lb[idx], 0.0)
            pdep = torch.where(act, depth[idx], 0.0)
            pbv = torch.where(act, bvar[idx], -1)
            pbd = torch.where(act, bdir[idx], 0)
            pbf = torch.where(act, bfrac[idx], 0.0)

            res = step_b(A, clb, cub, vlb_s, vub_s, x0_s, y0_s)
            used[idx] = False

            db = res["dual_bound"]
            node_bound = torch.maximum(plb, torch.where(db > -INF, db, plb))
            nvlb, nvub = res["new_vlb"], res["new_vub"]
            xs, ys = res["x"], res["y"]
            status = res["status"]
            int_feas = res["int_feasible"]
            bvar_step = res["branch_var"]

            # ---- pseudocost update from the observed parent->child gain
            # (bnb.py _process_result lines; sums/counts so that
            # pc = sum/count equals the host's running average).  Lanes
            # that branched on one variable add to one entry: index_add_
            # sums them (an indexed += keeps only one)
            pc_ok = act & (pbv >= 0) & (plb > -INF) & \
                (node_bound > plb) & (pbf > 1e-9)
            gains = torch.where(pc_ok, (node_bound - plb) /
                                torch.clamp(pbf, min=1e-12), 0.0)
            jsafe = torch.clamp(pbv, min=0).long()
            up_m = pc_ok & (pbd == 1)
            dn_m = pc_ok & (pbd == 0)
            pc_su.index_add_(0, jsafe, torch.where(up_m, gains, 0.0))
            pc_cu.index_add_(0, jsafe, up_m.to(F64))
            pc_sd.index_add_(0, jsafe, torch.where(dn_m, gains, 0.0))
            pc_cd.index_add_(0, jsafe, dn_m.to(F64))

            # ---- prune decisions (certified bounds only; mirrors
            # _process_result for the certified-db class)
            p_inf = act & ((status == _INFEAS) | (node_bound >= 1e15))
            p_bnd = act & ~p_inf & (node_bound >= cutoff)
            risk1 = torch.where(p_bnd & (node_bound < cutoff_host),
                                node_bound, INF).amin()
            devrisk = torch.minimum(devrisk, risk1)
            live = act & ~p_inf & ~p_bnd

            # ---- incumbent candidates: integral + converged-ish +
            # device-feasible under the stricter tolerance
            int_ok = live & int_feas & ((status == _OPT) | (status == _ITL))
            xr = torch.minimum(torch.maximum(xs, nvlb), nvub)
            xr = torch.where(int_mask, torch.round(xr), xr)
            ax = xr @ A.T                                   # (B, m)
            rtol_lo = a_feas + r_feas * clb.abs()
            rtol_hi = a_feas + r_feas * cub.abs()
            rows_ok = ((ax >= clb - rtol_lo) &
                       (ax <= cub + rtol_hi)).all(dim=1)
            box_ok = ((xr >= nvlb - a_feas) &
                      (xr <= nvub + a_feas)).all(dim=1)
            vals = eval_obj(xr)
            accept = int_ok & rows_ok & box_ok & torch.isfinite(vals)
            supported = (status == _OPT) | \
                (node_bound >= vals - 1e-4 * (1.0 + vals.abs())) | \
                (res["kkt_err"] <= 1e-5)
            closed = accept & supported
            unres_new = (live & int_feas & ~accept) | \
                (accept & ~supported) | \
                (live & ~int_feas & (bvar_step < 0))
            unres_lb = torch.minimum(
                unres_lb, torch.where(unres_new, node_bound, INF).amin())
            devrisk = torch.minimum(
                devrisk, torch.where(closed, node_bound, INF).amin())
            # best candidate this round -> pool-level best
            cand_vals = torch.where(accept, vals, INF)
            bi = cand_vals.argmin()
            better = pick(cand_vals, bi) < best_val
            best_x.copy_(torch.where(better, pick(xr, bi), best_x))
            best_val.copy_(torch.where(better, pick(cand_vals, bi),
                                       best_val))

            branch = live & ~accept & ~unres_new & (bvar_step >= 0)

            # ---- reduced-cost bound tightening (RCHandler.cpp rc_fix;
            # LP-certified lanes only, identical to bnb.py::_rc_fix)
            if rc_fix:
                r = cvec[None, :] + ys @ A
                gap = cutoff - node_bound
                okl = ((status == _OPT) & torch.isfinite(gap) &
                       (gap >= 0))[:, None]
                at_lo = (xs - nvlb).abs() <= 1e-7 * (1 + nvlb.abs())
                at_hi = (nvub - xs).abs() <= 1e-7 * (1 + nvub.abs())
                max_up = torch.where((r > 1e-9) & at_lo & okl,
                                     nvlb + gap[:, None] /
                                     torch.where(r > 1e-9, r, 1.0), INF)
                max_dn = torch.where((r < -1e-9) & at_hi & okl,
                                     nvub + gap[:, None] /
                                     torch.where(r < -1e-9, r, 1.0), -INF)
                max_up = torch.where(int_mask, torch.floor(max_up + int_tol),
                                     max_up)
                max_dn = torch.where(int_mask, torch.ceil(max_dn - int_tol),
                                     max_dn)
                nvub = torch.minimum(nvub, max_up)
                nvlb = torch.maximum(nvlb, max_dn)

            # ---- branch variable: pseudocost product rule (the host
            # 'rel' brancher) on device pc arrays, else the step's
            # most-fractional candidate
            bv_dev = bvar_step
            if use_rel:
                fr = torch.where((res["frac"] > int_tol) &
                                 (nvub - nvlb > 1e-9), res["frac"], 0.0)
                cand_m = fr > 0.0
                obs_u = pc_cu > 0
                obs_d = pc_cd > 0
                avg_u = pc_su / torch.clamp(pc_cu, min=1.0)
                avg_d = pc_sd / torch.clamp(pc_cd, min=1.0)
                mu_u = torch.where(obs_u.any(),
                                   torch.where(obs_u, avg_u, 0.0).sum() /
                                   torch.clamp(obs_u.sum(), min=1), 1.0)
                mu_d = torch.where(obs_d.any(),
                                   torch.where(obs_d, avg_d, 0.0).sum() /
                                   torch.clamp(obs_d.sum(), min=1), 1.0)
                pu = torch.where(obs_u, avg_u, mu_u)[None, :]
                pd = torch.where(obs_d, avg_d, mu_d)[None, :]
                f = xs - torch.floor(xs)
                score = torch.clamp(pd * f, min=1e-8) * \
                    torch.clamp(pu * (1.0 - f), min=1e-8)
                if frac_w > 0:
                    fr2 = torch.minimum(f, 1.0 - f)
                    smax = torch.clamp(torch.where(cand_m, score, -INF).amax(
                        dim=1, keepdim=True), min=1e-12)
                    fmax = torch.clamp(torch.where(cand_m, fr2, -INF).amax(
                        dim=1, keepdim=True), min=1e-12)
                    score = (1.0 - frac_w) * score / smax + \
                        frac_w * fr2 / fmax
                score = torch.where(cand_m, score, -INF)
                j_rel = score.argmax(dim=1)
                multi = cand_m.sum(dim=1) > 1
                bv_dev = torch.where(multi, j_rel, bv_dev)
            bv = torch.clamp(bv_dev, min=0).long()
            bval = xs.gather(1, bv[:, None])[:, 0]
            blo_b = nvlb.gather(1, bv[:, None])[:, 0]
            bhi_b = nvub.gather(1, bv[:, None])[:, 0]
            lo = torch.floor(bval + int_tol)
            lo = torch.maximum(lo, torch.where(torch.isfinite(blo_b),
                                               torch.ceil(blo_b - 1e-9), lo))
            lo = torch.minimum(lo, torch.where(torch.isfinite(bhi_b),
                                               torch.floor(bhi_b + 1e-9) - 1,
                                               lo))
            onehot = iota_n[None, :] == bv[:, None]
            dn_vub = torch.where(onehot, lo[:, None], nvub)
            up_vlb = torch.where(onehot, lo[:, None] + 1.0, nvlb)
            f_dn = torch.clamp(bval - lo, min=0.0)
            f_up = torch.clamp(lo + 1.0 - bval, min=0.0)

            # ---- insert children: flatten (2B) lane-major, route valid
            # children to the first free slots (invalid ones to the
            # scratch row C)
            c_vlb = torch.stack([nvlb, up_vlb], dim=1).reshape(2 * B, n)
            c_vub = torch.stack([dn_vub, nvub], dim=1).reshape(2 * B, n)
            valid = branch.repeat_interleave(2)
            # sort-free free-slot routing: rank free slots by prefix sum
            # and scatter-invert the first 2B ranks (an argsort over C is
            # a full device sort; this is O(C) elementwise + one
            # scatter).  Free slots past rank 2B go to the scratch entry
            # 2B, which is sliced off.
            free_mask = ~used
            frank = free_mask.cumsum(0) - 1
            tgt = torch.where(free_mask & (frank < 2 * B), frank, 2 * B)
            slot_of_rank = torch.full((2 * B + 1,), C, dtype=torch.long,
                                      device=dev)
            slot_of_rank.index_copy_(0, tgt, slot_ids)
            rank = valid.cumsum(0) - 1
            slot = torch.where(valid,
                               slot_of_rank[torch.clamp(rank, 0, 2 * B - 1)],
                               C)
            st[0].index_copy_(0, slot, c_vlb)
            st[1].index_copy_(0, slot, c_vub)
            st[2].index_copy_(0, slot, xs.repeat_interleave(2, dim=0))
            st[3].index_copy_(0, slot, ys.repeat_interleave(2, dim=0))
            st[4].index_copy_(0, slot, node_bound.repeat_interleave(2))
            st[5].index_copy_(0, slot, pdep.repeat_interleave(2) + 1.0)
            st[6].index_copy_(0, slot,
                              bv.to(torch.int32).repeat_interleave(2))
            st[7].index_copy_(0, slot, child_dir)
            st[8].index_copy_(0, slot,
                              torch.stack([f_dn, f_up], dim=1).reshape(2 * B))
            st[9].index_copy_(0, slot,
                              res["iters"].to(F64).repeat_interleave(2))
            st[10].index_fill_(0, slot, True)

            scal[0] = unres_lb
            scal[1:8] += torch.stack([
                unres_new.sum(), act.sum(), 2 * branch.sum(),
                p_bnd.sum() + n_bulk, p_inf.sum(), closed.sum(),
                torch.where(act, res["iters"], 0).sum()]).to(F64)
            # best finite relaxation point ACROSS the call's rounds
            # (host-side rounding heuristics at sync)
            rv = torch.where(act & torch.isfinite(xs).all(dim=1) &
                             (status != _INFEAS), res["obj"], INF)
            bi2 = rv.argmin()
            hbetter = pick(rv, bi2) < hval
            hx = torch.where(hbetter, pick(xs, bi2), hx)
            hval = torch.where(hbetter, pick(rv, bi2), hval)
            return devrisk, hval, hx

        def multiround(A, clb, cub, state, cutoff_host: float):
            """Up to T rounds on `state` (updated in place); returns the
            state and the call's float64 summary: [rounds, pool used,
            pool lb, best_val, devrisk, unres_lb, unres_cnt, processed,
            created, pruned_bound, pruned_infeas, iters], then best_x,
            heur_x, pc_su, pc_cu, pc_sd, pc_cd (n each)."""
            with trace.span("pool.call"):
                used = state[10][:C]
                scal = state[17]
                # per-call counters: the scal block accumulates WITHIN one
                # multiround call and the host adds the deltas at each sync
                scal[0] = INF
                scal[1:] = 0.0
                full = lambda v: torch.full((), v, dtype=F64,  # noqa: E731
                                            device=dev)
                devrisk, hval = full(INF), full(INF)
                hx = torch.zeros(n, dtype=F64, device=dev)
                rounds = 0
                # the loop condition (r < T) & used.any() & (free >= 2B) is
                # read on the host, once a round
                while rounds < T:
                    with trace.span("pool.sync"):
                        go = bool(used.any() & (C - used.sum() >= 2 * B))
                    if not go:
                        break
                    with trace.span("pool.round"):
                        devrisk, hval, hx = one_round(A, clb, cub, cutoff_host,
                                                      state, devrisk, hval, hx)
                    rounds += 1
                lbmin = torch.where(used, state[4][:C], INF).amin()
                summary = torch.cat([
                    torch.stack([
                        full(rounds), used.sum().to(F64), lbmin, state[15],
                        devrisk, scal[0], scal[1], scal[2], scal[3], scal[4],
                        scal[5], scal[7]]),
                    state[16], hx, state[11], state[12], state[13], state[14]])
                return state, summary

        def pack_pool(state):
            (vlb, vub, wx, wy, lb, depth, bvar, bdir, bfrac, pit,
             used) = (t[:C] for t in state[:11])
            cols = [vlb, vub, wx, wy, lb[:, None], depth[:, None],
                    bvar.to(F64)[:, None], bdir.to(F64)[:, None],
                    bfrac[:, None], pit[:, None], used.to(F64)[:, None]]
            return torch.cat(cols, dim=1)

        return multiround, pack_pool

    # ------------------------------------------------------- host driver
    def _init_state(self, nodes: List[Node]) -> list:
        bab = self.bab
        n, m, C = self._n, self._m, self.C
        k = min(len(nodes), C)
        rows = C + 1                        # row C: the scratch row
        vlb = np.zeros((rows, n))
        vub = np.zeros((rows, n))
        wx = np.zeros((rows, n))
        wy = np.zeros((rows, m))
        lb = np.full(rows, _INF)
        depth = np.zeros(rows)
        bvar = np.full(rows, -1, dtype=np.int32)
        bdir = np.zeros(rows, dtype=np.int32)
        bfrac = np.zeros(rows)
        pit = np.zeros(rows)
        used = np.zeros(rows, dtype=bool)
        cold = bab._lane_starts(nodes[:k])
        cold_y = bab._lane_duals(nodes[:k])
        for i, nd in enumerate(nodes[:k]):
            vlb[i] = nd.vlb
            vub[i] = nd.vub
            wx[i] = cold[i]
            wy[i] = cold_y[i]
            lb[i] = nd.lb
            depth[i] = nd.depth
            bvar[i] = nd.branch_var
            bdir[i] = 1 if nd.branch_dir else 0
            bfrac[i] = nd.branch_frac
            pit[i] = float(nd.pred_iters)
            used[i] = True
        pc_su = bab._pc_up * np.maximum(bab._pc_up_cnt, 0)
        pc_cu = bab._pc_up_cnt.astype(np.float64)
        pc_sd = bab._pc_down * np.maximum(bab._pc_down_cnt, 0)
        pc_cd = bab._pc_down_cnt.astype(np.float64)
        scal = np.array([_INF, 0, 0, 0, 0, 0, 0, 0], dtype=np.float64)
        return [torch.as_tensor(a, device=self.device) for a in (
            vlb, vub, wx, wy, lb, depth, bvar, bdir, bfrac, pit, used,
            pc_su, pc_cu, pc_sd, pc_cd, np.float64(_INF), np.zeros(n),
            scal)]

    def _drain_to_host(self, state, keep: int = 0) -> List[Node]:
        """Fetch the pool (ONE transfer) and move all but the best
        `keep` nodes into the host tree.  Returns the kept nodes."""
        bab = self.bab
        n, m = self._n, self._m
        arr = self._pack_pool(state).cpu().numpy()
        o = 0
        vlb = arr[:, o:o + n]; o += n
        vub = arr[:, o:o + n]; o += n
        wx = arr[:, o:o + n]; o += n
        wy = arr[:, o:o + m]; o += m
        lb = arr[:, o]; depth = arr[:, o + 1]
        bvar = arr[:, o + 2].astype(np.int32)
        bdir = arr[:, o + 3].astype(np.int32)
        bfrac = arr[:, o + 4]
        pit = arr[:, o + 5]
        used = arr[:, o + 6] > 0.5
        idx = np.where(used)[0]
        idx = idx[np.argsort(lb[idx])]
        nid0 = max((nd.nid for nd in bab.tm.iter_nodes()), default=0) + 1
        nodes = []
        for rank, i in enumerate(idx):
            nd = Node(nid=nid0 + rank, depth=int(depth[i]),
                      lb=float(lb[i]), vlb=vlb[i].copy(),
                      vub=vub[i].copy(), warm_x=wx[i].copy(),
                      warm_y=wy[i].copy(), branch_var=int(bvar[i]),
                      branch_dir=int(bdir[i]),
                      branch_frac=float(bfrac[i]),
                      pred_iters=int(pit[i]))
            nodes.append(nd)
        kept = nodes[:keep]
        for nd in nodes[keep:]:
            bab.tm.insert_candidate(nd)
        return kept

    def run(self, t0: float) -> None:
        """Main device-resident loop; returns when the search is done or
        a stop/congestion condition hands control back to the host.

        The loop keeps TWO multiround calls in flight (call k+1 is
        issued before summary k is fetched), so the summary's copy to
        the host and the host bookkeeping can overlap device work — the
        same overlap as the host driver's bnb_pipeline.  The cutoff a
        call carries is stale by <=2 syncs, which is sound (cutoffs only
        ever tighten; the in-device candidate cutoff covers fresh
        incumbents immediately)."""
        bab = self.bab
        C, B, T = self.C, self.B, self.T
        A, clb, cub = bab._device_consts()
        # fill the pool with the best nodes (migration, not processing)
        nodes = bab.tm.pop_best_nodes(C // 2)
        if not nodes:
            return
        state = self._init_state(nodes)
        self._t_sync = time.monotonic()
        pend = None
        while True:
            t_d0 = time.monotonic()
            state, summ_dev = self._multiround(A, clb, cub, state,
                                               float(bab._cutoff()))
            info = None
            if pend is not None:
                info = self._process_summary(pend[0].cpu().numpy(), t0,
                                             pend[1])
            pend = (summ_dev, t_d0)
            if info is None:
                continue                    # fill the 2-deep pipeline
            stop = bab._should_stop(t0)
            congested = info["rounds"] < T and \
                C - info["pool_used"] < 2 * B
            if stop is None and info["pool_used"] > 0 and not congested:
                continue
            # terminal-ish condition: flush the in-flight call, re-check
            info = self._process_summary(pend[0].cpu().numpy(), t0,
                                         pend[1])
            pend = None
            stop = bab._should_stop(t0)
            if stop is not None:
                bab.status = stop
                self._drain_to_host(state)
                return
            if info["pool_used"] == 0:
                if len(bab.tm):
                    nodes = bab.tm.pop_best_nodes(C // 2)
                    state = self._init_state(nodes)
                    continue
                return                      # search exhausted
            if info["rounds"] < T and C - info["pool_used"] < 2 * B:
                # congestion: spill the worst half to the host tree and
                # keep diving on the best half
                with trace.span("pool.spill"):
                    kept = self._drain_to_host(state, keep=C // 2)
                    trace.count("spilled", info["pool_used"] - len(kept))
                bab.stats.rebalances += 1
                if not kept:
                    return
                state = self._init_state(kept)

    def _process_summary(self, summ: np.ndarray, t0: float,
                         t_disp: float) -> dict:
        """All host bookkeeping for one multiround summary: stats,
        pseudocost sync, incumbent verification, rounding heuristic,
        global lb, progress log."""
        with trace.span("pool.summary"):
            bab = self.bab
            n = self._n
            bab.stats.t_device += time.monotonic() - t_disp
            t_h0 = time.monotonic()
            (rounds, pool_used, pool_lb, best_val, devrisk, unres_lb,
             unres_cnt, processed, created, pr_bnd, pr_inf,
             iters) = summ[:12]
            best_x = summ[12:12 + n]
            heur_x = summ[12 + n:12 + 2 * n]
            o = 12 + 2 * n
            pc_su = summ[o:o + n]
            pc_cu = summ[o + n:o + 2 * n]
            pc_sd = summ[o + 2 * n:o + 3 * n]
            pc_cd = summ[o + 3 * n:o + 4 * n]
            self.calls += 1
            self.rounds += int(rounds)
            self.processed += int(processed)
            trace.count("processed", int(processed))
            bab.stats.batches += 1
            bab.stats.solves += int(processed)
            bab.stats.ipm_iters += int(iters)
            bab.tm.nodes_processed += int(processed)
            bab.tm.nodes_created += int(created)
            bab.stats.nodes_processed = bab.tm.nodes_processed
            bab.stats.nodes_created = bab.tm.nodes_created
            bab.stats.unresolved += int(unres_cnt)
            bab.unresolved_lb = min(bab.unresolved_lb, float(unres_lb))
            # host pc arrays track the device values (avg = sum/count)
            with np.errstate(invalid="ignore"):
                bab._pc_up = np.where(pc_cu > 0, pc_su /
                                      np.maximum(pc_cu, 1), 0.0)
                bab._pc_down = np.where(pc_cd > 0, pc_sd /
                                        np.maximum(pc_cd, 1), 0.0)
            bab._pc_up_cnt = pc_cu.astype(np.int64)
            bab._pc_down_cnt = pc_cd.astype(np.int64)
            # candidate verification on the TRUE problem (sync boundary)
            if np.isfinite(best_val) and best_val < bab.ub - 1e-12:
                xb = best_x[:bab.problem.n_vars]
                if bab.problem.is_feasible(
                        xb, atol=max(bab._feas_atol, 1e-5),
                        int_tol=bab._int_tol,
                        rtol=max(bab._feas_rtol, 1e-5)):
                    bab._accept_incumbent(
                        xb.copy(), float(bab.problem.eval_objective(xb)))
                else:
                    # cannot happen for staged-1:1 LP/QP models (device
                    # test is 2x stricter); forfeit optimality soundly
                    self._log.info(
                        "device incumbent REJECTED by host verification"
                        " — capping lb at devrisk (sound fallback)")
                    bab.unresolved_lb = min(bab.unresolved_lb,
                                            float(devrisk))
            # host-side rounding on the best relaxation point of the call
            if bab.sp.int_mask.any() and np.all(np.isfinite(heur_x)):
                bab._try_round_incumbent(heur_x, bab.sp.vlb, bab.sp.vub)
            # global lb across pool + host tree + unresolved cap
            open_lb = min(float(pool_lb), bab.tm.best_lb(),
                          bab.unresolved_lb)
            bab.lb = min(open_lb, bab.ub)
            bab.stats.t_host += time.monotonic() - t_h0

            now = time.monotonic()
            if now - self._t_sync >= bab._log_interval:
                self._t_sync = now
                self._log.info(
                    f"  {now - t0:8.1f}s  nodes "
                    f"{bab.stats.nodes_processed:8d} "
                    f"pool {int(pool_used):5d} open {len(bab.tm):6d}  "
                    f"lb {bab.lb:.8g}  ub {bab.ub:.8g}  gap "
                    f"{bab._gap() * 100:.4g}%  [device rounds "
                    f"{int(rounds)}]")
            return dict(rounds=int(rounds), pool_used=int(pool_used))
