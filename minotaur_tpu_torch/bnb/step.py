"""The B&B node superstep: FBBT -> IPM solve -> integrality analysis.

Port of minotaur_tpu/bnb/step.py.  One call processes
a whole batch of nodes, with the lane axis written out, and packs every
output into ONE (B, 4n+m+10) float64 tensor whose column layout is
bit-identical to the JAX package's `pack_step_result`, so the host loop
reads both packages the same way.

Spans (utils/trace.py): `step` around each `step_b` call,
`step.fbbt` around its FBBT rounds, `step.fetch` around the one copy of
the packed result to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import F64, resolve_device
from ..engines.ipm import IPMOptions, build_single_solver, to_device
from ..engines.staging import StagedProblem
from ..ops.interval import linear_fbbt, stage_fbbt, stage_interval
from ..utils import trace
from ..utils.types import EngineStatus


class StepResult(NamedTuple):
    status: "np.ndarray"        # (B,) EngineStatus
    obj: "np.ndarray"           # (B,) relaxation objective
    dual_bound: "np.ndarray"    # (B,) certified node lower bound
    x: "np.ndarray"             # (B, n)
    int_feasible: "np.ndarray"  # (B,) bool: all int vars integral
    branch_var: "np.ndarray"    # (B,) most-fractional int var (-1 if none)
    branch_val: "np.ndarray"    # (B,) value of x at branch_var
    max_frac: "np.ndarray"      # (B,)
    new_vlb: "np.ndarray"       # (B, n) FBBT-tightened bounds
    new_vub: "np.ndarray"       # (B, n)
    fbbt_infeas: "np.ndarray"   # (B,) bool
    frac: "np.ndarray"          # (B, n) fractionality per var (0 for cont)
    y: "np.ndarray"             # (B, m) row duals
    kkt_err: "np.ndarray"       # (B,) engine KKT error
    iters: "np.ndarray"         # (B,) engine iterations


@dataclasses.dataclass(frozen=True)
class StepOptions:
    int_tol: float = 1e-6
    fbbt_rounds: int = 2
    ipm: IPMOptions = IPMOptions()


def build_fbbt_sweep(sp: StagedProblem, int_tol: float = 1e-6,
                     device="cuda") -> Callable:
    """Returns the batched sweep fbbt_round(A, clb, cub, vlb, vub, infeas)
    -> (vlb, vub, infeas) on (B, n) boxes: one vectorized linear-row pass
    + per-graph interval projection + integer rounding.  Used by the node
    superstep and the root Presolver.  Each graph's rules run as torch
    ops on all lanes at once, node by node (the JAX package traces them
    once into one fused program)."""
    n = sp.n
    dev = resolve_device(device)
    int_mask = torch.as_tensor(sp.int_mask, dtype=torch.bool, device=dev)
    has_ints = bool(sp.int_mask.any())

    # staged FBBT for nonlinear rows (quadratic rows have graphs too)
    nl_fbbt = [stage_fbbt(g, n) for g in sp.nl_graphs]
    nl_fwd = [stage_interval(g) for g in sp.nl_graphs]
    nl_rows = [int(r) for r in sp.nl_rows]
    rows_t = torch.as_tensor(nl_rows, dtype=torch.long, device=dev)

    def fbbt_round(A, clb, cub, vlb, vub, infeas):
        B = vlb.shape[0]
        # forward intervals of nonlinear bodies -> tightened linear ranges
        if nl_rows:
            fwd = [f(vlb, vub) for f in nl_fwd]
            gmin = torch.stack([g[0] for g in fwd], dim=1)
            gmax = torch.stack([g[1] for g in fwd], dim=1)
            rlo = clb.expand(B, -1).index_add(1, rows_t, -gmax)
            rhi = cub.expand(B, -1).index_add(1, rows_t, -gmin)
            rlo = torch.where(torch.isnan(rlo), -float("inf"), rlo)
            rhi = torch.where(torch.isnan(rhi), float("inf"), rhi)
        else:
            rlo, rhi = clb, cub
        vlb, vub, bad = linear_fbbt(A, rlo, rhi, vlb, vub)
        infeas = infeas | bad

        # nonlinear rows: impose [clb - linpart, cub - linpart] on the DAG
        if nl_rows:
            pos = torch.clamp(A, min=0.0)
            neg = torch.clamp(A, max=0.0)
            lmin = vlb @ pos.T + vub @ neg.T
            lmax = vub @ pos.T + vlb @ neg.T
            for f, r in zip(nl_fbbt, nl_rows):
                glo = clb[r] - lmax[:, r]
                ghi = cub[r] - lmin[:, r]
                glo = torch.where(torch.isnan(glo), -float("inf"), glo)
                ghi = torch.where(torch.isnan(ghi), float("inf"), ghi)
                vlb, vub, bad = f(vlb, vub, glo, ghi)
                infeas = infeas | bad
        # integer rounding (reference: LinearHandler intRounding :415)
        if has_ints:
            vlb = torch.where(int_mask, torch.ceil(vlb - int_tol), vlb)
            vub = torch.where(int_mask, torch.floor(vub + int_tol), vub)
            infeas = infeas | (vlb > vub + 1e-9).any(dim=1)
        return vlb, vub, infeas

    return fbbt_round


def build_node_step_unjitted(sp: StagedProblem,
                             opts: StepOptions = StepOptions(),
                             device="cuda") -> Callable:
    """Returns step_b(A, clb, cub, vlb, vub, x0, y0=None) -> dict of
    (B, .) tensors with the StepResult fields."""
    dev = resolve_device(device)
    n = sp.n
    solve = build_single_solver(sp, opts.ipm, dev)
    int_mask = torch.as_tensor(sp.int_mask, dtype=torch.bool, device=dev)
    has_ints = bool(sp.int_mask.any())
    fbbt_round = build_fbbt_sweep(sp, opts.int_tol, dev)

    def step_b(A, clb, cub, vlb, vub, x0, y0=None):
        with trace.span("step"):
            B = vlb.shape[0]
            infeas = torch.zeros(B, dtype=torch.bool, device=dev)
            with trace.span("step.fbbt"):
                for _ in range(opts.fbbt_rounds):
                    vlb, vub, infeas = fbbt_round(A, clb, cub, vlb, vub,
                                                  infeas)
            # keep the box sane for the solver even if infeasible (masked
            # later)
            svlb = torch.where(vlb > vub, vub, vlb)
            res = solve(A, clb, cub, svlb, vub, x0, y0)

            if has_ints:
                frac = torch.where(int_mask,
                                   (res.x - torch.round(res.x)).abs(), 0.0)
                max_frac = frac.amax(dim=1)
                bvar = frac.argmax(dim=1)
                int_feas = max_frac <= opts.int_tol
                bvar = torch.where(int_feas, -1, bvar)
            else:
                frac = torch.zeros((B, n), dtype=F64, device=dev)
                max_frac = torch.zeros(B, dtype=F64, device=dev)
                bvar = torch.full((B,), -1, dtype=torch.long, device=dev)
                int_feas = torch.ones(B, dtype=torch.bool, device=dev)

            status = torch.where(infeas,
                                 int(EngineStatus.SOLVED_INFEASIBLE),
                                 res.status)
            db = torch.where(infeas, 1e20, res.dual_bound)
            bval = torch.gather(res.x, 1,
                                torch.clamp(bvar, min=0)[:, None])[:, 0]
            return dict(
                status=status, obj=res.obj, dual_bound=db, x=res.x,
                int_feasible=int_feas & ~infeas, branch_var=bvar,
                branch_val=bval, max_frac=max_frac, new_vlb=vlb,
                new_vub=vub, fbbt_infeas=infeas, frac=frac, y=res.y,
                kkt_err=res.kkt_err, iters=res.iters)

    return step_b


def pack_step_result(res: dict) -> torch.Tensor:
    """Flatten a batched step result into ONE (B, 4n+m+10) float64 tensor
    (the JAX package's column layout)."""
    scalars = [res["status"], res["obj"], res["dual_bound"],
               res["int_feasible"], res["branch_var"], res["branch_val"],
               res["max_frac"], res["fbbt_infeas"], res["kkt_err"],
               res["iters"]]
    cols = [torch.stack([s.to(F64) for s in scalars], dim=1),
            res["x"], res["new_vlb"], res["new_vub"], res["frac"], res["y"]]
    return torch.cat(cols, dim=1)


def unpack_step_result(arr: np.ndarray, n: int, m: int) -> StepResult:
    """Host-side inverse of pack_step_result (numpy views, zero copy)."""
    s = arr[:, :10]
    o = 10
    x = arr[:, o:o + n]; o += n
    nvlb = arr[:, o:o + n]; o += n
    nvub = arr[:, o:o + n]; o += n
    frac = arr[:, o:o + n]; o += n
    y = arr[:, o:o + m]; o += m
    return StepResult(
        status=s[:, 0].astype(np.int32), obj=s[:, 1], dual_bound=s[:, 2],
        x=x, int_feasible=s[:, 3] > 0.5,
        branch_var=s[:, 4].astype(np.int32), branch_val=s[:, 5],
        max_frac=s[:, 6], new_vlb=nvlb, new_vub=nvub,
        fbbt_infeas=s[:, 7] > 0.5, frac=frac, y=y, kkt_err=s[:, 8],
        iters=s[:, 9].astype(np.int32))


def build_node_step(sp: StagedProblem, opts: StepOptions = StepOptions(),
                    device="cuda") -> Callable:
    """Returns step(A, clb, cub, vlb_b, vub_b, x0_b, y0_b) -> StepResult
    with host (numpy) leaves.  `step.dispatch` enqueues the superstep on
    the current CUDA stream and returns the packed device tensor;
    `step.unpack` makes the one device-to-host copy.  (The IPM's loop
    reads its per-lane convergence mask on the host every iteration, so
    dispatch does not yet return before the work is done.)"""
    dev = resolve_device(device)
    n, m = sp.n, sp.m
    step_b = build_node_step_unjitted(sp, opts, dev)

    def dispatch(A, clb, cub, vlb_b, vub_b, x0_b, y0_b):
        res = step_b(to_device(A, dev).reshape(m, n), to_device(clb, dev),
                     to_device(cub, dev), to_device(vlb_b, dev),
                     to_device(vub_b, dev), to_device(x0_b, dev),
                     to_device(y0_b, dev).reshape(len(vlb_b), m))
        return pack_step_result(res)

    def unpack(packed) -> StepResult:
        with trace.span("step.fetch"):
            arr = packed.cpu().numpy()
        return unpack_step_result(arr, n, m)

    def step(A, clb, cub, vlb_b, vub_b, x0_b, y0_b):
        return unpack(dispatch(A, clb, cub, vlb_b, vub_b, x0_b, y0_b))

    step.dispatch = dispatch
    step.unpack = unpack
    step.device = dev
    return step
