"""Which kernel moves an IPM batch's lane statuses or iteration counts.

Solves one batch four times: K1 through its kernel or its plain version,
times K2 through its kernel or its plain version.  For each route it
prints one JSON line with the lanes whose status or iteration count
differs from the all-plain route, each as (lane, status, plain status,
iterations, plain iterations).  Under f32 factors many lanes sit at the
f32 limit, where a change of rounding order alone can move a lane between
OPTIMAL (1) and ITERATION_LIMIT (4); this tells which kernel's rounding
did it.

The batches (`--batch`, chip_smoke's phases):
  phase5  intquad(n): the root box and B-1 boxes with seeded fixings at
          the bench settings (f32 factors, no refinement, no retry);
          `--policy f32` solves it as phase 9a does (the bench settings
          with `dtype f32`'s options, the f32 light phase and f32 tail
          corrections, and two Gondzio correctors);
  nl      phase 7: normcon(1024, 7), the root box and 63 boxes with
          seeded integer fixings, the NL IPM's defaults (f64 factors, K1
          at (64, 1024, 1024) f64, K2 refine 3);
  qg      phase 8: the QG master LP of normcon(1024, 7) after QG's root
          (its linearization cuts) on the same boxes, under the master's
          own options (f32 factors, K2 refine 2);
  glob    phase 10a: one glob step of qknap(100, 0.25, 0) on the root box
          and 63 nodes, under GlobBranchAndBound's mixed policy (K1 at
          (64, 1378, 1378) f32, K2 refine 2); the step reports no
          iteration counts.

Usage: python -m minotaur_tpu_torch.tools.ipm_routes [--batch phase5|nl|qg|glob|all]
       [--n 300] [--lanes 64] [--device cuda] [--policy bench|f32]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def phase5_boxes(sp, lanes: int, seed: int = 7):
    """The root box, then boxes that fix 1-39 random variables each to a
    random value in 0..4 (chip_smoke phase 5's batch)."""
    rng = np.random.default_rng(seed)
    lo = np.tile(sp.vlb, (lanes, 1))
    hi = np.tile(sp.vub, (lanes, 1))
    for b in range(1, lanes):
        pick = rng.choice(sp.n, size=int(rng.integers(1, min(40, sp.n + 1))),
                          replace=False)
        v = rng.integers(0, 5, size=len(pick)).astype(float)
        lo[b, pick] = v
        hi[b, pick] = v
    return lo, hi


BENCH_IPM = dict(max_iters=28, tail_kkt_rounds=4, refine_steps=0,
                 chol_retry=False)
POLICIES = {"bench": BENCH_IPM,
            "f32": dict(BENCH_IPM, light_phase1=True, tail_corr_f32=True,
                        gondzio_correctors=2)}


ROUTES = ("kernel/kernel", "kernel/plain", "plain/kernel")
BATCHES = ("phase5", "nl", "qg", "glob")


def _seeded_fixings(sp, lanes: int, top: int, seed: int = 7):
    """The root box, then boxes that fix 1-39 random variables each to a
    random integer in [0, top) (chip_smoke phase 7's batch)."""
    rng = np.random.default_rng(seed)
    lo = np.tile(sp.vlb, (lanes, 1))
    hi = np.tile(sp.vub, (lanes, 1))
    for b in range(1, lanes):
        pick = rng.choice(sp.n, size=int(rng.integers(1, 40)), replace=False)
        v = rng.integers(0, top, size=len(pick)).astype(float)
        lo[b, pick] = v
        hi[b, pick] = v
    return lo, hi


def _batch(name: str, n: int, lanes: int, device: str, policy: str):
    """run() -> (status, iterations or None) of the named batch under the
    kernels bound in engines/ipm at the time of the call."""
    from minotaur_tpu_torch.engines import ipm
    from minotaur_tpu_torch.engines.staging import stage_problem
    from minotaur_tpu_torch.utils.environment import Environment
    if name == "phase5":
        from minotaur_tpu_torch.models.convex_suite2 import intquad
        sp = stage_problem(intquad(n, 4, 0))
        lo, hi = phase5_boxes(sp, lanes)
        solve = ipm.build_batch_solver(sp, ipm.IPMOptions(**POLICIES[policy]),
                                       device=device)

        def run():
            r = solve(sp.A, sp.clb, sp.cub, lo, hi)
            return r.status, r.iters
        return run
    if name == "nl":
        from minotaur_tpu_torch.models.convex_suite import normcon
        sp = stage_problem(normcon(1024, 7))
        lo, hi = _seeded_fixings(sp, lanes, 4)
        solve = ipm.build_batch_solver(sp, ipm.IPMOptions(), device=device)

        def run():
            r = solve(sp.A, sp.clb, sp.cub, lo, hi)
            return r.status, r.iters
        return run
    env = Environment()
    for key, v in dict(log_level=1, node_batch=lanes).items():
        env.set_option(key, v)
    if name == "qg":
        from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
        from minotaur_tpu_torch.models.convex_suite import normcon
        bab = QGBranchAndBound(normcon(1024, 7), env, device=device)
        bab._qg_root()
        lo, hi = _seeded_fixings(bab.sp_orig, lanes, 4)
        extra = bab.sp.n - bab.sp_orig.n            # the eta column
        lo = np.hstack([lo, np.tile(bab.sp.vlb[-extra:], (lanes, 1))]) \
            if extra else lo
        hi = np.hstack([hi, np.tile(bab.sp.vub[-extra:], (lanes, 1))]) \
            if extra else hi
        solve = ipm.build_batch_solver(bab.sp, bab._step_opts.ipm,
                                       device=device)
        A, clb, cub = (a.copy() for a in bab._master_arrays())

        def run():
            r = solve(A, clb, cub, lo, hi)
            return r.status, r.iters
        return run
    if name == "glob":
        from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
        from minotaur_tpu_torch.models.generators import quadratic_knapsack
        bab = GlobBranchAndBound(quadratic_knapsack(100, 0.25, 0), env,
                                 device=device)
        gs = bab.gs
        rng = np.random.default_rng(21)
        lo, hi = np.tile(gs.vlb, (lanes, 1)), np.tile(gs.vub, (lanes, 1))
        for b in range(1, lanes):        # chip_smoke's glob_boxes
            fix = np.where(rng.uniform(size=gs.n_x) < 0.2)[0]
            lo[b, fix] = hi[b, fix] = rng.integers(0, 2, size=len(fix))
        x0 = np.zeros_like(lo)

        def run():
            return bab._step(lo, hi, x0).status, None
        return run
    raise ValueError(f"unknown batch {name!r}")


def route_statuses(n: int = 300, lanes: int = 64, device: str = "cuda",
                   policy: str = "bench", batch: str = "phase5") -> dict:
    """{route: [(lane, status, plain status, iters, plain iters), ...]}
    for the routes "kernel/kernel", "kernel/plain", "plain/kernel" (K1/K2):
    the lanes whose status or iteration count differs from "plain/plain"
    (iterations None where the batch reports none)."""
    from minotaur_tpu_torch.engines import ipm
    from minotaur_tpu_torch.ops.spd_inverse import (spd_inverse,
                                                    spd_inverse_plain)
    from minotaur_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain

    run = _batch(batch, n, lanes, device, policy)
    k1 = {"kernel": spd_inverse, "plain": spd_inverse_plain}
    k2 = {"kernel": spd_solve, "plain": spd_solve_plain}
    saved = ipm.spd_inverse, ipm.spd_solve
    res = {}
    try:
        for route in ("plain/plain",) + ROUTES:
            a, b = route.split("/")
            ipm.spd_inverse, ipm.spd_solve = k1[a], k2[b]
            res[route] = run()
    finally:
        ipm.spd_inverse, ipm.spd_solve = saved
    st0, it0 = res.pop("plain/plain")
    out = {}
    for route, (st, it) in res.items():
        moved = st != st0 if it is None else (st != st0) | (it != it0)
        out[route] = [(int(i), int(st[i]), int(st0[i]),
                       None if it is None else int(it[i]),
                       None if it0 is None else int(it0[i]))
                      for i in np.where(moved)[0]]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", choices=sorted(POLICIES), default="bench")
    ap.add_argument("--batch", choices=BATCHES + ("all",), default="phase5")
    args = ap.parse_args(argv)
    for batch in BATCHES if args.batch == "all" else (args.batch,):
        for route, lanes in route_statuses(args.n, args.lanes, args.device,
                                           args.policy, batch).items():
            print(json.dumps({"batch": batch, "route (K1/K2)": route,
                              "n": args.n, "policy": args.policy,
                              "lanes_differing_from_plain": lanes}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
