"""Which kernel moves an IPM batch's lane statuses.

Solves the batch of chip_smoke's phase 5 (intquad(n): the root box and
B-1 boxes with seeded fixings) at the bench settings (f32 factors, no
refinement, no retry) four times: K1 through its kernel or its plain
version, times K2 through its kernel or its plain version.  For each
route it prints one JSON line with the lanes whose status differs from
the all-plain route, each as (lane, status, plain status, iterations,
plain iterations).  Under f32 factors many lanes sit at the f32 limit,
where a change of rounding order alone can move a lane between OPTIMAL
(1) and ITERATION_LIMIT (4); this tells which kernel's rounding did it.

`--policy f32` solves the same batch as chip_smoke's phase 9a does:
the bench settings with `dtype f32`'s options (the f32 light phase and
f32 tail corrections) and two Gondzio correctors.

Usage: python -m minotaur_tpu_torch.tools.ipm_routes [--n 300] [--lanes 64]
       [--device cuda] [--policy bench|f32]
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


def route_statuses(n: int = 300, lanes: int = 64, device: str = "cuda",
                   policy: str = "bench") -> dict:
    """{route: [(lane, status, plain status, iters, plain iters), ...]}
    for the routes "kernel/kernel", "kernel/plain", "plain/kernel" (K1/K2)
    against "plain/plain"."""
    from minotaur_tpu_torch.engines import ipm
    from minotaur_tpu_torch.engines.staging import stage_problem
    from minotaur_tpu_torch.models.convex_suite2 import intquad
    from minotaur_tpu_torch.ops.spd_inverse import (spd_inverse,
                                                    spd_inverse_plain)
    from minotaur_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain
    sp = stage_problem(intquad(n, 4, 0))
    lo, hi = phase5_boxes(sp, lanes)
    solve = ipm.build_batch_solver(sp, ipm.IPMOptions(**POLICIES[policy]),
                                   device=device)
    k1 = {"kernel": spd_inverse, "plain": spd_inverse_plain}
    k2 = {"kernel": spd_solve, "plain": spd_solve_plain}
    saved = ipm.spd_inverse, ipm.spd_solve
    res = {}
    try:
        for route in ("plain/plain", "kernel/kernel", "kernel/plain",
                      "plain/kernel"):
            a, b = route.split("/")
            ipm.spd_inverse, ipm.spd_solve = k1[a], k2[b]
            res[route] = solve(sp.A, sp.clb, sp.cub, lo, hi)
    finally:
        ipm.spd_inverse, ipm.spd_solve = saved
    base = res.pop("plain/plain")
    return {route: [(int(i), int(r.status[i]), int(base.status[i]),
                     int(r.iters[i]), int(base.iters[i]))
                    for i in np.where(r.status != base.status)[0]]
            for route, r in res.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=300)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--policy", choices=sorted(POLICIES), default="bench")
    args = ap.parse_args(argv)
    for route, lanes in route_statuses(args.n, args.lanes, args.device,
                                       args.policy).items():
        print(json.dumps({"route (K1/K2)": route, "n": args.n,
                          "policy": args.policy,
                          "lanes_differing_from_plain": lanes}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
