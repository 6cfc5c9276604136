#!/usr/bin/env python3
"""Chip smoke test of minotaur_tpu_torch, the PyTorch/CUDA port.

Runs the port's main path once on one NVIDIA GPU and checks it:

  1. identify the card (nvidia-smi name and power limit, torch, CUDA);
  2. build the CUDA kernels from minotaur_tpu_torch/csrc/;
  3. K1 (spd_inverse) against its plain PyTorch version on the card;
  4. K2 (spd_solve) against its plain PyTorch version on the card;
  5. the batched IPM through the kernels against the IPM through the
     plain versions, on intquad(300): the root box plus 63 seeded boxes,
     under the f64 policy and the bench's mixed settings;
  6. the main path: BranchAndBound(..., device="cuda") on cknap_30a and
     intquad(24) (against their exact oracles), then intquad(300) at the
     bench settings (B=64 lanes), with the kernels' launch counts.

Every phase prints one line; any failed check raises and the process
exits non-zero without the final line.  The next-to-last line is the
kernels' JSON record, the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Usage: python3 chip_smoke.py            (all phases, one card)
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"


class CheckFailed(AssertionError):
    pass


def check(cond, what):
    if not cond:
        raise CheckFailed(what)


def say(msg):
    print(msg, flush=True)


def median_ms(fn, reps=20, warmup=3):
    """Median of `reps` timings of fn() with CUDA events (after warm-up)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def spd_batch(rng, B, k, scale=2.0):
    import numpy as np
    A = rng.standard_normal((B, k, k))
    return np.einsum("bij,bkj->bik", A, A) / k + np.eye(k)[None] * scale


# ------------------------------------------------------------------ phases
def phase_identify():
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    first = smi.stdout.strip().splitlines()[0]
    say(first)
    say(f"[1] card: {torch.cuda.get_device_name(0)}  count "
        f"{torch.cuda.device_count()}  torch {torch.__version__}  CUDA "
        f"{torch.version.cuda}  python {sys.version.split()[0]}")
    return first


def phase_build():
    from minotaur_tpu_torch.ops import _build
    t0 = time.monotonic()
    path = _build.build()
    _build.load_library()
    say(f"[2] built {os.path.relpath(path, HERE)} in "
        f"{time.monotonic() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")


def phase_k1(record):
    import numpy as np
    import torch
    from minotaur_tpu_torch.ops.spd_inverse import (spd_inverse,
                                                    spd_inverse_plain)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = [(3, 50, torch.float32), (4, 130, torch.float32),
             (2, 300, torch.float32), (5, 1, torch.float32),
             (64, 300, torch.float32), (64, 300, torch.float64)]
    worst = {}
    for B, k, dt in cases:
        M = spd_batch(rng, B, k)
        if B >= 4:
            M[1] -= 6.0 * np.eye(k)             # one indefinite lane
        ms = torch.as_tensor(M, dtype=dt, device=dev)
        minv, flag = spd_inverse(ms)
        pminv, pflag = spd_inverse_plain(ms)
        torch.cuda.synchronize()
        check(torch.equal(flag, pflag), f"K1 flags differ at {(B, k, dt)}")
        ok = flag == 0
        resid = (torch.eye(k, device=dev, dtype=torch.float64) -
                 ms.double()[ok] @ minv.double()[ok]).abs().max().item()
        err = (minv - pminv).abs().max().item()
        scale = pminv.abs().max().item()
        tol = 5e-5 if dt == torch.float32 else 1e-11
        check(resid < tol, f"K1 residual {resid:.3g} at {(B, k, dt)}")
        check(err <= tol * scale, f"K1 vs plain {err:.3g} at {(B, k, dt)}")
        if B >= 4:
            check(flag[1].item() == 2.0 and torch.equal(
                minv[1], torch.eye(k, dtype=dt, device=dev)),
                "K1 indefinite lane not flagged")
        worst[(B, k, str(dt))] = (err, resid)
    # the spec's ill-conditioned Jacobi-scaled case
    k = 200
    M = spd_batch(rng, 2, k, 1.0)
    M[0] += np.diag(10.0 ** rng.uniform(-6, 6, size=k))
    d = np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    ms = torch.as_tensor(M / d[:, :, None] / d[:, None, :],
                         dtype=torch.float32, device=dev)
    minv, flag = spd_inverse(ms)
    resid = (torch.eye(k, device=dev, dtype=torch.float64) -
             ms.double() @ minv.double()).abs().max().item()
    check(bool((flag == 0).all()) and resid < 1e-2,
          f"K1 ill-conditioned residual {resid:.3g}")
    # times at the bench shape (f32 main path, and the f64 instantiation)
    times = {}
    for dt in (torch.float32, torch.float64):
        ms = torch.as_tensor(spd_batch(rng, 64, 300), dtype=dt, device=dev)
        times[dt] = (median_ms(lambda: spd_inverse(ms)),
                     median_ms(lambda: spd_inverse_plain(ms)))
    e32 = worst[(64, 300, str(torch.float32))][0]
    say(f"[3] K1 spd_inverse ok: max|kernel-plain| (64,300,300) f32 "
        f"{e32:.3g}, f64 {worst[(64, 300, str(torch.float64))][0]:.3g}; "
        f"ill-cond resid {resid:.3g}; median ms f32 kernel "
        f"{times[torch.float32][0]:.4f} plain {times[torch.float32][1]:.4f}"
        f"; f64 kernel {times[torch.float64][0]:.4f} plain "
        f"{times[torch.float64][1]:.4f}")
    record["spd_inverse"] = dict(
        max_abs_err=e32, ms=times[torch.float32][0],
        plain_ms=times[torch.float32][1], f64_ms=times[torch.float64][0],
        f64_plain_ms=times[torch.float64][1])


def phase_k2(record):
    import numpy as np
    import torch
    from minotaur_tpu_torch.ops.spd_inverse import spd_inverse
    from minotaur_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    B, k = 64, 300
    M = spd_batch(rng, B, k) * 50.0
    d = np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    dinv = 1.0 / d
    Ms = torch.as_tensor(M * dinv[:, :, None] * dinv[:, None, :],
                         dtype=torch.float32, device=dev)
    minv32, _ = spd_inverse(Ms)
    minv64, _ = spd_inverse(Ms.double())
    shift = rng.uniform(0, 1e-3, size=(B, k))
    worst = 0.0
    main_err = None
    for fdt, mdt in ((torch.float32, torch.float32),
                     (torch.float32, torch.float64),
                     (torch.float64, torch.float64)):
        minv = minv32 if fdt == torch.float32 else minv64
        mop = torch.as_tensor(M, dtype=mdt, device=dev)
        dv = torch.as_tensor(dinv, dtype=mdt, device=dev)
        sh = torch.as_tensor(shift, dtype=mdt, device=dev)
        for steps in (0, 2):
            for R in (1, 8):
                r = torch.as_tensor(rng.standard_normal((B, k, R)),
                                    dtype=mdt, device=dev)
                if R == 1:
                    r = r[:, :, 0]
                x = spd_solve(minv, mop, dv, sh, r, steps)
                px = spd_solve_plain(minv, mop, dv, sh, r, steps)
                torch.cuda.synchronize()
                err = (x - px).abs().max().item()
                tol = 1e-5 if fdt == torch.float32 else 1e-11
                check(err <= tol * px.abs().max().item(),
                      f"K2 vs plain {err:.3g} at {(fdt, mdt, steps, R)}")
                rr = r if R > 1 else r[:, :, None]
                xx = x.double() if R > 1 else x.double()[:, :, None]
                res = (rr.double() - (mop.double() @ xx + sh.double()[:, :, None] * xx)
                       ).norm() / rr.double().norm()
                check(res.item() < (1e-5 if steps else 1e-4),
                      f"K2 residual {res.item():.3g} at {(fdt, mdt, steps, R)}")
                worst = max(worst, err)
                if (fdt, mdt, steps, R) == (torch.float32, torch.float32, 0, 1):
                    main_err = err
    mop = torch.as_tensor(M, dtype=torch.float32, device=dev)
    dv = torch.as_tensor(dinv, dtype=torch.float32, device=dev)
    sh = torch.zeros((B, k), dtype=torch.float32, device=dev)
    r = torch.as_tensor(rng.standard_normal((B, k)), dtype=torch.float32,
                        device=dev)
    t_k = median_ms(lambda: spd_solve(minv32, mop, dv, sh, r, 0))
    t_p = median_ms(lambda: spd_solve_plain(minv32, mop, dv, sh, r, 0))
    t_k2 = median_ms(lambda: spd_solve(minv32, mop, dv, sh, r, 2))
    t_p2 = median_ms(lambda: spd_solve_plain(minv32, mop, dv, sh, r, 2))
    say(f"[4] K2 spd_solve ok: max|kernel-plain| {worst:.3g} over "
        f"refine {{0,2}} x R {{1,8}} x 3 dtype pairs; median ms (64,300) "
        f"f32 refine 0: kernel {t_k:.4f} plain {t_p:.4f}; refine 2: kernel "
        f"{t_k2:.4f} plain {t_p2:.4f}")
    record["spd_solve"] = dict(max_abs_err=main_err, ms=t_k, plain_ms=t_p,
                               refine2_ms=t_k2, refine2_plain_ms=t_p2)


def phase_ipm(record):
    import numpy as np
    from minotaur_tpu_torch.engines.ipm import IPMOptions, build_batch_solver
    from minotaur_tpu_torch.engines.staging import stage_problem
    from minotaur_tpu_torch.models.convex_suite2 import intquad
    from minotaur_tpu_torch.tools.profile_bnb import plain_kernels
    sp = stage_problem(intquad(300, 4, 0))
    rng = np.random.default_rng(7)
    B = 64
    lo = np.tile(sp.vlb, (B, 1))
    hi = np.tile(sp.vub, (B, 1))
    for b in range(1, B):
        pick = rng.choice(sp.n, size=int(rng.integers(1, 40)), replace=False)
        v = rng.integers(0, 5, size=len(pick)).astype(float)
        lo[b, pick] = v
        hi[b, pick] = v
    lines = []
    # the f64 policy, and the mixed policy at the bench's settings (what
    # phase 6 runs)
    for label, kw in (("f64", dict(factor_f32=False, tail_factor_f32=False)),
                      ("bench", dict(max_iters=28, tail_kkt_rounds=4,
                                     refine_steps=0, chol_retry=False))):
        solve = build_batch_solver(sp, IPMOptions(**kw), device=DEVICE)
        t0 = time.monotonic()
        rk = solve(sp.A, sp.clb, sp.cub, lo, hi)
        t_k = time.monotonic() - t0
        with plain_kernels():
            t0 = time.monotonic()
            rp = solve(sp.A, sp.clb, sp.cub, lo, hi)
            t_p = time.monotonic() - t0
        for r in (rk, rp):
            check(np.all(np.isfinite(r.x)) and r.x.shape == (B, sp.n),
                  "IPM returned non-finite x")
        scale = 1.0 + np.abs(rp.obj)
        same = rk.status == rp.status
        opt_k, opt_p = rk.status == 1, rp.status == 1
        check(bool(same.all()), f"IPM ({label}): statuses differ on lanes "
              f"{np.where(~same)[0].tolist()}")
        rel = np.where(opt_k, np.abs(rk.obj - rp.obj) / scale, 0.0)
        obj_tol = 1e-6 if label == "f64" else 10 * IPMOptions(**kw).tail_tol
        check(rel.max() <= obj_tol,
              f"IPM ({label}): objective mismatch {rel.max():.3g}")
        # each run's certified bound lies below the other run's optimum
        for r, o in ((rk, rp), (rp, rk)):
            lim = o.obj + obj_tol * (1.0 + np.abs(o.obj))
            bad = np.where((o.status == 1) & (r.dual_bound > lim))[0]
            check(bad.size == 0, f"IPM ({label}): certified bound above the "
                  f"other run's optimum on lanes {bad.tolist()}")
        lines.append(
            f"{label}: statuses equal {int(same.sum())}/{B}, optimal "
            f"{int(opt_k.sum())}/{int(opt_p.sum())}, max|dobj|/(1+|obj|) "
            f"over optimal lanes {rel.max():.3g}, iters "
            f"{int(rk.iters.max())}/{int(rp.iters.max())}, wall s kernel "
            f"{t_k:.2f} plain {t_p:.2f}")
    say("[5] IPM intquad(300) B=64 kernel vs plain ok: " + "; ".join(lines))


def phase_main_path(record):
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.bnb.bnb import BranchAndBound
    from minotaur_tpu_torch.models.convex_suite2 import (intquad,
                                                          intquad_optimum)
    from minotaur_tpu_torch.models.generators import (correlated_knapsack,
                                                      knapsack_dp_optimum)
    from minotaur_tpu_torch.utils.environment import Environment
    from minotaur_tpu_torch.utils.types import SolveStatus

    for name, prob, opt in (
            ("cknap_30a", correlated_knapsack(30, 1), knapsack_dp_optimum(30, 1)),
            ("intquad_24", intquad(24, 4, 0), intquad_optimum(24, 4, 0))):
        env = Environment()
        env.set_option("log_level", 1)
        t0 = time.monotonic()
        bab = BranchAndBound(prob, env, device=DEVICE)
        st = bab.solve()
        dt = time.monotonic() - t0
        check(st == SolveStatus.SOLVED_OPTIMAL, f"{name}: status {st.name}")
        check(abs(bab.ub - opt) <= 1e-6 * (1 + abs(opt)),
              f"{name}: ub {bab.ub} vs oracle {opt}")
        say(f"[6] {name}: SOLVED_OPTIMAL ub {bab.ub:.10g} oracle {opt:.10g} "
            f"nodes {bab.stats.nodes_processed} in {dt:.2f} s")

    # intquad(300) at the bench settings (bench.py:78-95)
    env = Environment()
    for k, v in (("node_batch", 64), ("pad_full", 1), ("ipm_max_iters", 28),
                 ("ipm_tail_kkt_rounds", 4), ("ipm_refine_steps", 0),
                 ("ipm_chol_retry", 0), ("bnb_node_limit", 8192),
                 ("bnb_time_limit", 180.0), ("log_level", 1)):
        env.set_option(k, v)
    opt = intquad_optimum(300, 4, 0)
    bab = BranchAndBound(intquad(300, 4, 0), env, device=DEVICE)
    mdev.reset_launches()
    t0 = time.monotonic()
    st = bab.solve()
    dt = time.monotonic() - t0
    counts = mdev.launch_counts()
    tol = 1e-6 * (1 + abs(opt))
    check(bab.lb <= opt + tol <= bab.ub + 2 * tol,
          f"intquad_300 unsound: lb {bab.lb} opt {opt} ub {bab.ub}")
    nodes = max(1, bab.stats.nodes_processed)
    facts = bab.stats.ipm_iters
    dirs = 3 + 1 + int(env.options.get("ipm_tail_kkt_rounds"))
    say(f"[6] intquad_300 B=64: status {st.name} lb {bab.lb:.10g} opt "
        f"{opt:.10g} ub {bab.ub:.10g}; nodes {nodes} in {dt:.2f} s = "
        f"{nodes / dt:.2f} nodes/s; IPM iterations {facts}; KKT "
        f"factorizations/s {facts / dt:.1f}; direction solves/s "
        f"{facts * dirs / dt:.1f}; dispatch-to-fetch s "
        f"{bab.stats.t_device:.2f} (sum of overlapping windows of pipelined "
        f"supersteps, not device busy time); host bookkeeping s "
        f"{bab.stats.t_host:.2f}; launches in this solve "
        f"{{{', '.join(f'{k}: {v}' for k, v in counts.items())}}}")
    for name, cnt in counts.items():
        check(cnt > 0, f"kernel {name} was not launched by the main path")
    record["launches"] = counts


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "minotaur_tpu_torch")):
        print("chip_smoke: minotaur_tpu_torch not found next to this "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    record = {}
    phase_identify()
    phase_build()
    phase_k1(record)
    phase_k2(record)
    phase_ipm(record)
    phase_main_path(record)
    launches = record["launches"]
    kernels = []
    for name, src, rep in (
            ("spd_inverse", "minotaur_tpu_torch/csrc/spd_inverse.cu",
             "minotaur_tpu/ops/pallas_kkt.py:204"),
            ("spd_solve", "minotaur_tpu_torch/csrc/spd_solve.cu",
             "minotaur_tpu/ops/pallas_kernels.py:76")):
        r = record[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": int(launches[name]),
                        "max_abs_err": float(r["max_abs_err"]),
                        "ms": float(r["ms"]), "plain_ms": float(r["plain_ms"])})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
