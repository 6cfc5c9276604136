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


def event_ms(fn, calls=20, reps=5, warmup=3):
    """Milliseconds per call of fn(): CUDA events around `calls`
    back-to-back calls, divided by `calls`, after warm-up; the median of
    `reps` such windows."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


# The card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W): HBM bytes/s
# and the operation rate the bounds use for f32 (CUDA cores) and f64 (the
# FP64 tensor-core rate, the card's highest for that type).
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {4: 67e12, 8: 67e12}


def bound(flops, nbytes, itemsize):
    """(bound_ms, bound_by): the larger of operations over the peak rate
    for the type and bytes over the memory rate."""
    t_ops = flops / PEAK_FLOPS[itemsize]
    t_bytes = nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                        else "bytes")


def k1_bound(B, k, itemsize):
    """K1: potrf + trtri + lauum, k^3/3 flops each per lane; one read of
    the lower triangle of ms (all the function needs) and one write of
    Minv."""
    return bound(B * k ** 3, B * (k * (k + 1) // 2 + k * k) * itemsize,
                 itemsize)


def k2_bound(B, k, itemsize):
    """K2 at refine 0: one product with Minv (2 k^2 flops per lane); reads
    Minv, dinv and r once and writes x (shift and M are not read)."""
    return bound(2 * B * k * k, (B * k * k + 3 * B * k) * itemsize, itemsize)


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


def spoil(M, defect):
    """Make lane 0 of M fail: "shift" (-6 I, at column 0), "late" (the
    pivot of column 2*32+5, or of the last column, driven to -0.5, so the
    failure comes after two panels of updates), "nan" (one NaN pair)."""
    import numpy as np
    k = M.shape[-1]
    if defect == "shift":
        M[0] -= 6.0 * np.eye(k)
    elif defect == "late":
        j = min(2 * 32 + 5, k - 1)
        s = M[0, j, :j] @ np.linalg.solve(M[0, :j, :j], M[0, :j, j]) if j else 0.0
        M[0, j, j] = s - 0.5
    elif defect == "nan":
        M[0, k // 2, k // 3] = M[0, k // 3, k // 2] = np.nan
    return M


def phase_k1(record):
    import numpy as np
    import torch
    from minotaur_tpu_torch.ops.spd_inverse import (spd_inverse,
                                                    spd_inverse_plain)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # ragged k (not a multiple of the panel width 32), B=1, failures at
    # column 0, in a later panel and from a NaN, the bench shape, and
    # k=900, whose f64 panel does not fit shared memory
    cases = [(3, 50, "shift"), (4, 130, "shift"), (2, 300, "shift"),
             (5, 1, "none"), (3, 31, "nan"), (3, 33, "late"),
             (4, 65, "late"), (4, 129, "nan"), (4, 301, "late"),
             (1, 300, "none"), (1, 1, "nan"), (2, 900, "late"),
             (64, 300, "shift")]
    worst = {}
    for B, k, defect in cases:
        base = spoil(spd_batch(rng, B, k), defect)
        for dt in (torch.float32, torch.float64):
            ms = torch.as_tensor(base, dtype=dt, device=dev)
            minv, flag = spd_inverse(ms)
            pminv, pflag = spd_inverse_plain(ms)
            torch.cuda.synchronize()
            what = (B, k, defect, str(dt))
            check(torch.equal(flag, pflag), f"K1 flags differ at {what}")
            check(flag[0].item() == (0.0 if defect == "none" else 2.0),
                  f"K1 lane 0 flag {flag[0].item()} at {what}")
            ok = flag == 0
            tol = 5e-5 if dt == torch.float32 else 1e-11
            resid = (torch.eye(k, device=dev, dtype=torch.float64) -
                     ms.double()[ok] @ minv.double()[ok]).abs().max().item() \
                if bool(ok.any()) else 0.0
            err = (minv - pminv).abs().max().item()
            scale = pminv.abs().max().item()
            check(resid < tol, f"K1 residual {resid:.3g} at {what}")
            check(err <= tol * scale, f"K1 vs plain {err:.3g} at {what}")
            if defect != "none":
                check(torch.equal(minv[0], torch.eye(k, dtype=dt, device=dev)),
                      f"K1 failed lane is not the identity at {what}")
            worst[(B, k, str(dt))] = err
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
    # times at the bench shape (f32 main path, and the f64 instantiation):
    # the kernel, its plain version, and torch.linalg.inv_ex (the one
    # PyTorch call computing the same inverse; the port never calls it)
    B, k = 64, 300
    times = {}
    for dt in (torch.float32, torch.float64):
        ms = torch.as_tensor(spd_batch(rng, B, k), dtype=dt, device=dev)
        times[dt] = dict(
            ms=event_ms(lambda: spd_inverse(ms)),
            plain_ms=event_ms(lambda: spd_inverse_plain(ms)),
            library_ms=event_ms(lambda: torch.linalg.inv_ex(ms)))
        times[dt]["bound_ms"], times[dt]["bound_by"] = k1_bound(
            B, k, ms.element_size())
    t32, t64 = times[torch.float32], times[torch.float64]
    say(f"[3] K1 spd_inverse ok on {len(cases)} cases x f32/f64 (flags equal "
        f"to plain, incl. ragged k, late-panel and NaN failures): "
        f"max|kernel-plain| (64,300,300) f32 "
        f"{worst[(64, 300, str(torch.float32))]:.3g}, f64 "
        f"{worst[(64, 300, str(torch.float64))]:.3g}; ill-cond resid "
        f"{resid:.3g}; ms per call (20 back-to-back, median of 5) f32 kernel "
        f"{t32['ms']:.4f} plain {t32['plain_ms']:.4f} inv_ex "
        f"{t32['library_ms']:.4f} bound {t32['bound_ms']:.4f} "
        f"({t32['bound_by']}); f64 kernel {t64['ms']:.4f} plain "
        f"{t64['plain_ms']:.4f} inv_ex {t64['library_ms']:.4f} bound "
        f"{t64['bound_ms']:.4f} ({t64['bound_by']})")
    record["spd_inverse"] = dict(
        max_abs_err=worst[(64, 300, str(torch.float32))], **t32,
        **{"f64_" + key: v for key, v in t64.items() if key != "bound_by"})


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
    t_k = event_ms(lambda: spd_solve(minv32, mop, dv, sh, r, 0))
    t_p = event_ms(lambda: spd_solve_plain(minv32, mop, dv, sh, r, 0))
    t_k2 = event_ms(lambda: spd_solve(minv32, mop, dv, sh, r, 2))
    t_p2 = event_ms(lambda: spd_solve_plain(minv32, mop, dv, sh, r, 2))
    b_ms, b_by = k2_bound(B, k, minv32.element_size())
    say(f"[4] K2 spd_solve ok: max|kernel-plain| {worst:.3g} over "
        f"refine {{0,2}} x R {{1,8}} x 3 dtype pairs; ms per call (64,300) "
        f"f32 refine 0: kernel {t_k:.4f} plain {t_p:.4f} bound {b_ms:.4f} "
        f"({b_by}); refine 2: kernel {t_k2:.4f} plain {t_p2:.4f}")
    # no single PyTorch call computes the scaled, refined solve
    record["spd_solve"] = dict(max_abs_err=main_err, ms=t_k, plain_ms=t_p,
                               bound_ms=b_ms, bound_by=b_by, library_ms=None,
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
        r = dict(record[name])
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": int(launches[name])}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            row[key] = r.pop(key)
        row.update(r)                   # the f64 and refine-2 extras
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
