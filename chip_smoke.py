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
     bench settings (B=64 lanes), with the kernels' launch counts;
  7. the NL path: K1 and K2 at the NL shapes (64, 1024[, 1024]) in f64
     against their plain versions; the batched NL IPM on normcon(1024, 7)
     through the kernels against the plain versions (root box plus 63
     seeded boxes), with the times of the Jacobian, the Hessian and one
     NL FBBT round; BranchAndBound on four NL suite rows against their
     oracles; the full-width normcon(1024, 7) search at B=64 (capped),
     with the kernels' launch counts; and the `mbnb` CLI on a .nl file
     written by the port's nl_writer;
  8. the QG/OA path: QGBranchAndBound on st_e14a and st_e14b and
     OABranchAndBound on st_e14a against their oracles (the CPU root
     anchor must not run); K1 in f32 at the QG master's shape
     (64, 1024, 1024) and K2 at (64, 1024) with the master's refine count
     against their plain versions; the full-width QG run on
     normcon(1024, 7) at B=64 (capped), sound, with its cut and NLP
     counts, the wall seconds of its parts and the kernels' launch
     counts; and the `mqg` CLI on st_e14a.nl.

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
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
# phase 7: normcon(n, seed) at B lanes (SUITE["normcon_1024a"]), its full
# search capped at node_cap nodes and time_cap seconds
NL = dict(n=1024, seed=7, B=64, node_cap=512, time_cap=150.0)
NL_ROWS = ("normcon_20a", "expbudget_8a", "ex1223_a", "batchdes_a")
# phase 8: QGBranchAndBound on normcon(n, seed) at B lanes (the sweep's
# mqg row normcon_1024a), capped at node_cap nodes and time_cap seconds
QG = dict(n=1024, seed=7, B=64, node_cap=512, time_cap=180.0)


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


def graph_ms(fn, calls=20, reps=5):
    """Device milliseconds per call of fn(): `calls` calls captured in one
    CUDA graph after warm-up, the graph replayed between CUDA events and
    the time divided by `calls`; the median of `reps` replays.  No host
    dispatch falls inside the window, so this is the device's time even
    where the caller's Python takes longer than the kernel."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
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


def k2_bound(B, k, sf, sm=None, steps=0):
    """K2 on (B, k) lanes with one right-hand side, factor and operator
    element sizes sf and sm: 2 k^2 flops a product, one product at refine
    0, and with refinement 2 + 2 steps (the first solve and residual, then
    a solve and a residual a round); reads Minv once, M once when refining
    (one pass each is all the function needs), dinv, r (and shift when
    refining) once, and writes x once."""
    sm = sm or sf
    prods = 1 if steps == 0 else 2 + 2 * steps
    nbytes = B * k * k * sf + (B * k * k * sm if steps else 0) + \
        B * k * sm * (2 if steps else 1) + 2 * B * k * sm
    return bound(2 * B * k * k * prods, nbytes, max(sf, sm))


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


def k2_inputs(dev, B, k, seed):
    """(M, dinv, shift, Minv_s f32, Minv_s f64) for B SPD lanes of order k
    (A A' + k I, Jacobi-scaled), float64 on the card, from a seed."""
    import torch
    from minotaur_tpu_torch.ops.spd_inverse import spd_inverse_plain
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    A = torch.randn((B, k, k), generator=g, **f64)
    M = A @ A.transpose(1, 2) + k * torch.eye(k, **f64)
    dinv = 1.0 / torch.diagonal(M, dim1=1, dim2=2).sqrt()
    Ms = M * dinv[:, :, None] * dinv[:, None, :]
    shift = 1e-3 * torch.rand((B, k), generator=g, **f64)
    return (M, dinv, shift, spd_inverse_plain(Ms.float())[0],
            spd_inverse_plain(Ms)[0])


def phase_k2(record):
    import itertools
    import torch
    from minotaur_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain
    dev = torch.device("cuda")
    F32, F64 = torch.float32, torch.float64
    # k: the scalar path (1, 31, 33, 301) and the 16-byte path (300, 1000;
    # at k=1000, R=8 the refinement vectors of an f64 operator leave shared
    # memory); dtypes (factor, operator, r, x): the three pairs and the
    # main path's f32 pair with f64 r and x
    combos = ((F32, F32, F32, F32), (F32, F64, F64, F64),
              (F64, F64, F64, F64), (F32, F32, F64, F64))
    worst = {}
    ncase = 0
    for k in (1, 31, 33, 300, 301, 1000):
        for B in (1, 64):
            M, dinv, shift, minv32, minv64 = k2_inputs(dev, B, k, 1000 * k + B)
            for R, steps, (fdt, mdt, rdt, odt) in itertools.product(
                    (1, 3, 8), (0, 1, 3), combos):
                r = torch.randn((B, k, R), dtype=F64, device=dev)
                args = (minv32 if fdt == F32 else minv64, M.to(mdt),
                        dinv.to(mdt), shift.to(mdt),
                        (r[:, :, 0] if R == 1 else r).to(rdt))
                x = spd_solve(*args, steps, odt)
                px = spd_solve_plain(*args, steps, odt)
                torch.cuda.synchronize()
                what = (k, B, R, steps, str(fdt), str(mdt), str(rdt), str(odt))
                check(x.dtype == odt and x.shape == px.shape,
                      f"K2 dtype/shape at {what}")
                err = (x - px).abs().max().item()
                tol = 1e-5 if fdt == F32 else 1e-11
                check(err <= tol * px.abs().max().item(),
                      f"K2 vs plain {err:.3g} at {what}")
                # Minv_s inverts M; refinement converges to the solve with
                # the shifted operator M + diag(shift)
                xx = x.double().reshape(B, k, R)
                op = M @ xx + (shift[:, :, None] * xx if steps else 0.0)
                res = (r - op).norm() / r.norm()
                check(res.item() < (1e-5 if steps else 1e-4),
                      f"K2 residual {res.item():.3g} at {what}")
                key = (fdt, mdt, rdt, odt)
                worst[key] = max(worst.get(key, 0.0), err)
                ncase += 1
    # times at the bench shape
    B, k = 64, 300
    M, dinv, shift, minv32, minv64 = k2_inputs(dev, B, k, 7)
    m32, d32, z32 = M.float(), dinv.float(), torch.zeros((B, k), device=dev)
    r64 = torch.randn((B, k), dtype=F64, device=dev)
    r32 = r64.float()
    t = {}

    def both(key, *args):
        # device time per call (graph replay) and the time per call of
        # back-to-back calls from Python, which the host's dispatch of
        # the wrapper (or of the plain version's ops) can set
        for name, fn in (("", spd_solve), ("plain_", spd_solve_plain)):
            t[key + name + "ms"] = graph_ms(lambda: fn(*args))
            t[key + name + "call_ms"] = event_ms(lambda: fn(*args))

    # (a) refine 0, f32, L2-warm: Minv (23 MB) stays in the 50 MB L2, as
    # between the solves of one IPM iteration
    both("", minv32, m32, d32, z32, r32, 0)
    # (b) L2-cold: four input sets (92 MB) in turn inside the timed window
    sets = [minv32] + [minv32 + 0.0 for _ in range(3)]
    turn = itertools.cycle(sets)
    t["cold_ms"] = graph_ms(
        lambda: spd_solve(next(turn), m32, d32, z32, r32, 0), calls=40)
    t["cold_plain_ms"] = graph_ms(
        lambda: spd_solve_plain(next(turn), m32, d32, z32, r32, 0), calls=40)
    # (c) the main path's call: f64 r in, f64 x out
    both("main_", minv32, m32, d32, z32, r64, 0, F64)
    # (d) refine 2, f32
    both("refine2_", minv32, m32, d32, shift.float(), r32, 2)
    # (e) f64 factors and operator, refine 3 (the dtype f64 policy's call)
    both("f64_refine3_", minv64, M, dinv, shift, r64, 3)
    # (f) the product alone, as a yardstick (not K2's function)
    u = (r32 * d32)[:, :, None]
    t["bmm_core_ms"] = graph_ms(lambda: torch.bmm(minv32, u))
    b_ms, b_by = k2_bound(B, k, 4)
    t["refine2_bound_ms"] = k2_bound(B, k, 4, 4, steps=2)[0]
    t["f64_refine3_bound_ms"] = k2_bound(B, k, 8, 8, steps=3)[0]
    main_err = worst[(F32, F32, F64, F64)]
    say(f"[4] K2 spd_solve ok on {ncase} cases (k 1..1000, B 1/64, R 1/3/8, "
        f"refine 0/1/3, 4 dtype combos): max|kernel-plain| "
        + ", ".join(f"{'/'.join(str(d)[6:] for d in key)} {v:.3g}"
                    for key, v in worst.items())
        + f"; ms per call at (64,300), device (CUDA graph replay) and, in "
        f"brackets, back-to-back calls from Python: refine 0 f32 kernel "
        f"{t['ms']:.4f} [{t['call_ms']:.4f}] plain {t['plain_ms']:.4f} "
        f"[{t['plain_call_ms']:.4f}] bound {b_ms:.4f} ({b_by}); L2-cold "
        f"kernel {t['cold_ms']:.4f} plain {t['cold_plain_ms']:.4f}; main path "
        f"(f64 r, x) kernel {t['main_ms']:.4f} [{t['main_call_ms']:.4f}] "
        f"plain {t['main_plain_ms']:.4f} [{t['main_plain_call_ms']:.4f}]; "
        f"refine 2 kernel {t['refine2_ms']:.4f} [{t['refine2_call_ms']:.4f}] "
        f"plain {t['refine2_plain_ms']:.4f} bound "
        f"{t['refine2_bound_ms']:.4f}; f64 refine 3 kernel "
        f"{t['f64_refine3_ms']:.4f} [{t['f64_refine3_call_ms']:.4f}] plain "
        f"{t['f64_refine3_plain_ms']:.4f} bound "
        f"{t['f64_refine3_bound_ms']:.4f}; bmm alone {t['bmm_core_ms']:.4f}")
    # no single PyTorch call computes the scaled, refined solve
    record["spd_solve"] = dict(max_abs_err=main_err, bound_ms=b_ms,
                               bound_by=b_by, library_ms=None, **t)


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


def phase_nl_kernels(record):
    """K1 at (B, n, n) and K2 at (B, n) refine 3, float64 (every NL
    factorization is f64 and every NL solve refines), against their plain
    versions on the same inputs."""
    import torch
    from minotaur_tpu_torch.ops.spd_inverse import (spd_inverse,
                                                    spd_inverse_plain)
    from minotaur_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain
    dev = torch.device(DEVICE)
    F64 = torch.float64
    B, k = NL["B"], NL["n"]
    g = torch.Generator(device=dev).manual_seed(11)
    A = torch.randn((B, k, k), generator=g, dtype=F64, device=dev)
    eye = torch.eye(k, dtype=F64, device=dev)
    ms = A @ A.transpose(1, 2) / k + 2.0 * eye
    del A
    minv, flag = spd_inverse(ms)
    pminv, pflag = spd_inverse_plain(ms)
    torch.cuda.synchronize()
    check(torch.equal(flag, pflag) and bool((flag == 0).all()),
          "K1 (NL shape): flags differ from plain or a lane failed")
    resid = (eye - ms @ minv).abs().max().item()
    k1_err = (minv - pminv).abs().max().item()
    check(resid < 1e-11, f"K1 (NL shape): residual {resid:.3g}")
    check(k1_err <= 1e-11 * pminv.abs().max().item(),
          f"K1 (NL shape) vs plain {k1_err:.3g}")
    del minv, pminv
    k1 = dict(ms=event_ms(lambda: spd_inverse(ms), calls=5, reps=3),
              plain_ms=event_ms(lambda: spd_inverse_plain(ms), calls=5, reps=3),
              library_ms=event_ms(lambda: torch.linalg.inv_ex(ms), calls=5,
                                  reps=3))
    k1["bound_ms"], k1_by = k1_bound(B, k, 8)
    del ms
    M, dinv, shift, _minv32, minv64 = k2_inputs(dev, B, k, 13)
    del _minv32
    r = torch.randn((B, k), dtype=F64, device=dev)
    x = spd_solve(minv64, M, dinv, shift, r, 3, F64)
    px = spd_solve_plain(minv64, M, dinv, shift, r, 3, F64)
    torch.cuda.synchronize()
    k2_err = (x - px).abs().max().item()
    check(k2_err <= 1e-11 * px.abs().max().item(),
          f"K2 (NL shape) vs plain {k2_err:.3g}")
    res = ((r - (M @ x[:, :, None])[:, :, 0] - shift * x).norm() /
           r.norm()).item()
    check(res < 1e-5, f"K2 (NL shape) residual {res:.3g}")
    args = (minv64, M, dinv, shift, r, 3, F64)
    k2 = dict(ms=graph_ms(lambda: spd_solve(*args), calls=10, reps=3),
              plain_ms=graph_ms(lambda: spd_solve_plain(*args), calls=10,
                                reps=3))
    k2["bound_ms"], k2_by = k2_bound(B, k, 8, 8, steps=3)
    del M, minv64, args
    torch.cuda.empty_cache()
    say(f"[7] K1 spd_inverse ({B},{k},{k}) f64: flags equal to plain, resid "
        f"{resid:.3g}, max|kernel-plain| {k1_err:.3g}; ms kernel "
        f"{k1['ms']:.4f} plain {k1['plain_ms']:.4f} inv_ex "
        f"{k1['library_ms']:.4f} bound {k1['bound_ms']:.4f} ({k1_by}).  "
        f"K2 spd_solve ({B},{k}) f64 refine 3: max|kernel-plain| "
        f"{k2_err:.3g}, resid {res:.3g}; device ms (CUDA graph replay) "
        f"kernel {k2['ms']:.4f} plain {k2['plain_ms']:.4f} bound "
        f"{k2['bound_ms']:.4f} ({k2_by})")
    tag = f"f64_k{k}_"
    record["spd_inverse"].update({tag + key: v for key, v in
                                  dict(max_abs_err=k1_err, **k1).items()})
    record["spd_solve"].update({tag + "refine3_" + key: v for key, v in
                                dict(max_abs_err=k2_err, **k2).items()})


def phase_nl_ipm(record):
    """The batched NL IPM on normcon(n, seed), the root box plus B-1
    seeded integer-fixing boxes, through the kernels and through their
    plain versions; then the times of the NL pieces of one iteration and
    of one superstep's FBBT round at this shape."""
    import numpy as np
    import torch
    from torch.func import hessian, jacfwd, vmap
    from minotaur_tpu_torch.bnb.step import build_fbbt_sweep
    from minotaur_tpu_torch.engines.ipm import IPMOptions, build_batch_solver
    from minotaur_tpu_torch.engines.staging import stage_problem
    from minotaur_tpu_torch.models.convex_suite import normcon
    from minotaur_tpu_torch.tools.profile_bnb import plain_kernels
    sp = stage_problem(normcon(NL["n"], NL["seed"]))
    rng = np.random.default_rng(7)
    B = NL["B"]
    lo = np.tile(sp.vlb, (B, 1))
    hi = np.tile(sp.vub, (B, 1))
    for b in range(1, B):
        pick = rng.choice(sp.n, size=int(rng.integers(1, 40)), replace=False)
        v = rng.integers(0, 4, size=len(pick)).astype(float)
        lo[b, pick] = v
        hi[b, pick] = v
    solve = build_batch_solver(sp, IPMOptions(), device=DEVICE)

    def timed():
        t0 = time.monotonic()
        r = solve(sp.A, sp.clb, sp.cub, lo, hi)
        return r, time.monotonic() - t0

    # kernel, plain, kernel: the first call also pays one-time costs
    rk, t_first = timed()
    with plain_kernels():
        rp, t_p = timed()
    rk2, t_k = timed()
    check(np.array_equal(rk.status, rk2.status),
          "NL IPM: the two kernel runs' statuses differ")
    for r in (rk, rp):
        check(np.all(np.isfinite(r.x)) and r.x.shape == (B, sp.n),
              "NL IPM returned non-finite x")
    same = rk.status == rp.status
    check(bool(same.all()), f"NL IPM: statuses differ on lanes "
          f"{np.where(~same)[0].tolist()}")
    opt = rk.status == 1
    check(bool(opt[0]), "NL IPM: root lane not SOLVED_OPTIMAL")
    rel = np.where(opt, np.abs(rk.obj - rp.obj) / (1.0 + np.abs(rp.obj)), 0.0)
    check(rel.max() <= 1e-6, f"NL IPM: objective mismatch {rel.max():.3g}")
    # the NL pieces of one iteration at this shape, and one FBBT round
    dev = torch.device(DEVICE)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    x, y = t(0.5 * (lo + hi)), t(rng.uniform(0.0, 1.0, (B, sp.m)))
    rows = t(sp.nl_rows).long()
    jac = vmap(jacfwd(sp.con_nl))
    hess = vmap(hessian(lambda xx, yy: yy.index_select(-1, rows) @
                        sp.con_nl(xx)))
    jac_ms = event_ms(lambda: jac(x), calls=3, reps=3)
    hess_ms = event_ms(lambda: hess(x, y), calls=3, reps=3)
    sweep = build_fbbt_sweep(sp, 1e-6, dev)
    A_t, clb_t, cub_t, lo_t, hi_t = t(sp.A), t(sp.clb), t(sp.cub), t(lo), t(hi)
    nofeas = torch.zeros(B, dtype=torch.bool, device=dev)
    fb = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        sweep(A_t, clb_t, cub_t, lo_t, hi_t, nofeas)
        torch.cuda.synchronize()
        fb.append(time.monotonic() - t0)
    fbbt_ms = 1e3 * sorted(fb[1:])[1]
    say(f"[7] NL IPM normcon({sp.n}) B={B} kernel vs plain ok: statuses "
        f"equal {int(same.sum())}/{B}, optimal {int(opt.sum())}/"
        f"{int((rp.status == 1).sum())}, max|dobj|/(1+|obj|) over optimal "
        f"lanes {rel.max():.3g}, iters max {int(rk.iters.max())}/"
        f"{int(rp.iters.max())}, wall s kernel {t_k:.2f} (first call "
        f"{t_first:.2f}) plain {t_p:.2f}; "
        f"at ({B},{sp.n}): Jacobian (vmap jacfwd) {jac_ms:.3f} ms, Hessian "
        f"of the Lagrangian (vmap hessian) {hess_ms:.3f} ms (CUDA events, 3 "
        f"calls, median of 3), one NL FBBT round {fbbt_ms:.1f} ms (host "
        f"clock to a synchronize, median of 3 after one warm-up; "
        f"{len(sp.nl_graphs[0])} graph nodes)")


def phase_nl_bnb(record):
    """BranchAndBound on NL suite rows against their exact oracles, then
    the full-width normcon(n, seed) search (capped) with the kernels'
    launch counts."""
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.bnb.bnb import BranchAndBound
    from minotaur_tpu_torch.models.convex_suite import SUITE, normcon, \
        normcon_optimum
    from minotaur_tpu_torch.utils.environment import Environment
    from minotaur_tpu_torch.utils.types import SolveStatus
    for name in NL_ROWS:
        gen, oracle, _ = SUITE[name]
        env = Environment()
        env.set_option("log_level", 1)
        t0 = time.monotonic()
        bab = BranchAndBound(gen(), env, device=DEVICE)
        st = bab.solve()
        dt = time.monotonic() - t0
        opt = oracle()
        check(st == SolveStatus.SOLVED_OPTIMAL, f"{name}: status {st.name}")
        check(abs(bab.ub - opt) <= 1e-6 * (1 + abs(opt)),
              f"{name}: ub {bab.ub} vs oracle {opt}")
        say(f"[7] {name}: SOLVED_OPTIMAL ub {bab.ub:.10g} oracle {opt:.10g} "
            f"nodes {bab.stats.nodes_processed} in {dt:.2f} s")

    env = Environment()
    for key, v in (("node_batch", NL["B"]), ("pad_full", 1),
                   ("bnb_node_limit", NL["node_cap"]),
                   ("bnb_time_limit", NL["time_cap"]), ("log_level", 1)):
        env.set_option(key, v)
    n, seed = NL["n"], NL["seed"]
    opt = normcon_optimum(n, seed)
    bab = BranchAndBound(normcon(n, seed), env, device=DEVICE)
    mdev.reset_launches()
    t0 = time.monotonic()
    st = bab.solve()
    dt = time.monotonic() - t0
    counts = mdev.launch_counts()
    tol = 1e-6 * (1 + abs(opt))
    check(bab.lb <= opt + tol and opt <= bab.ub + tol,
          f"normcon_{n} unsound: lb {bab.lb} opt {opt} ub {bab.ub}")
    nodes = max(1, bab.stats.nodes_processed)
    say(f"[7] normcon_{n} B={NL['B']}: status {st.name} lb {bab.lb:.10g} opt "
        f"{opt:.10g} ub {bab.ub:.10g}; nodes {nodes} in {dt:.2f} s = "
        f"{nodes / dt:.2f} nodes/s; IPM iterations {bab.stats.ipm_iters}; "
        f"supersteps {bab.stats.batches}; dispatch-to-fetch s "
        f"{bab.stats.t_device:.2f}; host bookkeeping s {bab.stats.t_host:.2f}; "
        f"launches in this solve "
        f"{{{', '.join(f'{k}: {v}' for k, v in counts.items())}}}")
    for name, cnt in counts.items():
        check(cnt > 0, f"kernel {name} was not launched by the NL path")
    record["nl_launches"] = counts


def phase_cli(record):
    """`python -m minotaur_tpu_torch.solvers.mbnb file.nl` on the card:
    normcon_20a written by the port's nl_writer."""
    from minotaur_tpu_torch.io.nl_writer import write_nl
    from minotaur_tpu_torch.models.convex_suite import SUITE
    gen, oracle, _ = SUITE["normcon_20a"]
    opt = oracle()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "normcon_20a.nl")
        write_nl(gen(), path)
        env = dict(os.environ, PYTHONPATH=HERE)
        t0 = time.monotonic()
        out = subprocess.run(
            [sys.executable, "-m", "minotaur_tpu_torch.solvers.mbnb", path,
             "--write_sol_file", "1"], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=300)
        dt = time.monotonic() - t0
        log = out.stdout + out.stderr
        check(out.returncode == 0, f"mbnb exited {out.returncode}:\n{log[-3000:]}")
        sol = os.path.join(tmp, "normcon_20a.sol")
        check(os.path.exists(sol), "mbnb wrote no .sol file")
        objs = [float(line.rsplit(" ", 1)[1]) for line in log.splitlines()
                if "best objective:" in line]
        check(len(objs) == 1 and abs(objs[0] - opt) <= 1e-6 * (1 + abs(opt)),
              f"mbnb objective {objs} vs oracle {opt}")
        with open(sol) as fh:
            head = fh.readline().strip()
    say(f"[7] mbnb CLI on normcon_20a.nl: exit 0 in {dt:.2f} s, best objective "
        f"{objs[0]:.10g} (oracle {opt:.10g}), .sol '{head}'")


class WallSplit:
    """Wall seconds of named methods of one solver, by label.  A method
    wrapped with `context=True` (root, dives, pump, oracle) also marks
    its calls as inside a context; `top=True` labels count only outside
    every context (the main loop's supersteps, not a dive's)."""

    def __init__(self):
        self.s = {}
        self.calls = {}
        self.stack = []                 # the open contexts' labels

    def wrap(self, owner, attr, label, context=False, top=False):
        fn = getattr(owner, attr)

        def timed(*args, **kw):
            if top and self.stack:
                return fn(*args, **kw)
            if context:
                self.stack.append(label)
            t0 = time.monotonic()
            try:
                return fn(*args, **kw)
            finally:
                self.s[label] = self.s.get(label, 0.0) + \
                    time.monotonic() - t0
                self.calls[label] = self.calls.get(label, 0) + 1
                if context:
                    self.stack.pop()

        for name in ("dispatch", "unpack"):     # a batch solver's surface
            if hasattr(fn, name):
                setattr(timed, name, getattr(fn, name))
        setattr(owner, attr, timed)
        return fn


def qg_env(**opts):
    from minotaur_tpu_torch.utils.environment import Environment
    env = Environment()
    for key, v in dict(log_level=1, **opts).items():
        env.set_option(key, v)
    return env


def watch_anchor(bab):
    """Count calls of bab's CPU f64 root anchor."""
    runs = []
    fn = bab._cpu_root_anchor

    def counted():
        runs.append(1)
        return fn()

    bab._cpu_root_anchor = counted
    return runs


def phase_qg_small(record):
    """QG on st_e14a and st_e14b, OA on st_e14a, against the suite's
    exact oracles; the CPU root anchor must not run."""
    from minotaur_tpu_torch.bnb.oa import OABranchAndBound
    from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
    from minotaur_tpu_torch.models.convex_suite import SUITE
    from minotaur_tpu_torch.utils.types import SolveStatus
    for cls, name in ((QGBranchAndBound, "st_e14a"),
                      (QGBranchAndBound, "st_e14b"),
                      (OABranchAndBound, "st_e14a")):
        gen, oracle, _ = SUITE[name]
        opt = oracle()
        tol = 1e-6 * (1 + abs(opt))
        t0 = time.monotonic()
        bab = cls(gen(), qg_env(node_batch=16), device=DEVICE)
        anchor = watch_anchor(bab)
        st = bab.solve()
        dt = time.monotonic() - t0
        tag = f"{cls.__name__} {name}"
        check(abs(bab.ub - opt) <= tol, f"{tag}: ub {bab.ub} vs oracle {opt}")
        check(bab.lb <= opt + tol, f"{tag}: lb {bab.lb} above oracle {opt}")
        # OA's driver ends st_e14a at SOLVED_GAP_LIMIT (lb 5e-11 below ub)
        # in both packages
        check(st in (SolveStatus.SOLVED_OPTIMAL, SolveStatus.SOLVED_GAP_LIMIT)
              if cls is OABranchAndBound else st == SolveStatus.SOLVED_OPTIMAL,
              f"{tag}: status {st.name}")
        check(not anchor, f"{tag}: the CPU root anchor ran")
        extra = (f"major iterations {bab.oa_stats.major_iters}"
                 if cls is OABranchAndBound else
                 f"cuts {bab.qg_stats.cuts_added}, NLP solves "
                 f"{bab.qg_stats.nlp_solves}")
        say(f"[8] {tag}: {st.name} ub {bab.ub:.10g} lb {bab.lb:.10g} oracle "
            f"{opt:.10g}; nodes {bab.stats.nodes_processed}, {extra}; CPU "
            f"root anchor did not run; {dt:.2f} s")


def phase_qg_kernels(record):
    """K1 in f32 at the QG master's shape and K2 at (B, n) with the
    master's call (f32 factor and operator, f64 r and x, refine_steps
    2, the default ipm_refine_steps) against their plain versions."""
    import torch
    from minotaur_tpu_torch.ops.spd_inverse import (spd_inverse,
                                                    spd_inverse_plain)
    from minotaur_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain
    dev = torch.device(DEVICE)
    F64 = torch.float64
    B, k, steps = QG["B"], QG["n"], 2
    g = torch.Generator(device=dev).manual_seed(17)
    A = torch.randn((B, k, k), generator=g, dtype=F64, device=dev)
    eye = torch.eye(k, dtype=F64, device=dev)
    ms = (A @ A.transpose(1, 2) / k + 2.0 * eye).float()
    del A
    minv, flag = spd_inverse(ms)
    pminv, pflag = spd_inverse_plain(ms)
    torch.cuda.synchronize()
    check(torch.equal(flag, pflag) and bool((flag == 0).all()),
          "K1 (QG shape): flags differ from plain or a lane failed")
    resid = (eye - ms.double() @ minv.double()).abs().max().item()
    k1_err = (minv - pminv).abs().max().item()
    check(resid < 5e-5, f"K1 (QG shape): residual {resid:.3g}")
    check(k1_err <= 5e-5 * pminv.abs().max().item(),
          f"K1 (QG shape) vs plain {k1_err:.3g}")
    del minv, pminv
    k1 = dict(ms=event_ms(lambda: spd_inverse(ms), calls=5, reps=3),
              plain_ms=event_ms(lambda: spd_inverse_plain(ms), calls=5, reps=3),
              library_ms=event_ms(lambda: torch.linalg.inv_ex(ms), calls=5,
                                  reps=3))
    k1["bound_ms"], k1_by = k1_bound(B, k, 4)
    del ms
    M, dinv, shift, minv32, _minv64 = k2_inputs(dev, B, k, 19)
    del _minv64
    m32, d32, s32 = M.float(), dinv.float(), shift.float()
    r = torch.randn((B, k), dtype=F64, device=dev)
    args = (minv32, m32, d32, s32, r, steps, F64)
    x = spd_solve(*args)
    px = spd_solve_plain(*args)
    torch.cuda.synchronize()
    k2_err = (x - px).abs().max().item()
    check(k2_err <= 1e-5 * px.abs().max().item(),
          f"K2 (QG shape) vs plain {k2_err:.3g}")
    res = ((r - (M @ x[:, :, None])[:, :, 0] - shift * x).norm() /
           r.norm()).item()
    check(res < 1e-4, f"K2 (QG shape) residual {res:.3g}")
    k2 = dict(ms=graph_ms(lambda: spd_solve(*args), calls=10, reps=3),
              plain_ms=graph_ms(lambda: spd_solve_plain(*args), calls=10,
                                reps=3))
    k2["bound_ms"], k2_by = k2_bound(B, k, 4, 4, steps=steps)
    del M, minv32, m32, args
    torch.cuda.empty_cache()
    say(f"[8] K1 spd_inverse ({B},{k},{k}) f32 (the QG master's factor): "
        f"flags equal to plain, resid {resid:.3g}, max|kernel-plain| "
        f"{k1_err:.3g}; ms kernel {k1['ms']:.4f} plain {k1['plain_ms']:.4f} "
        f"inv_ex {k1['library_ms']:.4f} bound {k1['bound_ms']:.4f} "
        f"({k1_by}).  K2 spd_solve ({B},{k}) f32 factor and operator, f64 r "
        f"and x, refine {steps}: max|kernel-plain| {k2_err:.3g}, resid "
        f"{res:.3g}; device ms (CUDA graph replay) kernel {k2['ms']:.4f} "
        f"plain {k2['plain_ms']:.4f} bound {k2['bound_ms']:.4f} ({k2_by})")
    record["spd_inverse"].update({f"qg_f32_k{k}_" + key: v for key, v in
                                  dict(max_abs_err=k1_err, **k1).items()})
    record["spd_solve"].update({f"qg_refine{steps}_k{k}_" + key: v
                                for key, v in dict(max_abs_err=k2_err,
                                                   **k2).items()})


def phase_qg_full(record):
    """QGBranchAndBound on normcon(n, seed) at B lanes (capped): sound,
    both kernels launched, with the wall seconds of its parts."""
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.bnb import multistart
    from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
    from minotaur_tpu_torch.models.convex_suite import normcon, \
        normcon_optimum
    n, seed = QG["n"], QG["seed"]
    opt = normcon_optimum(n, seed)
    env = qg_env(node_batch=QG["B"], pad_full=1,
                 bnb_node_limit=QG["node_cap"], bnb_time_limit=QG["time_cap"])
    t_build = time.monotonic()
    bab = QGBranchAndBound(normcon(n, seed), env, device=DEVICE)
    t_build = time.monotonic() - t_build
    anchor = watch_anchor(bab)
    # IPM iterations of every master superstep (main loop, probes, dives)
    # and of every fix-int oracle batch: [calls, max per call, lane sum]
    its = {"master": [0, 0, 0], "oracle": [0, 0, 0]}

    def counting(fn, key):
        def counted(*args):
            res = fn(*args)
            c = its[key]
            c[0] += 1
            c[1] = max(c[1], int(res.iters.max()))
            c[2] += int(res.iters.sum())
            return res
        return counted

    bab._fetch_step = counting(bab._fetch_step, "master")
    bab._nlp_solve.unpack = counting(bab._nlp_solve.unpack, "oracle")
    w = WallSplit()
    w.wrap(bab, "_qg_root", "root", context=True)
    w.wrap(bab, "_root_linearizations", "root ESH (root_linearizations)")
    w.wrap(bab, "_cpu_root_anchor", "root CPU anchor")
    ms_fn = w.wrap(multistart, "multistart_solve", "root multistart rescue")
    w.wrap(bab, "_nlp_solve", "NLP solves called directly (root NLP, "
           "fix-int harvests of dives and pump)")
    w.wrap(bab, "_dispatch_step", "master supersteps", top=True)
    w.wrap(bab, "_fetch_step", "master supersteps", top=True)
    w.wrap(bab, "_dispatch_oracle", "fix-int NLP oracle", context=True)
    w.wrap(bab, "_run_dive", "master dives", context=True)
    w.wrap(bab, "_run_true_dive", "true-model dive (_run_true_dive)",
           context=True)
    w.wrap(bab, "_run_pump", "feasibility pump", context=True)
    w.wrap(bab, "_cut_gen", "cut generation (all callers)")
    found = []                          # (value, superstep, context)
    accept = bab._accept_incumbent

    def accept_logged(x, val):
        better = accept(x, val)
        if better:
            found.append((val, bab.stats.batches,
                          w.stack[-1] if w.stack else "main loop"))
        return better

    bab._accept_incumbent = accept_logged
    try:
        mdev.reset_launches()
        t0 = time.monotonic()
        st = bab.solve()
        dt = time.monotonic() - t0
        counts = mdev.launch_counts()
    finally:
        multistart.multistart_solve = ms_fn
    tol = 1e-6 * (1 + abs(opt))
    check(bab.lb <= opt + tol and opt <= bab.ub + tol,
          f"QG normcon_{n} unsound: lb {bab.lb} opt {opt} ub {bab.ub}")
    nodes = max(1, bab.stats.nodes_processed)
    s = bab.qg_stats
    say(f"[8] QG normcon_{n} B={QG['B']}: status {st.name} lb {bab.lb:.10g} "
        f"opt {opt:.10g} ub {bab.ub:.10g}; nodes {nodes} in {dt:.2f} s = "
        f"{nodes / dt:.2f} nodes/s (constructor {t_build:.2f} s); supersteps "
        f"{bab.stats.batches}")
    say(f"[8] QG normcon_{n} cuts: added {s.cuts_added}, evicted "
        f"{s.cuts_evicted}, duplicate {s.cuts_duplicate}, in pool "
        f"{bab.n_cuts}; NLP solves {s.nlp_solves} (feasible "
        f"{s.nlp_feasible}, infeasible {s.nlp_infeasible}); requeues "
        f"{s.requeues}")
    for label in ("root", "root ESH (root_linearizations)",
                  "root multistart rescue", "root CPU anchor",
                  "NLP solves called directly (root NLP, fix-int harvests "
                  "of dives and pump)", "master supersteps",
                  "fix-int NLP oracle", "master dives",
                  "true-model dive (_run_true_dive)", "feasibility pump",
                  "cut generation (all callers)"):
        say(f"[8] QG normcon_{n} wall s {label}: {w.s.get(label, 0.0):.2f} "
            f"({w.calls.get(label, 0)} calls)")
    for key, what in (("master", "master supersteps (main loop, probes, "
                       "dives)"), ("oracle", "fix-int NLP oracle batches")):
        c = its[key]
        say(f"[8] QG normcon_{n} IPM iterations, {what}: {c[0]} calls, max "
            f"{c[1]} a call, {c[2]} lane-iterations")
    say(f"[8] QG normcon_{n} incumbents (value, superstep, found in): "
        + "; ".join(f"{v:.10g}, {b}, {c}" for v, b, c in found))
    say(f"[8] QG normcon_{n} CPU root anchor ran: {bool(anchor)}")
    say(f"[8] QG normcon_{n} launches in this solve "
        f"{{{', '.join(f'{key}: {v}' for key, v in counts.items())}}}")
    for name, cnt in counts.items():
        check(cnt > 0, f"kernel {name} was not launched by the QG path")
    record["qg_launches"] = counts


def phase_qg_cli(record):
    """`python -m minotaur_tpu_torch.solvers.mqg file.nl` on the card:
    st_e14a written by the port's nl_writer."""
    from minotaur_tpu_torch.io.nl_writer import write_nl
    from minotaur_tpu_torch.models.convex_suite import SUITE
    gen, oracle, _ = SUITE["st_e14a"]
    opt = oracle()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "st_e14a.nl")
        write_nl(gen(), path)
        env = dict(os.environ, PYTHONPATH=HERE)
        t0 = time.monotonic()
        out = subprocess.run(
            [sys.executable, "-m", "minotaur_tpu_torch.solvers.mqg", path],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=300)
        dt = time.monotonic() - t0
        log = out.stdout + out.stderr
        check(out.returncode == 0, f"mqg exited {out.returncode}:\n{log[-3000:]}")
        objs = [float(line.rsplit(" ", 1)[1]) for line in log.splitlines()
                if "best objective:" in line]
        check(len(objs) == 1 and abs(objs[0] - opt) <= 1e-6 * (1 + abs(opt)),
              f"mqg objective {objs} vs oracle {opt}")
        stat = [line for line in log.splitlines() if "status:" in line]
    say(f"[8] mqg CLI on st_e14a.nl: exit 0 in {dt:.2f} s, best objective "
        f"{objs[0]:.10g} (oracle {opt:.10g}), {stat[-1].strip()}")


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
    phase_nl_kernels(record)
    phase_nl_ipm(record)
    phase_nl_bnb(record)
    phase_cli(record)
    phase_qg_small(record)
    phase_qg_kernels(record)
    phase_qg_full(record)
    phase_qg_cli(record)
    launches = record["launches"]
    kernels = []
    for name, src, rep in (
            ("spd_inverse", "minotaur_tpu_torch/csrc/spd_inverse.cu",
             "minotaur_tpu/ops/pallas_kkt.py:204"),
            ("spd_solve", "minotaur_tpu_torch/csrc/spd_solve.cu",
             "minotaur_tpu/ops/pallas_kernels.py:76")):
        r = dict(record[name])
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": rep, "launches": int(launches[name]),
               "nl_launches": int(record["nl_launches"][name]),
               "qg_launches": int(record["qg_launches"][name])}
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            row[key] = r.pop(key)
        row.update(r)                   # the f64, refine and NL-shape extras
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
