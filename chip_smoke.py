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
     counts; and the `mqg` CLI on st_e14a.nl;
  9. the rest of `mbnb`: (a) intquad(300) at the bench settings under
     the default native node store, with `dtype f32` (the f32 light
     phase and f32 tail corrections), two Gondzio correctors and OBBT
     (capped), sound, with a light-phase IPM batch held to the plain
     versions lane by lane and K1 at the OBBT lanes' shape and K2 at the
     light phase's dtypes timed against plain; (b) normcon(1024, 7) under
     the QPD node processor with `qpdheur` (capped), sound, with the
     lanes verified on the true model; (c) intquad(300) checkpointed
     under a node cap and resumed to a sound finish, an SOS1 and an SOS2
     model, and `brancher weak` on cknap_30a, at their optima;
 10. the global path: (a) one glob-step batch of qknap(100, 0.25, 0) at
     full width (1378 columns, 5113 rows a lane) on 64 seeded nodes
     through the kernels against the plain versions under f64 factors
     (objectives within 1e-6) and the driver's mixed policy (certified
     bounds held; lanes at the iteration cap may end OPTIMAL in one run
     and ITERATION_LIMIT in the other), with K1 f32 at
     (64, 1378, 1378) and K2 refine 2 at (64, 1378) timed against plain;
     (b) GlobBranchAndBound on qknap(100, 0.25, 0) at B=64 (capped),
     sound, with nodes/s and launch counts, and bilinear_pooling(64)
     (capped) against its analytic optimum; (c) the `mglob` CLI on a
     nonconvex qknap(16) at its enumeration optimum and on a convex MIQP
     forwarded to QG; (d) `obbt 1` on qknap(24), sound, with K1 and K2
     at the OBBT lanes' shape against plain;
 11. the multi-device layer, its partitions all on the one card: (a) the
     sharded step (four partitions of 16 lanes) against the unsharded
     step on phase 5's 64 boxes of intquad(300), statuses equal lane by
     lane, objectives within phase 5's tolerance, the fused bound equal
     to the host's min; (b) DistQGBranchAndBound on normcon(1024, 7) at
     four partitions of 16 lanes, lb_frequency 2 (capped), sound, with
     a rebalance, per-partition counts that sum to the total, and both
     kernels launched; (c) K1 in f32 at (16, 1024, 1024) and K2 refine 2
     at (16, 1024), the partition shapes, against plain; (d) `mqgmpi
     --spawn 2` with both ranks on cuda:0 on correlated_knapsack(30, 1)
     at the DP optimum with nodes migrated, and the `mqgdist` CLI on the
     same file, the two command lines at once on the card;
 12. the device-resident node pool (`device_tree`): (a) intquad(300) at
     the bench settings and phase 6's node cap handed to the pool after
     four host supersteps (pool of 4096 slots, 8 rounds a call), sound,
     with device rounds run and K1 and K2 launched inside them, its
     nodes/s, multiround calls, rounds a call, t_device/t_host and
     spills beside phase 6's host loop; (b) correlated_knapsack(30, 1)
     at node_batch 16 under the pool at 256 slots and at 64 slots
     (4 x node_batch, the least the runner takes), both sound, the
     64-slot pool spilling to the host tree, with status, nodes and
     whether each closed at the DP optimum;
 13. the port's bench entry (`minotaur_tpu_torch/bench.py`):
     `bench.run` on intquad(300) at the bench settings, capped at phase
     6's node count and 180 s, its one-line dict with `bench.py`'s four
     keys, sound against the oracle, with K1 and K2 launched in the timed
     solve;
 14. the example gallery (`minotaur_tpu_torch/examples/`): every script
     on the card at the arguments and under the assertions of its CPU
     test (bilinear_demo at node_batch BILINEAR_BATCH), the .nl scripts
     on batchdes_a written by the port's nl_writer, with each script's
     wall seconds;
 15. the ports of the root tools: (a) `tools/run_sweep.py` with mbnb,
     mqg and moa on three suite rows written as .nl files with a
     solutions CSV, every row sound and within 1e-5 of its optimum; (b)
     `tools/ab_qpd.py` on its stand-in for nvs08 (QPD verifies lanes on
     the true model) and on qknap12 (QPD inactive), pcb and qpd at the
     same optimum; (c) `tools/dist_sweep.py` at P = 1, 2 and 4 on
     correlated_knapsack(30, 1) at the DP optimum, per-partition counts
     summing to the total, with each P's seconds a superstep; (d)
     `graft_entry.entry()` run once and `dryrun_multichip(card count)`;
     K1 and K2 launched in (a)-(d); (e) the three microbenchmarks
     (`tools/microbench_{inv,tailops,calib}.py`), K1 launched by the
     inverse's.

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
NL = dict(n=1024, seed=7, B=64, node_cap=32, time_cap=150.0)
NL_ROWS = ("normcon_20a", "expbudget_8a", "ex1223_a", "batchdes_a")
# phase 8: QGBranchAndBound on normcon(n, seed) at B lanes (the sweep's
# mqg row normcon_1024a), capped at node_cap nodes and time_cap seconds
QG = dict(n=1024, seed=7, B=64, node_cap=16, time_cap=180.0)
# phase 9a: the main-path model under dtype f32 with Gondzio correctors
# and OBBT (whose linear view of intquad is one row: K1 at (2n, 1, 1))
F32_PATH = dict(n=300, node_cap=8192, time_cap=10.0, obbt_k=1,
                options=(("dtype", "f32"), ("obbt", 1)), gondzio=2,
                max_flips=4)
# phase 9b: normcon(n, seed) under nodeproc qpd + qpdheur, capped
QPD = dict(n=1024, seed=7, B=64, node_cap=256, time_cap=60.0)
# phase 9c: the checkpointed run's node cap, the resumed run's time cap
CKPT = dict(node_cap=320, time_cap=10.0)
# phase 10: the global path on quadratic_knapsack(n, density, seed) at B
# lanes (full width: 1378 columns, 5113 rows a lane), its search capped
# at time_cap seconds (10b); bilinear_pooling(pairs, 0) capped at
# pool_cap; mglob on qknap(cli_n) (10c); obbt 1 on qknap(obbt_n) capped
# at obbt_cap (10d); the searches' caps are short so that all fifteen
# phases fit in the script's 1200 s
GLOB = dict(n=100, density=0.25, seed=0, B=64, time_cap=20.0, pairs=64,
            pool_cap=10.0, cli_n=16, obbt_n=24, obbt_cap=15.0)
# phase 11: the multi-device layer on one card: `parts` partitions of
# B / parts lanes; 11b runs DistQGBranchAndBound on normcon(n, seed)
# capped at node_cap nodes and time_cap seconds; 11d runs `mqgmpi --spawn
# ranks` and `mqgdist` on correlated_knapsack(*knap)
DIST = dict(n=1024, seed=7, B=64, parts=4, lb_frequency=2, node_cap=16,
            time_cap=40.0, ranks=2, knap=(30, 1), knap_batch=16,
            knap_lb_frequency=3)
# phase 6: intquad(300)'s search at the bench settings, capped at this
# many nodes (8192 before PR 8)
MAIN_NODE_CAP = 1024
# phase 12: device_tree's pool slots, rounds a multiround call and host
# supersteps before the handoff on the main path (12a, phase 6's caps);
# 12b runs correlated_knapsack(*knap) at knap_batch lanes under pools of
# knap_caps slots, each capped at knap_time seconds
POOL = dict(cap=4096, rounds=8, warm=4, knap=(30, 1), knap_batch=16,
            knap_caps=(256, 64), knap_time=90.0)
# phase 15: the root tools' ports: run_sweep with each solver on
# sweep_rows (suite rows written as .nl), ab_qpd on its stand-in and
# qknap12, dist_sweep on correlated_knapsack(*knap) at P = 1 .. max_parts
# at node_batch lanes (the tool's default is 32: 122 s for the three P on
# an NVIDIA H100 80GB HBM3 at 700 W, 96 s at 64)
TOOLS = dict(sweep_rows=("st_e14a", "batchdes_a", "ex1223_a"),
             sweep_time=60.0, knap=(30, 1), max_parts=4, node_batch=128)
# phase 14: bilinear_demo's node batch (its test's 8 took 182 s on an
# NVIDIA H100 80GB HBM3 at 700 W and 64 took 69 s: the supersteps' host
# dispatch)
BILINEAR_BATCH = 128
# the bench's IPM settings (bench.py:78-95) as driver options
BENCH_OPTIONS = (("node_batch", 64), ("pad_full", 1), ("ipm_max_iters", 28),
                 ("ipm_tail_kkt_rounds", 4), ("ipm_refine_steps", 0),
                 ("ipm_chol_retry", 0))


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
    # memory); dtypes (factor, operator, r, x): the three pairs, the
    # main path's f32 pair with f64 r and x, and the light phase's f32
    # pair with f64 r and f32 x (dtype f32)
    combos = ((F32, F32, F32, F32), (F32, F64, F64, F64),
              (F64, F64, F64, F64), (F32, F32, F64, F64),
              (F32, F32, F64, F32))
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


def ipm_vs_plain(sp, lo, hi, label, kw, obj_tol, max_flips=0):
    """One IPM batch through the kernels and through their plain versions:
    statuses equal lane by lane (but for at most max_flips lanes that end
    OPTIMAL in one run and ITERATION_LIMIT in the other), objectives of
    lanes optimal in both within obj_tol, each run's certified bound
    below the other's optimum.  Returns the phase line's part and the
    lanes that flipped."""
    import numpy as np
    from minotaur_tpu_torch.engines.ipm import IPMOptions, build_batch_solver
    from minotaur_tpu_torch.tools.profile_bnb import plain_kernels
    B = lo.shape[0]
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
    flips = np.where(~same)[0]
    check(len(flips) <= max_flips and
          bool(np.isin(rk.status[flips], (1, 4)).all()) and
          bool(np.isin(rp.status[flips], (1, 4)).all()),
          f"IPM ({label}): statuses differ on lanes {flips.tolist()}: "
          f"kernel {rk.status[flips].tolist()} plain "
          f"{rp.status[flips].tolist()}")
    rel = np.where(opt_k & opt_p, np.abs(rk.obj - rp.obj) / scale, 0.0)
    check(rel.max() <= obj_tol,
          f"IPM ({label}): objective mismatch {rel.max():.3g}")
    # each run's certified bound lies below the other run's optimum
    for r, o in ((rk, rp), (rp, rk)):
        lim = o.obj + obj_tol * (1.0 + np.abs(o.obj))
        bad = np.where((o.status == 1) & (r.dual_bound > lim))[0]
        check(bad.size == 0, f"IPM ({label}): certified bound above the "
              f"other run's optimum on lanes {bad.tolist()}")
    flipped = (f" (OPTIMAL/ITERATION_LIMIT flips on lanes "
               f"{flips.tolist()})") if len(flips) else ""
    return (f"{label}: statuses equal {int(same.sum())}/{B}{flipped}, optimal "
            f"{int(opt_k.sum())}/{int(opt_p.sum())}, max|dobj|/(1+|obj|) "
            f"over optimal lanes {rel.max():.3g}, iters "
            f"{int(rk.iters.max())}/{int(rp.iters.max())}, wall s kernel "
            f"{t_k:.2f} plain {t_p:.2f}"), flips


def phase_ipm(record):
    from minotaur_tpu_torch.engines.ipm import IPMOptions
    from minotaur_tpu_torch.engines.staging import stage_problem
    from minotaur_tpu_torch.models.convex_suite2 import intquad
    from minotaur_tpu_torch.tools.ipm_routes import POLICIES, phase5_boxes
    sp = stage_problem(intquad(300, 4, 0))
    lo, hi = phase5_boxes(sp, 64)
    lines = []
    # the f64 policy, and the mixed policy at the bench's settings (what
    # phase 6 runs)
    for label, kw in (("f64", dict(factor_f32=False, tail_factor_f32=False)),
                      ("bench", POLICIES["bench"])):
        obj_tol = 1e-6 if label == "f64" else 10 * IPMOptions(**kw).tail_tol
        lines.append(ipm_vs_plain(sp, lo, hi, label, kw, obj_tol)[0])
    say(f"[5] IPM intquad(300) B={lo.shape[0]} kernel vs plain ok: " +
        "; ".join(lines))


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
    for k, v in BENCH_OPTIONS + (("bnb_node_limit", MAIN_NODE_CAP),
                                 ("bnb_time_limit", 180.0),
                                 ("log_level", 1)):
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
    record["main"] = dict(nodes=nodes, seconds=dt, t_device=bab.stats.t_device,
                          t_host=bab.stats.t_host, batches=bab.stats.batches,
                          probes=bab.stats.probes, iters=facts)


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


def f32_kernels_vs_plain(B, k, seeds, steps=2):
    """K1 in f32 at (B, k, k) and K2 at (B, k) with the IPM's default call
    (f32 factor and operator, f64 r and x, refine `steps`) against their
    plain versions on seeded SPD lanes, timed.  Returns two dicts: K1's
    (resid, max_abs_err, ms, plain_ms, library_ms, bound_ms, bound_by)
    and K2's (resid, max_abs_err, ms, plain_ms, bound_ms, bound_by)."""
    import torch
    from minotaur_tpu_torch.ops.spd_inverse import (spd_inverse,
                                                    spd_inverse_plain)
    from minotaur_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain
    dev = torch.device(DEVICE)
    F64 = torch.float64
    calls = 5 if k >= 1000 else 20
    g = torch.Generator(device=dev).manual_seed(seeds[0])
    A = torch.randn((B, k, k), generator=g, dtype=F64, device=dev)
    eye = torch.eye(k, dtype=F64, device=dev)
    ms = (A @ A.transpose(1, 2) / k + 2.0 * eye).float()
    del A
    minv, flag = spd_inverse(ms)
    pminv, pflag = spd_inverse_plain(ms)
    torch.cuda.synchronize()
    what = f"K1 at ({B},{k},{k})"
    check(torch.equal(flag, pflag) and bool((flag == 0).all()),
          f"{what}: flags differ from plain or a lane failed")
    k1 = dict(resid=(eye - ms.double() @ minv.double()).abs().max().item(),
              max_abs_err=(minv - pminv).abs().max().item())
    check(k1["resid"] < 5e-5, f"{what}: residual {k1['resid']:.3g}")
    check(k1["max_abs_err"] <= 5e-5 * pminv.abs().max().item(),
          f"{what} vs plain {k1['max_abs_err']:.3g}")
    del minv, pminv
    k1.update(ms=event_ms(lambda: spd_inverse(ms), calls=calls, reps=3),
              plain_ms=event_ms(lambda: spd_inverse_plain(ms), calls=calls,
                                reps=3),
              library_ms=event_ms(lambda: torch.linalg.inv_ex(ms),
                                  calls=calls, reps=3))
    k1["bound_ms"], k1["bound_by"] = k1_bound(B, k, 4)
    del ms
    M, dinv, shift, minv32, _minv64 = k2_inputs(dev, B, k, seeds[1])
    del _minv64
    m32, d32, s32 = M.float(), dinv.float(), shift.float()
    r = torch.randn((B, k), dtype=F64, device=dev)
    args = (minv32, m32, d32, s32, r, steps, F64)
    x = spd_solve(*args)
    px = spd_solve_plain(*args)
    torch.cuda.synchronize()
    what = f"K2 at ({B},{k}) refine {steps}"
    k2 = dict(max_abs_err=(x - px).abs().max().item(),
              resid=((r - (M @ x[:, :, None])[:, :, 0] - shift * x).norm() /
                     r.norm()).item())
    check(k2["max_abs_err"] <= 1e-5 * px.abs().max().item(),
          f"{what} vs plain {k2['max_abs_err']:.3g}")
    check(k2["resid"] < 1e-4, f"{what}: residual {k2['resid']:.3g}")
    k2.update(ms=graph_ms(lambda: spd_solve(*args), calls=10, reps=3),
              plain_ms=graph_ms(lambda: spd_solve_plain(*args), calls=10,
                                reps=3))
    k2["bound_ms"], k2["bound_by"] = k2_bound(B, k, 4, 4, steps=steps)
    del M, minv32, m32, args
    torch.cuda.empty_cache()
    return k1, k2


def kernels_line(B, k, steps, k1, k2):
    return (f"K1 spd_inverse ({B},{k},{k}) f32: flags equal to plain, resid "
            f"{k1['resid']:.3g}, max|kernel-plain| {k1['max_abs_err']:.3g}; "
            f"ms kernel {k1['ms']:.4f} plain {k1['plain_ms']:.4f} inv_ex "
            f"{k1['library_ms']:.4f} bound {k1['bound_ms']:.4f} "
            f"({k1['bound_by']}).  K2 spd_solve ({B},{k}) f32 factor and "
            f"operator, f64 r and x, refine {steps}: max|kernel-plain| "
            f"{k2['max_abs_err']:.3g}, resid {k2['resid']:.3g}; device ms "
            f"(CUDA graph replay) kernel {k2['ms']:.4f} plain "
            f"{k2['plain_ms']:.4f} bound {k2['bound_ms']:.4f} "
            f"({k2['bound_by']})")


def record_kernels(record, prefix1, prefix2, k1, k2):
    keep = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms")
    record["spd_inverse"].update({prefix1 + key: k1[key] for key in keep})
    record["spd_solve"].update({prefix2 + key: k2[key] for key in keep
                                if key in k2})


def phase_qg_kernels(record):
    """K1 in f32 at the QG master's shape and K2 at (B, n) with the
    master's call (f32 factor and operator, f64 r and x, refine_steps
    2, the default ipm_refine_steps) against their plain versions."""
    B, k, steps = QG["B"], QG["n"], 2
    k1, k2 = f32_kernels_vs_plain(B, k, (17, 19), steps)
    say("[8] " + kernels_line(B, k, steps, k1, k2).replace(
        "f32:", "f32 (the QG master's factor):", 1))
    record_kernels(record, f"qg_f32_k{k}_", f"qg_refine{steps}_k{k}_", k1, k2)


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


def phase_f32_path(record):
    """9a: the main-path model under the default native node store, with
    `dtype f32` (light phase + f32 tail corrections), two Gondzio
    correctors and OBBT; a light-phase IPM batch held to plain lane by
    lane; K1 at the OBBT lanes' shape and K2 at the light phase's dtypes,
    timed against plain."""
    import dataclasses
    import torch
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.bnb import presolve
    from minotaur_tpu_torch.bnb.bnb import BranchAndBound
    from minotaur_tpu_torch.bnb.step import build_node_step
    from minotaur_tpu_torch.engines.ipm import IPMOptions
    from minotaur_tpu_torch.engines.staging import stage_problem
    from minotaur_tpu_torch.models.convex_suite2 import (intquad,
                                                          intquad_optimum)
    from minotaur_tpu_torch.ops.spd_inverse import (spd_inverse,
                                                    spd_inverse_plain)
    from minotaur_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain
    from minotaur_tpu_torch.tools.ipm_routes import (POLICIES, phase5_boxes,
                                                     route_statuses)
    from minotaur_tpu_torch.utils.environment import Environment

    env = Environment()
    for k, v in BENCH_OPTIONS + F32_PATH["options"] + (
            ("bnb_node_limit", F32_PATH["node_cap"]),
            ("bnb_time_limit", F32_PATH["time_cap"]), ("log_level", 1)):
        env.set_option(k, v)
    n = F32_PATH["n"]
    opt = intquad_optimum(n, 4, 0)
    bab = BranchAndBound(intquad(n, 4, 0), env, device=DEVICE)
    # the correctors are an IPM option, not a driver option (in the JAX
    # package too): the node step is rebuilt with them
    sopts = bab._step_opts
    bab._step_opts = dataclasses.replace(sopts, ipm=dataclasses.replace(
        sopts.ipm, gondzio_correctors=F32_PATH["gondzio"]))
    bab._step = build_node_step(bab.sp, bab._step_opts, DEVICE)
    store = type(bab.tm).__name__
    say(f"[9a] tree store: {store}")
    check(store == "NativeTreeManager",
          f"default tree store is {store}, not the native one")
    # OBBT's lane count, bound changes and launches, read around the call
    obbt = {}
    plain_obbt = presolve.Presolver.obbt

    def counted_obbt(pre, vlb, vub):
        before = mdev.launch_counts()
        out = plain_obbt(pre, vlb, vub)
        after = mdev.launch_counts()
        obbt.update(lanes=2 * len(vlb), tightened=pre.stats.obbt_tightened,
                    launches={k: after[k] - before[k] for k in after})
        return out

    presolve.Presolver.obbt = counted_obbt
    try:
        mdev.reset_launches()
        t0 = time.monotonic()
        st = bab.solve()
        dt = time.monotonic() - t0
        counts = mdev.launch_counts()
    finally:
        presolve.Presolver.obbt = plain_obbt
    tol = 1e-6 * (1 + abs(opt))
    check(bool(obbt), "OBBT did not run")
    check(bab.lb <= opt + tol and opt <= bab.ub + tol,
          f"intquad_{n} (dtype f32) unsound: lb {bab.lb} opt {opt} "
          f"ub {bab.ub}")
    for name, cnt in counts.items():
        check(cnt > 0, f"kernel {name} was not launched under dtype f32")
    nodes = max(1, bab.stats.nodes_processed)
    say(f"[9a] intquad_{n} B=64 dtype f32, gondzio_correctors "
        f"{F32_PATH['gondzio']}, obbt 1: "
        f"status {st.name} lb {bab.lb:.10g} opt {opt:.10g} ub "
        f"{bab.ub:.10g}; nodes {nodes} in {dt:.2f} s = {nodes / dt:.2f} "
        f"nodes/s; IPM iterations {bab.stats.ipm_iters}; OBBT {obbt['lanes']} "
        f"lanes, {obbt['tightened']} bounds tightened, launches "
        f"{obbt['launches']}; launches in this solve "
        f"{{{', '.join(f'{k}: {v}' for k, v in counts.items())}}}")
    record["f32_launches"] = counts
    record["obbt_launches"] = obbt["launches"]

    # a light-phase IPM batch (phase 5's boxes) through the kernels and
    # the plain versions, statuses lane by lane.  With f32 residuals more
    # lanes end at the f32 limit, where the kernels' rounding alone can
    # move a lane between OPTIMAL and ITERATION_LIMIT: up to
    # F32_PATH["max_flips"] such lanes are allowed, and ipm_routes names
    # the kernel that moved them
    sp = stage_problem(intquad(n, 4, 0))
    lo, hi = phase5_boxes(sp, 64)
    kw = POLICIES["f32"]
    check(kw["gondzio_correctors"] == F32_PATH["gondzio"],
          "ipm_routes' f32 policy differs from phase 9a's")
    line, flips = ipm_vs_plain(sp, lo, hi, "dtype f32 + gondzio", kw,
                               10 * IPMOptions(**kw).tail_tol,
                               max_flips=F32_PATH["max_flips"])
    say(f"[9a] IPM intquad({n}) B={lo.shape[0]} kernel vs plain ok: {line}")
    if len(flips):
        routes = route_statuses(n, 64, DEVICE, "f32")
        say("[9a] lanes moved, by route (K1/K2) against plain/plain, as "
            "(lane, status, plain status, iters, plain iters): " +
            "; ".join(f"{r}: {v}" for r, v in routes.items()))

    # K1 at the OBBT lanes' shape (2n lanes of the linear view's
    # condensed matrix, f32) and K2 at the light phase's call (f32 factor
    # and operator, f64 r, f32 x, refine 0), against plain
    import numpy as np
    rng = np.random.default_rng(9)
    dev = torch.device("cuda")
    kk = F32_PATH["obbt_k"]
    ms = torch.as_tensor(spd_batch(rng, 2 * n, kk), dtype=torch.float32,
                         device=dev)
    minv, flag = spd_inverse(ms)
    pminv, pflag = spd_inverse_plain(ms)
    torch.cuda.synchronize()
    k1_err = (minv - pminv).abs().max().item()
    check(torch.equal(flag, pflag) and
          k1_err <= 5e-5 * pminv.abs().max().item(),
          f"K1 at the OBBT shape vs plain {k1_err:.3g}")
    k1 = dict(ms=event_ms(lambda: spd_inverse(ms)),
              plain_ms=event_ms(lambda: spd_inverse_plain(ms)),
              library_ms=event_ms(lambda: torch.linalg.inv_ex(ms)))
    k1["bound_ms"], k1["bound_by"] = k1_bound(2 * n, kk, 4)
    # K2 at the OBBT lanes' call: the default IPM's f32 factor and
    # operator, f64 r and x, refine 2 (m-space, k = the linear rows)
    Mo, dvo, sho, minvo, _ = k2_inputs(dev, 2 * n, kk, 13)
    oargs = (minvo, Mo.float(), dvo.float(), sho.float(),
             torch.randn((2 * n, kk), dtype=torch.float64, device=dev))
    xo = spd_solve(*oargs, 2, torch.float64)
    pxo = spd_solve_plain(*oargs, 2, torch.float64)
    torch.cuda.synchronize()
    k2o_err = (xo - pxo).abs().max().item()
    check(k2o_err <= 1e-5 * pxo.abs().max().item(),
          f"K2 at the OBBT shape vs plain {k2o_err:.3g}")
    k2o = dict(ms=graph_ms(lambda: spd_solve(*oargs, 2, torch.float64)),
               plain_ms=graph_ms(lambda: spd_solve_plain(*oargs, 2,
                                                         torch.float64)))
    # Minv and M read once, dinv and shift (f32), r (f64) read once, x
    # (f64) written once; 2 + 2 x 2 products of 2 k^2 flops
    k2o["bound_ms"], k2o["bound_by"] = bound(
        2 * 2 * n * kk * kk * 6,
        2 * n * (2 * kk * kk * 4 + 2 * kk * 4 + 2 * kk * 8), 4)
    M, dinv, shift, minv32, _ = k2_inputs(dev, 64, n, 11)
    args = (minv32, M.float(), dinv.float(), shift.float(),
            torch.randn((64, n), dtype=torch.float64, device=dev))
    x = spd_solve(*args, 0, torch.float32)
    px = spd_solve_plain(*args, 0, torch.float32)
    torch.cuda.synchronize()
    k2_err = (x - px).abs().max().item()
    check(x.dtype == torch.float32 and
          k2_err <= 1e-5 * px.abs().max().item(),
          f"K2 at the light phase's dtypes vs plain {k2_err:.3g}")
    k2 = dict(ms=graph_ms(lambda: spd_solve(*args, 0, torch.float32)),
              call_ms=event_ms(lambda: spd_solve(*args, 0, torch.float32)),
              plain_ms=graph_ms(lambda: spd_solve_plain(*args, 0,
                                                        torch.float32)))
    # f64 r read once, f32 x written once
    k2["bound_ms"], k2["bound_by"] = bound(
        2 * 64 * n * n, 64 * (n * n * 4 + n * 4 + n * 8 + n * 4), 4)
    say(f"[9a] K1 at the OBBT shape ({2 * n},{kk},{kk}) f32: max|kernel-"
        f"plain| {k1_err:.3g}, ms kernel {k1['ms']:.4f} plain "
        f"{k1['plain_ms']:.4f} inv_ex {k1['library_ms']:.4f} bound "
        f"{k1['bound_ms']:.4f} ({k1['bound_by']}); K2 at the OBBT shape "
        f"({2 * n},{kk}) f32/f32, f64 r and x, refine 2: max|kernel-plain| "
        f"{k2o_err:.3g}, device ms kernel {k2o['ms']:.4f} plain "
        f"{k2o['plain_ms']:.4f} bound {k2o['bound_ms']:.6f} "
        f"({k2o['bound_by']}); K2 at the light phase's "
        f"call (64,{n}) f32/f32, f64 r, f32 x, refine 0: max|kernel-plain| "
        f"{k2_err:.3g}, device ms kernel {k2['ms']:.4f} plain "
        f"{k2['plain_ms']:.4f}, call ms {k2['call_ms']:.4f}, bound "
        f"{k2['bound_ms']:.4f} ({k2['bound_by']})")
    record["spd_inverse"].update(
        {"obbt_" + key: v for key, v in k1.items() if key != "bound_by"})
    record["spd_solve"].update(
        {"light_" + key: v for key, v in k2.items() if key != "bound_by"})
    record["spd_solve"].update(
        {"obbt_" + key: v for key, v in k2o.items() if key != "bound_by"})


def phase_qpd(record):
    """9b: normcon(n, seed) under the QPD node processor with qpdheur, at
    full width (capped): sound, with the lanes verified on the true
    model."""
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.bnb.bnb import BranchAndBound
    from minotaur_tpu_torch.models.convex_suite import normcon, \
        normcon_optimum
    from minotaur_tpu_torch.utils.environment import Environment
    env = Environment()
    for key, v in (("node_batch", QPD["B"]), ("pad_full", 1),
                   ("nodeproc", "qpd"), ("qpdheur", 1),
                   ("bnb_node_limit", QPD["node_cap"]),
                   ("bnb_time_limit", QPD["time_cap"]), ("log_level", 1)):
        env.set_option(key, v)
    n, seed = QPD["n"], QPD["seed"]
    opt = normcon_optimum(n, seed)
    t0 = time.monotonic()
    bab = BranchAndBound(normcon(n, seed), env, device=DEVICE)
    t_build = time.monotonic() - t0
    mdev.reset_launches()
    t0 = time.monotonic()
    st = bab.solve()
    dt = time.monotonic() - t0
    counts = mdev.launch_counts()
    tol = 1e-6 * (1 + abs(opt))
    check(bab.lb <= opt + tol and opt <= bab.ub + tol,
          f"normcon_{n} (qpd) unsound: lb {bab.lb} opt {opt} ub {bab.ub}")
    check(bab._qpd_verified > 0, "no lane was verified on the true model")
    for name, cnt in counts.items():
        check(cnt > 0, f"kernel {name} was not launched under qpd")
    nodes = max(1, bab.stats.nodes_processed)
    say(f"[9b] normcon_{n} B={QPD['B']} nodeproc qpd, qpdheur 1: status "
        f"{st.name} lb {bab.lb:.10g} opt {opt:.10g} ub {bab.ub:.10g}; nodes "
        f"{nodes} in {dt:.2f} s = {nodes / dt:.2f} nodes/s (QP model built "
        f"in {t_build:.2f} s); lanes verified on the true model "
        f"{bab._qpd_verified}; supersteps {bab.stats.batches}; launches "
        f"{{{', '.join(f'{k}: {v}' for k, v in counts.items())}}}")
    record["qpd_launches"] = counts


def phase_ckpt_sos_weak(record):
    """9c: the main-path model checkpointed under a node cap, then resumed
    to a sound finish; an SOS1 and an SOS2 model at their optima; and
    `brancher weak` on a small integer knapsack at its DP optimum."""
    import numpy as np
    from minotaur_tpu_torch.bnb.bnb import BranchAndBound
    from minotaur_tpu_torch.ir.functions import Function, LinearFunction
    from minotaur_tpu_torch.ir.problem import Problem
    from minotaur_tpu_torch.models.convex_suite2 import (intquad,
                                                          intquad_optimum)
    from minotaur_tpu_torch.models.generators import (correlated_knapsack,
                                                      knapsack_dp_optimum)
    from minotaur_tpu_torch.utils.environment import Environment
    from minotaur_tpu_torch.utils.types import SolveStatus

    def env_of(*opts):
        env = Environment()
        for k, v in (("log_level", 1),) + opts:
            env.set_option(k, v)
        return env

    n = F32_PATH["n"]
    opt = intquad_optimum(n, 4, 0)
    tol = 1e-6 * (1 + abs(opt))
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "search.npz")
        first = BranchAndBound(intquad(n, 4, 0), env_of(
            *BENCH_OPTIONS, ("checkpoint_file", ck),
            ("checkpoint_interval", 0.0),
            ("bnb_node_limit", CKPT["node_cap"])), device=DEVICE)
        t0 = time.monotonic()
        st1 = first.solve()
        dt1 = time.monotonic() - t0
        check(os.path.exists(ck), "no checkpoint was written")
        check(first.lb <= opt + tol and opt <= first.ub + tol,
              f"checkpointed run unsound: lb {first.lb} ub {first.ub}")
        second = BranchAndBound(intquad(n, 4, 0), env_of(
            *BENCH_OPTIONS, ("checkpoint_file", ck), ("resume", 1),
            ("checkpoint_interval", 1e9),
            ("bnb_time_limit", CKPT["time_cap"])), device=DEVICE)
        with np.load(ck) as data:
            open_nodes = int(data["vlb"].shape[0])
        t0 = time.monotonic()
        st2 = second.solve()
        dt2 = time.monotonic() - t0
    check(second.lb <= opt + tol and opt <= second.ub + tol,
          f"resumed run unsound: lb {second.lb} opt {opt} ub {second.ub}")
    check(second.lb >= first.lb - tol, "resumed bound fell below the "
          "checkpoint's")
    say(f"[9c] intquad_{n} checkpointed at the {CKPT['node_cap']}-node cap: "
        f"{st1.name} nodes {first.stats.nodes_processed} in {dt1:.2f} s, lb "
        f"{first.lb:.10g} ub {first.ub:.10g}, {open_nodes} open nodes "
        f"saved; resumed: {st2.name} nodes {second.stats.nodes_processed} "
        f"in {dt2:.2f} s, lb {second.lb:.10g} opt {opt:.10g} ub "
        f"{second.ub:.10g}")

    lines = []
    for kind, weights, c, cap in (
            ("sos1", [1.0, 2.0, 3.0], [-1.0, -1.0, -1.0], None),
            ("sos2", [1.0, 2.0, 3.0, 4.0, 5.0],
             [-1.0, -3.0, -2.0, -4.0, -1.0], 1.5)):
        p = Problem(kind)
        for _ in c:
            p.new_variable(0.0, 1.0)
        if cap is not None:
            p.new_constraint(Function(lf=LinearFunction(
                {j: 1.0 for j in range(len(c))})), -np.inf, cap, "cap")
        p.new_objective(Function(lf=LinearFunction(dict(enumerate(c)))))
        getattr(p, "_" + kind).append((weights, list(range(len(c)))))
        want = -1.0 if kind == "sos1" else -5.0
        bab = BranchAndBound(p, env_of(("node_batch", 4)), device=DEVICE)
        st = bab.solve()
        check(st == SolveStatus.SOLVED_OPTIMAL and abs(bab.ub - want) < 1e-6,
              f"{kind}: {st.name} ub {bab.ub} (optimum {want})")
        nz = np.where(np.abs(bab.best_x) > 1e-6)[0]
        check(len(nz) <= (1 if kind == "sos1" else 2) and
              (kind == "sos1" or len(nz) < 2 or nz[1] - nz[0] == 1),
              f"{kind}: solution violates the set: {bab.best_x}")
        lines.append(f"{kind} ub {bab.ub:.10g} (optimum {want:g}) nodes "
                     f"{bab.stats.nodes_processed}")
    opt_k = knapsack_dp_optimum(30, 1)
    bab = BranchAndBound(correlated_knapsack(30, 1),
                         env_of(("brancher", "weak")), device=DEVICE)
    st = bab.solve()
    check(st == SolveStatus.SOLVED_OPTIMAL and
          abs(bab.ub - opt_k) <= 1e-6 * (1 + abs(opt_k)),
          f"brancher weak on cknap_30a: {st.name} ub {bab.ub} vs {opt_k}")
    lines.append(f"brancher weak cknap_30a ub {bab.ub:.10g} (oracle "
                 f"{opt_k:.10g}) nodes {bab.stats.nodes_processed}")
    say("[9c] " + "; ".join(lines))


def qknap_optimum(p, chunk=1 << 22):
    """Exact optimum of a quadratic_knapsack model by enumerating its
    2^n binary points in chunks on the card."""
    import torch
    dev = torch.device(DEVICE)
    f64 = dict(dtype=torch.float64, device=dev)
    n = p.n_vars
    c = torch.zeros(n, **f64)
    for j, v in p.obj.fun.lf:
        c[j] += v
    Q = torch.zeros((n, n), **f64)
    for (i, j), q in p.obj.fun.qf.terms.items():
        Q[i, j] += q
    con = p.cons[0]
    w = torch.zeros(n, **f64)
    for j, v in con.fun.lf:
        w[j] += v
    bits = torch.arange(n, device=dev)
    best = float("inf")
    for start in range(0, 1 << n, chunk):
        ids = torch.arange(start, min(start + chunk, 1 << n), device=dev)
        X = ((ids[:, None] >> bits) & 1).to(torch.float64)
        val = X @ c + ((X @ Q) * X).sum(dim=1) + p.obj.const
        val = torch.where(X @ w <= con.ub + 1e-9, val, float("inf"))
        best = min(best, val.min().item())
    return best


def glob_boxes(gs, B, seed):
    """The root box and B - 1 nodes of a search: about a fifth of the
    binaries fixed at random, the auxiliary columns at their root
    bounds."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lo, hi = np.tile(gs.vlb, (B, 1)), np.tile(gs.vub, (B, 1))
    for b in range(1, B):
        fix = np.where(rng.uniform(size=gs.n_x) < 0.2)[0]
        lo[b, fix] = hi[b, fix] = rng.integers(0, 2, size=len(fix))
    return lo, hi


def glob_env(**opts):
    from minotaur_tpu_torch.utils.environment import Environment
    env = Environment()
    for k, v in dict(log_level=1, node_batch=GLOB["B"], **opts).items():
        env.set_option(k, v)
    return env


def glob_step_vs_plain(step, lo, hi, label, obj_tol, bound_tol):
    """One glob-step batch through the kernels and through their plain
    versions.  Statuses equal lane by lane, but for lanes that end
    OPTIMAL in one run and ITERATION_LIMIT in the other (lanes that reach
    the iteration cap, where the kernels' rounding decides); objectives
    of lanes optimal in both within obj_tol (None: reported only); each
    run's certified bound below the other's optimum, within bound_tol.
    Returns the phase line's part and the kernel run's launch counts."""
    import numpy as np
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.tools.profile_bnb import plain_kernels
    B, nz = lo.shape
    x0 = np.zeros_like(lo)
    mdev.reset_launches()
    t0 = time.monotonic()
    rk = step(lo, hi, x0)
    t_k = time.monotonic() - t0
    counts = mdev.launch_counts()
    with plain_kernels():
        t0 = time.monotonic()
        rp = step(lo, hi, x0)
        t_p = time.monotonic() - t0
    for r in (rk, rp):
        check(r.x.shape == (B, nz) and np.all(np.isfinite(r.x)),
              f"glob step ({label}) returned non-finite x")
    rel = np.abs(rk.obj - rp.obj) / (1 + np.abs(rp.obj))
    flips = np.where(rk.status != rp.status)[0]
    check(bool(np.isin(rk.status[flips], (1, 4)).all()) and
          bool(np.isin(rp.status[flips], (1, 4)).all()),
          f"glob step ({label}): statuses differ on lanes {flips.tolist()}: "
          f"kernel {rk.status[flips].tolist()} plain "
          f"{rp.status[flips].tolist()}")
    both = (rk.status == 1) & (rp.status == 1)
    worst = float(np.where(both, rel, 0.0).max())
    check(obj_tol is None or worst <= obj_tol,
          f"glob step ({label}): objective mismatch {worst:.3g}")
    for r, o in ((rk, rp), (rp, rk)):
        lim = o.obj + bound_tol * (1.0 + np.abs(o.obj))
        bad = np.where((o.status == 1) & (r.dual_bound > lim))[0]
        check(bad.size == 0, f"glob step ({label}): certified bound above "
              f"the other run's optimum on lanes {bad.tolist()}")
    for name, cnt in counts.items():
        check(cnt > 0, f"kernel {name} was not launched by the glob step")
    gap = np.where(rk.status == 1, (rk.obj - rk.dual_bound) /
                   (1 + np.abs(rk.obj)), 0.0)
    flipped = (f" (OPTIMAL/ITERATION_LIMIT flips on lanes {flips.tolist()}, "
               f"|dobj|/(1+|obj|) there up to {rel[flips].max():.3g})"
               if len(flips) else "")
    return (f"{label}: statuses equal {B - len(flips)}/{B}{flipped}, optimal "
            f"{int((rk.status == 1).sum())}/{int((rp.status == 1).sum())}, "
            f"max|dobj|/(1+|obj|) over optimal lanes {worst:.3g}, max (obj - "
            f"certified bound)/(1+|obj|) over the kernel run's optimal lanes "
            f"{gap.max():.3g}, wall s kernel {t_k:.2f} plain {t_p:.2f}, "
            f"launches {{{', '.join(f'{k}: {v}' for k, v in counts.items())}}}"
            ), counts


def phase_glob_step(record):
    """10a: one glob-step batch of qknap(100, 0.25, 0) at full width on 64
    seeded nodes, through the kernels and through their plain versions,
    under f64 factors and the driver's mixed policy;
    K1 and K2 at the step's shape against plain."""
    import dataclasses
    from minotaur_tpu_torch.engines.ipm import IPMOptions
    from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
    from minotaur_tpu_torch.glob.glob_step import build_glob_step
    from minotaur_tpu_torch.models.generators import quadratic_knapsack
    B = GLOB["B"]
    bab = GlobBranchAndBound(quadratic_knapsack(
        GLOB["n"], GLOB["density"], GLOB["seed"]), glob_env(), device=DEVICE)
    gs = bab.gs
    m = gs.A.shape[0] + 4 * gs.n_y + 4 * gs.n_u
    lo, hi = glob_boxes(gs, B, 21)
    f64_opts = dataclasses.replace(bab._step_opts, ipm=dataclasses.replace(
        bab._step_opts.ipm, factor_f32=False, tail_factor_f32=False))
    line64, _ = glob_step_vs_plain(build_glob_step(gs, f64_opts, DEVICE),
                                   lo, hi, "f64", 1e-6, 1e-6)
    # the driver's step, the mixed policy: its OPTIMAL means a scaled KKT
    # error below tail_tol, which on these LPs leaves objectives percents
    # apart under any change of rounding (the JAX package's against the
    # port's, on the CPU, too), so only the certificates are held
    tol = 10 * IPMOptions().tail_tol
    line32, counts = glob_step_vs_plain(bab._step, lo, hi, "mixed", None,
                                        tol)
    say(f"[10a] glob step qknap({GLOB['n']},{GLOB['density']},{GLOB['seed']}) "
        f"B={B}: nz {gs.n} (x {gs.n_x}, terms {gs.n_y}), rows {m} a lane; "
        f"kernel vs plain: {line64}; {line32}")
    del bab
    k1, k2 = f32_kernels_vs_plain(B, gs.n, (23, 29))
    say("[10a] " + kernels_line(B, gs.n, 2, k1, k2))
    record_kernels(record, "glob_", "glob_", k1, k2)
    record["glob_step_launches"] = counts


def phase_glob_full(record):
    """10b: GlobBranchAndBound on qknap(100, 0.25, 0) at B=64 (capped),
    sound, with nodes/s and the kernels' launches; bilinear_pooling(64)
    (capped) against its analytic optimum."""
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
    from minotaur_tpu_torch.models.generators import (bilinear_pooling,
                                                      quadratic_knapsack)
    p = quadratic_knapsack(GLOB["n"], GLOB["density"], GLOB["seed"])
    bab = GlobBranchAndBound(p, glob_env(bnb_time_limit=GLOB["time_cap"]),
                             device=DEVICE)
    mdev.reset_launches()
    t0 = time.monotonic()
    st = bab.solve()
    dt = time.monotonic() - t0
    counts = mdev.launch_counts()
    check(bab.lb <= bab.ub + 1e-6 * (1 + abs(bab.ub)),
          f"qknap_{GLOB['n']}: lb {bab.lb} above ub {bab.ub}")
    # a capped run may end before any incumbent; one it found is feasible
    # and is the ub
    check(bab.best_x is None or (
        p.is_feasible(bab.best_x, atol=1e-5, int_tol=1e-6) and
        abs(p.eval_objective(bab.best_x) - bab.ub) <= 1e-6 * (1 + abs(bab.ub))),
          f"qknap_{GLOB['n']}: the incumbent is infeasible or not the ub")
    for name, cnt in counts.items():
        check(cnt > 0, f"kernel {name} was not launched by the glob search")
    nodes = max(1, bab.nodes_processed)
    say(f"[10b] qknap_{GLOB['n']} B={GLOB['B']} (GlobBranchAndBound): status "
        f"{st.name} lb {bab.lb:.10g} ub {bab.ub:.10g} gap "
        f"{bab._gap() * 100:.4g}%, incumbent "
        f"{'none' if bab.best_x is None else 'feasible'}; nodes {nodes} in "
        f"{dt:.2f} s = "
        f"{nodes / dt:.3f} nodes/s; supersteps {bab._steps_done}; launches "
        f"{{{', '.join(f'{k}: {v}' for k, v in counts.items())}}}")
    record["glob_launches"] = counts

    p = bilinear_pooling(GLOB["pairs"], 0)
    c = [-v for v in p.obj.fun.qf.terms.values()]
    opt = -sum(ci * (con.ub / 2) ** 2 for ci, con in zip(c, p.cons))
    bab = GlobBranchAndBound(p, glob_env(bnb_time_limit=GLOB["pool_cap"]),
                             device=DEVICE)
    t0 = time.monotonic()
    st = bab.solve()
    dt = time.monotonic() - t0
    tol = 1e-6 * (1 + abs(opt))
    check(bab.lb <= opt + tol and opt <= bab.ub + tol,
          f"bilin_{GLOB['pairs']} unsound: lb {bab.lb} opt {opt} ub {bab.ub}")
    say(f"[10b] bilinear_pooling({GLOB['pairs']}, 0) B={GLOB['B']}: status "
        f"{st.name} lb {bab.lb:.10g} opt {opt:.10g} ub {bab.ub:.10g}; nodes "
        f"{bab.nodes_processed} in {dt:.2f} s")


def phase_glob_cli(record):
    """10c: `python -m minotaur_tpu_torch.solvers.mglob file.nl` on the
    card: a nonconvex qknap at its enumeration optimum, and a convex MIQP
    forwarded to QG."""
    import numpy as np
    from minotaur_tpu_torch.io.nl_writer import write_nl
    from minotaur_tpu_torch.ir.functions import (Function, LinearFunction,
                                                 QuadraticFunction)
    from minotaur_tpu_torch.ir.problem import Problem
    from minotaur_tpu_torch.models.generators import quadratic_knapsack
    from minotaur_tpu_torch.utils.types import VarType
    convex = Problem("convminlp")
    convex.new_variable(0, 10)
    convex.new_variable(0, 10, VarType.INTEGER)
    convex.new_constraint(Function(lf=LinearFunction({0: 1.0, 1: 1.0})),
                          3.7, np.inf)
    qf = QuadraticFunction()
    qf.add_term(0, 0, 1.0)
    qf.add_term(1, 1, 1.0)
    convex.new_objective(Function(qf=qf))
    qk = quadratic_knapsack(GLOB["cli_n"], GLOB["density"], GLOB["seed"])
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, prob, opt, says in (
                (f"qknap{GLOB['cli_n']}", qk, qknap_optimum(qk), "nodes:"),
                ("convminlp", convex, 6.89, "forwarding to QG")):
            path = os.path.join(tmp, name + ".nl")
            write_nl(prob, path)
            env = dict(os.environ, PYTHONPATH=HERE)
            t0 = time.monotonic()
            out = subprocess.run(
                [sys.executable, "-m", "minotaur_tpu_torch.solvers.mglob",
                 path, "--write_sol_file", "1", "--node_batch", "64"],
                cwd=tmp, env=env, capture_output=True, text=True,
                timeout=300)
            dt = time.monotonic() - t0
            log = out.stdout + out.stderr
            check(out.returncode == 0,
                  f"mglob exited {out.returncode}:\n{log[-3000:]}")
            objs = [float(line.rsplit(" ", 1)[1]) for line in
                    log.splitlines() if "best objective:" in line]
            check(len(objs) == 1 and
                  abs(objs[0] - opt) <= 1e-6 * (1 + abs(opt)),
                  f"mglob on {name}: objective {objs} vs optimum {opt}")
            check(says in log, f"mglob on {name}: no '{says}' in the log")
            sol = os.path.join(tmp, name + ".sol")
            check(os.path.exists(sol), f"mglob wrote no .sol for {name}")
            with open(sol) as fh:
                head = fh.readline().strip()
            lines.append(f"{name}.nl exit 0 in {dt:.2f} s, best objective "
                         f"{objs[0]:.10g} (optimum {opt:.10g}), .sol "
                         f"'{head}'")
    say("[10c] mglob CLI: " + "; ".join(lines))


def phase_glob_obbt(record):
    """10d: GlobBranchAndBound with `obbt 1` on qknap(24) (capped): root
    OBBT as 2 nz lanes of one IPM call, sound; K1 and K2 at its lanes'
    shape against plain."""
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
    from minotaur_tpu_torch.models.generators import quadratic_knapsack
    n = GLOB["obbt_n"]
    p = quadratic_knapsack(n, GLOB["density"], GLOB["seed"])
    opt = qknap_optimum(p)
    bab = GlobBranchAndBound(p, glob_env(obbt=1,
                                         bnb_time_limit=GLOB["obbt_cap"]),
                             device=DEVICE)
    gs = bab.gs
    obbt = {}
    plain_obbt = bab._root_obbt

    def counted_obbt(vlb, vub):
        before = mdev.launch_counts()
        t0 = time.monotonic()
        lo, hi = plain_obbt(vlb, vub)
        after = mdev.launch_counts()
        obbt.update(s=time.monotonic() - t0, tightened=int(
            (lo > vlb + 1e-7).sum() + (hi < vub - 1e-7).sum()),
            launches={k: after[k] - before[k] for k in after})
        return lo, hi

    bab._root_obbt = counted_obbt
    mdev.reset_launches()
    t0 = time.monotonic()
    st = bab.solve()
    dt = time.monotonic() - t0
    tol = 1e-6 * (1 + abs(opt))
    check(bool(obbt), "glob OBBT did not run")
    check(bab.lb <= opt + tol and opt <= bab.ub + tol,
          f"qknap_{n} (obbt 1) unsound: lb {bab.lb} opt {opt} ub {bab.ub}")
    for name, cnt in obbt["launches"].items():
        check(cnt > 0, f"kernel {name} was not launched by glob OBBT")
    lanes = 2 * gs.n
    m = gs.A.shape[0] + 4 * gs.n_y + 4 * gs.n_u
    k = gs.n if m >= gs.n else m
    say(f"[10d] qknap_{n} obbt 1: OBBT {lanes} lanes (k = {k}) in "
        f"{obbt['s']:.2f} s, {obbt['tightened']} bounds tightened, launches "
        f"{obbt['launches']}; search {st.name} lb {bab.lb:.10g} opt "
        f"{opt:.10g} ub {bab.ub:.10g}, nodes {bab.nodes_processed} in "
        f"{dt:.2f} s")
    k1, k2 = f32_kernels_vs_plain(lanes, k, (31, 37))
    say("[10d] " + kernels_line(lanes, k, 2, k1, k2))
    record_kernels(record, "glob_obbt_", "glob_obbt_", k1, k2)
    record["glob_obbt_launches"] = obbt["launches"]


def phase_dist_step(record):
    """11a: the sharded step over four partitions on the card against the
    unsharded step on phase 5's boxes, under phase 5's two policies."""
    import numpy as np
    from minotaur_tpu_torch.bnb.step import StepOptions, build_node_step
    from minotaur_tpu_torch.engines.ipm import IPMOptions
    from minotaur_tpu_torch.engines.staging import stage_problem
    from minotaur_tpu_torch.models.convex_suite2 import intquad
    from minotaur_tpu_torch.parallel.pool import build_sharded_step
    from minotaur_tpu_torch.tools.ipm_routes import POLICIES, phase5_boxes
    sp = stage_problem(intquad(300, 4, 0))
    B, parts = DIST["B"], DIST["parts"]
    lo, hi = phase5_boxes(sp, B)
    x0, y0 = np.zeros((B, sp.n)), np.zeros((B, sp.m))
    lines = []
    for label, kw in (("f64", dict(factor_f32=False, tail_factor_f32=False)),
                      ("bench", POLICIES["bench"])):
        opts = StepOptions(ipm=IPMOptions(**kw))
        obj_tol = 1e-6 if label == "f64" else 10 * opts.ipm.tail_tol
        whole = build_node_step(sp, opts, device=DEVICE)
        sharded = build_sharded_step(sp, opts, [DEVICE] * parts)
        t0 = time.monotonic()
        ru = whole(sp.A, sp.clb, sp.cub, lo, hi, x0, y0)
        t_u = time.monotonic() - t0
        t0 = time.monotonic()
        rs, gub = sharded(sp.A, sp.clb, sp.cub, lo, hi, x0, y0, np.inf)
        t_s = time.monotonic() - t0
        diff = np.where(rs.status != ru.status)[0]
        check(diff.size == 0, f"11a ({label}): sharded statuses differ from "
              f"unsharded on lanes {diff.tolist()}: {rs.status[diff]} vs "
              f"{ru.status[diff]}")
        both = (rs.status == 1) & (ru.status == 1)
        rel = np.where(both, np.abs(rs.obj - ru.obj) / (1 + np.abs(ru.obj)),
                       0.0)
        check(rel.max() <= obj_tol, f"11a ({label}): objective mismatch "
              f"{rel.max():.3g}")
        ok = rs.int_feasible & (rs.status == 1)
        host = float(np.min(rs.obj[ok], initial=np.inf))
        check(gub == host, f"11a ({label}): fused bound {gub} vs host {host}")
        same_it = int((rs.iters == ru.iters).sum())
        lines.append(f"{label}: statuses equal {B}/{B}, iterations equal "
                     f"{same_it}/{B}, max|dobj|/(1+|obj|) {rel.max():.3g}, "
                     f"fused bound {gub:.10g} = host min; wall s unsharded "
                     f"{t_u:.2f} sharded {t_s:.2f}")
    say(f"[11a] sharded step intquad(300) B={B} as {parts} partitions of "
        f"{B // parts} on {DEVICE} vs unsharded ok: " + "; ".join(lines))


def phase_dist_qg(record):
    """11b: DistQGBranchAndBound on normcon(n) at `parts` partitions of
    B / parts lanes on the card (capped): sound, a rebalance, the
    per-partition counts summing to the total, both kernels launched."""
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.models.convex_suite import normcon, \
        normcon_optimum
    from minotaur_tpu_torch.parallel.dist_bnb import DistQGBranchAndBound
    n, seed, parts = DIST["n"], DIST["seed"], DIST["parts"]
    opt = normcon_optimum(n, seed)
    env = qg_env(node_batch=DIST["B"], lb_frequency=DIST["lb_frequency"],
                 bnb_node_limit=DIST["node_cap"],
                 bnb_time_limit=DIST["time_cap"])
    t_build = time.monotonic()
    bab = DistQGBranchAndBound(normcon(n, seed), [DEVICE] * parts, env=env)
    t_build = time.monotonic() - t_build
    # IPM iterations of the partitioned supersteps: [calls, max a lane,
    # lane sum], and their wall seconds
    its = [0, 0, 0, 0.0]
    sharded = bab._sharded

    def counted(*args):
        t0 = time.monotonic()
        res, gub = sharded(*args)
        its[0] += 1
        its[1] = max(its[1], int(res.iters.max()))
        its[2] += int(res.iters.sum())
        its[3] += time.monotonic() - t0
        return res, gub

    bab._sharded = counted
    w = WallSplit()
    w.wrap(bab, "_qg_root", "root", context=True)
    w.wrap(bab, "_dispatch_oracle", "fix-int NLP oracle", context=True)
    w.wrap(bab, "_run_dive", "master dives", context=True)
    mdev.reset_launches()
    t0 = time.monotonic()
    st = bab.solve()
    dt = time.monotonic() - t0
    counts = mdev.launch_counts()
    tol = 1e-6 * (1 + abs(opt))
    check(bab.lb <= opt + tol and opt <= bab.ub + tol,
          f"DistQG normcon_{n} unsound: lb {bab.lb} opt {opt} ub {bab.ub}")
    check(bab.stats.rebalances >= 1, "DistQG: no rebalance ran")
    per = [p.nodes_processed for p in bab.pools]
    check(sum(per) == bab.stats.nodes_processed,
          f"DistQG: partition counts {per} vs {bab.stats.nodes_processed}")
    for name, cnt in counts.items():
        check(cnt > 0, f"kernel {name} was not launched by DistQG")
    nodes = max(1, bab.stats.nodes_processed)
    loop = dt - w.s.get("root", 0.0)
    steps = max(1, bab.stats.batches)
    say(f"[11b] DistQG normcon_{n} {parts} partitions x {DIST['B'] // parts} "
        f"lanes on {DEVICE}: status {st.name} lb {bab.lb:.10g} opt "
        f"{opt:.10g} ub {bab.ub:.10g}; nodes {nodes} in {dt:.2f} s = "
        f"{nodes / dt:.2f} nodes/s (constructor {t_build:.2f} s, root "
        f"{w.s.get('root', 0.0):.2f} s); supersteps {bab.stats.batches}, "
        f"{loop / steps:.2f} s a superstep after the root; partitioned "
        f"steps {its[3]:.2f} s ({its[3] / max(1, its[0]):.2f} s a call, "
        f"{its[0]} calls of {parts} IPM calls, max {its[1]} IPM iterations "
        f"a lane, {its[2] / max(1, its[0] * DIST['B']):.1f} a lane on "
        f"average); oracle {w.s.get('fix-int NLP oracle', 0.0):.2f} s "
        f"({w.calls.get('fix-int NLP oracle', 0)} calls); dives "
        f"{w.s.get('master dives', 0.0):.2f} s; rebalances "
        f"{bab.stats.rebalances}, migrated {bab.stats.nodes_migrated}; per "
        f"partition {per}; cuts {bab.qg_stats.cuts_added}; launches "
        f"{{{', '.join(f'{k}: {v}' for k, v in counts.items())}}}")
    record["dist_launches"] = counts


def phase_dist_kernels(record):
    """11c: K1 f32 and K2 refine 2 at one partition's shape."""
    B, k, steps = DIST["B"] // DIST["parts"], DIST["n"], 2
    k1, k2 = f32_kernels_vs_plain(B, k, (41, 43), steps)
    say("[11c] " + kernels_line(B, k, steps, k1, k2).replace(
        "f32:", "f32 (one partition's master factor):", 1))
    record_kernels(record, f"dist_f32_k{k}_b{B}_", f"dist_refine{steps}_k{k}_b{B}_",
                   k1, k2)


def phase_dist_cli(record):
    """11d: `mqgmpi --spawn 2` with both ranks on cuda:0, and `mqgdist`, on
    correlated_knapsack(30, 1) written by the port's nl_writer."""
    from ast import literal_eval

    import torch
    from minotaur_tpu_torch.io.nl_writer import write_nl
    from minotaur_tpu_torch.models.generators import (correlated_knapsack,
                                                      knapsack_dp_optimum)
    knap = DIST["knap"]
    dp = knapsack_dp_optimum(*knap)
    opts = ["--node_batch", str(DIST["knap_batch"]), "--lb_frequency",
            str(DIST["knap_lb_frequency"])]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cknap30.nl")
        write_nl(correlated_knapsack(*knap), path)
        env = dict(os.environ, PYTHONPATH=HERE)
        # the two command lines run at once, sharing the card
        procs = {}
        for name, extra in (("mqgmpi", ["--spawn", str(DIST["ranks"]),
                                        "--log_level", "1"]),
                            ("mqgdist", [])):
            fo = open(os.path.join(tmp, name + ".log"), "w+")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", f"minotaur_tpu_torch.solvers.{name}",
                 path] + extra + opts, cwd=tmp, env=env, stdout=fo,
                stderr=subprocess.STDOUT, text=True), fo, time.monotonic())
        outs = {}
        try:
            while len(outs) < len(procs):
                for name, (proc, fo, t0) in procs.items():
                    if name in outs or proc.poll() is None:
                        continue
                    fo.seek(0)
                    outs[name] = (fo.read(), time.monotonic() - t0)
                    check(proc.returncode == 0, f"{name} exited "
                          f"{proc.returncode}:\n{outs[name][0][-3000:]}")
                check(time.monotonic() - t0 < 420,
                      f"11d: still running after 420 s: "
                      f"{sorted(set(procs) - set(outs))}")
                time.sleep(0.2)
        finally:
            for proc, fo, _ in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                fo.close()
    log, dt = outs["mqgmpi"]
    lines = {line.split(":", 1)[0]: line.split(":", 1)[1].strip()
             for line in log.splitlines() if ":" in line}
    check(lines.get("status") == "SOLVED_OPTIMAL", f"mqgmpi status: {log[-2000:]}")
    best = float(lines["best objective"].split()[0])
    check(abs(best - dp) <= 1e-9 * (1 + abs(dp)),
          f"mqgmpi objective {best} vs DP {dp}")
    devices = literal_eval(lines["devices"])
    cards = torch.cuda.device_count()
    check(devices == [f"cuda:{r % cards}" for r in range(DIST["ranks"])],
          f"mqgmpi devices {devices}")
    seen = literal_eval(lines["per-rank counts seen by each rank"])
    check(all(s == seen[0] for s in seen), f"mqgmpi per-rank lists {seen}")
    migrated = literal_eval(lines["migrated in per rank"])
    check(sum(migrated) > 0, "mqgmpi: no node migrated")
    say(f"[11d] mqgmpi --spawn {DIST['ranks']} on {devices}: SOLVED_OPTIMAL "
        f"best {best:.10g} (DP {dp:.10g}), nodes per rank "
        f"{lines['nodes per rank']} (each rank's list {seen[0]}), migrated "
        f"in per rank {migrated}; {dt:.2f} s including the processes' start")
    log, dt = outs["mqgdist"]
    objs = [float(line.rsplit(" ", 1)[1]) for line in log.splitlines()
            if "best objective:" in line]
    check(len(objs) == 1 and abs(objs[0] - dp) <= 1e-9 * (1 + abs(dp)),
          f"mqgdist objective {objs} vs DP {dp}")
    part = [line for line in log.splitlines() if "partitions:" in line]
    stat = [line for line in log.splitlines() if "status:" in line]
    say(f"[11d] mqgdist CLI on cknap30.nl: exit 0 in {dt:.2f} s, "
        f"{stat[-1].strip()}, best objective {objs[0]:.10g}; "
        f"{part[-1].strip()}")


def phase_device_tree(record):
    """12: the device-resident node pool on the main path (12a) and a
    pool too small for the search (12b)."""
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.bnb import device_pool
    from minotaur_tpu_torch.bnb.bnb import BranchAndBound
    from minotaur_tpu_torch.models.convex_suite2 import (intquad,
                                                          intquad_optimum)
    from minotaur_tpu_torch.models.generators import (correlated_knapsack,
                                                      knapsack_dp_optimum)
    from minotaur_tpu_torch.utils.environment import Environment

    def pool_env(options):
        env = Environment()
        for k, v in options + (("device_tree", 1), ("log_level", 1)):
            env.set_option(k, v)
        return env

    # launches inside device mode: read around every DevicePoolRunner.run
    inside = dict.fromkeys(mdev.launch_counts(), 0)
    run = device_pool.DevicePoolRunner.run

    def counted_run(self, t0):
        before = mdev.launch_counts()
        try:
            return run(self, t0)
        finally:
            for k, v in mdev.launch_counts().items():
                inside[k] += v - before[k]

    device_pool.DevicePoolRunner.run = counted_run
    try:
        # 12a: the main path at phase 6's settings and caps
        env = pool_env(BENCH_OPTIONS + (
            ("bnb_node_limit", MAIN_NODE_CAP), ("bnb_time_limit", 180.0),
            ("device_rounds", POOL["rounds"]),
            ("device_pool_cap", POOL["cap"]),
            ("device_warm_batches", POOL["warm"])))
        opt = intquad_optimum(300, 4, 0)
        bab = BranchAndBound(intquad(300, 4, 0), env, device=DEVICE)
        mdev.reset_launches()
        t0 = time.monotonic()
        st = bab.solve()
        dt = time.monotonic() - t0
        counts = mdev.launch_counts()
        tol = 1e-6 * (1 + abs(opt))
        check(bab.lb <= opt + tol <= bab.ub + 2 * tol,
              f"12a unsound: lb {bab.lb} opt {opt} ub {bab.ub}")
        pool = bab._dev_pool
        check(pool is not None, "12a: the search never entered device mode")
        check(pool.processed > 0, "12a: device rounds processed no node")
        for name, cnt in inside.items():
            check(cnt > 0, f"12a: kernel {name} not launched in device mode")
        nodes = max(1, bab.stats.nodes_processed)
        main = record["main"]
        say(f"[12a] intquad_300 B=64 device_tree (pool {POOL['cap']}, "
            f"{POOL['rounds']} rounds a call, handoff after {POOL['warm']} "
            f"host supersteps): status {st.name} lb {bab.lb:.10g} opt "
            f"{opt:.10g} ub {bab.ub:.10g}; nodes {nodes} in {dt:.2f} s = "
            f"{nodes / dt:.2f} nodes/s (phase 6's host loop in this call: "
            f"{main['nodes']} in {main['seconds']:.2f} s = "
            f"{main['nodes'] / main['seconds']:.2f} nodes/s); device rounds "
            f"processed {pool.processed} nodes in {pool.calls} multiround "
            f"calls, {pool.rounds} rounds = "
            f"{pool.rounds / max(1, pool.calls):.2f} a call; "
            f"dispatch-to-fetch s {bab.stats.t_device:.2f} (sum of "
            f"overlapping windows, as phase 6's) host bookkeeping s "
            f"{bab.stats.t_host:.2f} (phase 6: {main['t_device']:.2f}, "
            f"{main['t_host']:.2f}); spills {bab.stats.rebalances}; host "
            f"supersteps {bab.stats.batches - pool.calls}, strong-branch "
            f"probe lanes {bab.stats.probes}, IPM lane-iterations "
            f"{bab.stats.ipm_iters} (phase 6: {main['batches']} supersteps, "
            f"{main['probes']} probe lanes, {main['iters']} lane-iterations); "
            f"launches in this solve {counts}, inside device mode "
            f"{dict(inside)}")
        record["device_tree_launches"] = dict(inside)

        # 12b: a pool of 256 slots, and one of 64 that must spill
        dp = knapsack_dp_optimum(*POOL["knap"])
        tol = 1e-6 * (1 + abs(dp))
        parts = []
        for cap in POOL["knap_caps"]:
            env = pool_env((("node_batch", POOL["knap_batch"]),
                            ("device_pool_cap", cap),
                            ("device_rounds", POOL["rounds"]),
                            ("bnb_time_limit", POOL["knap_time"])))
            bab = BranchAndBound(correlated_knapsack(*POOL["knap"]), env,
                                 device=DEVICE)
            t0 = time.monotonic()
            st = bab.solve()
            dt = time.monotonic() - t0
            check(bab.lb <= dp + tol <= bab.ub + 2 * tol,
                  f"12b pool {cap} unsound: lb {bab.lb} DP {dp} ub {bab.ub}")
            check(bab._dev_pool is not None and bab._dev_pool.processed > 0,
                  f"12b pool {cap}: no device round ran")
            closed = st.name == "SOLVED_OPTIMAL" and abs(bab.ub - dp) <= tol
            parts.append(
                f"pool {cap}: {st.name} ub {bab.ub:.10g} nodes "
                f"{bab.stats.nodes_processed} (device "
                f"{bab._dev_pool.processed}) "
                f"spills {bab.stats.rebalances} in {dt:.2f} s, "
                f"{'closed' if closed else 'NOT closed'} at the DP optimum")
        check(bab.stats.rebalances >= 1,
              f"12b: the {POOL['knap_caps'][-1]}-slot pool never spilled")
        say(f"[12b] correlated_knapsack{POOL['knap']} B={POOL['knap_batch']} "
            f"device_tree (DP {dp:.10g}): " + "; ".join(parts))
    finally:
        device_pool.DevicePoolRunner.run = run


def phase_bench(record):
    """13: the port's bench entry (`minotaur_tpu_torch/bench.py`) at
    phase 6's node cap: the four-key line, sound, K1 and K2 launched."""
    from minotaur_tpu_torch import bench
    res = bench.run(node_limit=MAIN_NODE_CAP, time_limit=180.0,
                    device=DEVICE)
    line = res["line"]
    check(tuple(line) == bench.LINE_KEYS, f"bench line keys {tuple(line)}")
    check(line["metric"] == "bnb_nodes_per_sec" and
          line["unit"] == "nodes/s" and line["value"] > 0,
          f"bench line {line}")
    opt = res["optimum"]
    tol = bench.SOUND_RTOL * (1 + abs(opt))
    check(res["lb"] <= opt + tol and opt <= res["ub"] + tol,
          f"bench unsound: lb {res['lb']} opt {opt} ub {res['ub']}")
    for name, cnt in res["launches"].items():
        check(cnt > 0, f"kernel {name} was not launched by the bench run")
    record["bench_launches"] = res["launches"]
    say(f"[13] bench.run intquad{bench.INTQUAD} B={bench.NODE_BATCH} (cap "
        f"{MAIN_NODE_CAP} nodes, 180 s): {json.dumps(line)}; status "
        f"{res['status'].name}, stopped by {res['stopped_by']}; lb "
        f"{res['lb']:.10g} opt {opt:.10g} ub {res['ub']:.10g}; nodes "
        f"{res['nodes']} in {res['seconds']:.2f} s; KKT factorizations/s "
        f"{res['ipm_iters'] / res['seconds']:.1f}; launches in the timed "
        f"solve {res['launches']}; card {res['card']}")


def phase_examples(record):
    """14: every script of the port's gallery on the card, at the
    arguments and under the assertions of its CPU test
    (tests/test_torch_examples_*.py; bilinear_demo at node_batch
    BILINEAR_BATCH); the .nl scripts read batchdes_a written by the
    port's nl_writer."""
    import contextlib
    import importlib
    import numpy as np
    from scipy.optimize import minimize
    from minotaur_tpu_torch.engines.ipm import build_batch_solver
    from minotaur_tpu_torch.io.nl_reader import read_nl
    from minotaur_tpu_torch.io.nl_writer import write_nl
    from minotaur_tpu_torch.models.convex_suite import (
        batchdes_like, batchdes_like_optimum)
    from minotaur_tpu_torch.utils.types import SolveStatus

    ok = SolveStatus.SOLVED_OPTIMAL
    opt = batchdes_like_optimum()
    mod = lambda name: importlib.import_module(  # noqa: E731
        "minotaur_tpu_torch.examples." + name)

    def knapsack_best():
        p, w, cap = mod("knapsack_qp").build()
        xs = (np.arange(2 ** len(w))[:, None] >> np.arange(len(w))) & 1
        return min(p.eval_objective(x.astype(float)) for x in xs
                   if w @ x <= cap)

    def relaxation(path):
        p = read_nl(path)
        lo, hi = p.var_bounds()
        g = lambda x: p.eval_constraints(x)  # noqa: E731
        clb = np.array([c.lb for c in p.cons])
        cub = np.array([c.ub for c in p.cons])
        lk, uk = np.isfinite(clb), np.isfinite(cub)
        cons = [dict(type="ineq", fun=lambda x: (g(x) - clb)[lk]),
                dict(type="ineq", fun=lambda x: (cub - g(x))[uk])]
        r = minimize(p.eval_objective, 0.5 * (lo + hi), method="SLSQP",
                     bounds=list(zip(lo, hi)),
                     constraints=[c for c, k in zip(cons, (lk, uk))
                                  if k.any()],
                     options=dict(ftol=1e-14, maxiter=500))
        check(r.success, f"SLSQP: {r.message}")
        return float(r.fun)

    def benders_best():
        m = mod("benders_demo")
        sub = m._build_sub()
        solve = build_batch_solver(sub, device=DEVICE)
        best = np.inf
        for mask in range(2 ** len(m.F_COST)):
            yy = np.array([(mask >> i) & 1 for i in range(len(m.F_COST))],
                          float)
            tot = float(m.F_COST @ yy)
            for s in range(len(m.PROBS)):
                r = solve(sub.A, np.concatenate([m.DEMANDS[s], -m.CAP * yy]),
                          sub.cub, sub.vlb[None, :], sub.vub[None, :])
                tot += float(m.PROBS[s]) * float(r.obj[0])
            best = min(best, tot)
        return best

    with tempfile.TemporaryDirectory() as tmp:
        nl = os.path.join(tmp, "batchdes_a.nl")
        write_nl(batchdes_like(), nl)
        cuda = dict(device=DEVICE)
        relax = relaxation(nl)
        # (script, arguments, check of its result)
        cases = (
            ("simple_bnb", dict(node_batch=4, log_level=1, **cuda),
             lambda b: b.ub < 1e19 and b.best_x is not None),
            ("knapsack_qp", cuda, lambda b: b.status == ok and
             abs(b.ub - knapsack_best()) <= 1e-6),
            ("root_relaxation", dict(path=nl, log=False, **cuda),
             lambda r: abs(r[0] - relax) <= 1e-6 and r[1] >= r[0] - 1e-7),
            ("batched_engine", dict(path=nl, batch=4, **cuda),
             lambda r: np.asarray(r.status).shape == (4,) and
             abs(float(r.obj[0]) - relax) <= 1e-6),
            ("custom_brancher", dict(node_batch=8, log=False, **cuda),
             lambda r: set(r) == {"maxvio", "lexico", "random"} and
             np.ptp([ub for ub, _ in r.values()]) < 1e-5),
            ("reliability_branching_demo", dict(log=False, **cuda),
             lambda r: r[0] == ok and r[2] > 0),
            ("checkpoint_resume", dict(path=nl, log_level=1, **cuda),
             lambda b: abs(b.ub - opt) <= 1e-4),
            ("solve_nl", dict(path=nl, **cuda),
             lambda b: b.status == ok and
             abs(b.ub - opt) <= 1e-6 * (1 + abs(opt)) and
             b.lb <= opt + 1e-6 * (1 + abs(opt))),
            ("nl_roundtrip", dict(path=nl), lambda p: p.n_vars > 0),
            ("expr_dag_demo", dict(log=False, **cuda),
             lambda r: abs(r[0] - (np.exp(0.5) + 2.0)) <= 1e-10 and
             abs(r[1][2] - 0.5) <= 1e-10),
            ("polynomial_demo", {}, lambda p: p.degree() == 3),
            ("quad_socp", dict(node_batch=4, log=False, **cuda),
             lambda b: abs(b.ub + 4.0) <= 1e-5),
            ("qpd_processor_demo", dict(path=nl, log=False, **cuda),
             lambda r: r[0] == ok and abs(r[1] - opt) < 1e-4 and r[2] > 0),
            ("qpdive_demo", dict(log=False, **cuda),
             lambda c: bool(c) and np.isfinite(c[0][1])),
            ("simple_qg", dict(node_batch=4, log_level=1, **cuda),
             lambda b: b.ub < 1e19),
            ("outer_approx", dict(node_batch=4, log_level=1, **cuda),
             lambda b: abs(b.ub - 0.25) <= 1e-5),
            ("multistart_demo", dict(log_level=1, **cuda),
             lambda b: b.ub <= -0.95),
            ("benders_demo", dict(log=False, **cuda),
             lambda r: abs(r[1] - benders_best()) <= 1e-5 * abs(r[1])),
            ("water_network", dict(log=False, **cuda),
             lambda b: b.lb <= -400.0 + 1e-4 and abs(b.ub + 400.0) <= 1e-3),
            ("simple_glob", dict(node_batch=4, log_level=1, **cuda),
             lambda b: abs(b.ub + 4.0) <= 1e-4),
            ("bilinear_demo", dict(node_batch=BILINEAR_BATCH, log=False,
                                   **cuda),
             lambda b: b.ub < 1e19 and b.lb <= b.ub + 1e-6),
            ("multilinear_demo", dict(node_batch=4, log_level=1, **cuda),
             lambda b: b.ub < 1e19),
            ("rlt_demo", dict(log=False, **cuda),
             lambda o: o[(12, 1)][1] > o[(0, 1)][1] + 0.5 and
             o[(12, 30)][1] >= o[(0, 30)][1] - 1e-6),
        )
        seconds = {}
        for name, kw, holds in cases:
            t0 = time.monotonic()
            # the scripts print their results: keep them off this stdout
            with contextlib.redirect_stdout(sys.stderr):
                out = mod(name).main(**kw)
            seconds[name] = round(time.monotonic() - t0, 2)
            check(holds(out), f"example {name}: its assertions fail")
            say(f"[14] example {name} on {kw.get('device', 'the host')}: "
                f"assertions hold, {seconds[name]:.2f} s")
    gallery = [f for f in os.listdir(os.path.dirname(mod("simple_bnb").__file__))
               if f.endswith(".py") and f != "__init__.py"]
    check(len(seconds) == len(gallery), "an example of the gallery was not run")
    say(f"[14] {len(seconds)} examples, {sum(seconds.values()):.1f} s")


def phase_tools(record):
    """15a-d: the ports of the root tools on the card, every kernel of
    the path launched: run_sweep (mbnb, mqg, moa) on three suite rows
    against their oracles, ab_qpd on its stand-in and qknap12, dist_sweep
    at P = 1, 2, 4 on correlated_knapsack(30, 1), and graft_entry's entry
    and dry run."""
    import csv

    import numpy as np
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch import graft_entry
    from minotaur_tpu_torch.io.nl_writer import write_nl
    from minotaur_tpu_torch.models.convex_suite import SUITE
    from minotaur_tpu_torch.models.generators import (correlated_knapsack,
                                                      knapsack_dp_optimum,
                                                      quadratic_knapsack)
    from minotaur_tpu_torch.tools import ab_qpd, dist_sweep, run_sweep

    mdev.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        # 15a: the .nl sweep, each solver over the three rows
        known = {name: float(SUITE[name][1]()) for name in TOOLS["sweep_rows"]}
        nl_dir = os.path.join(tmp, "nl")
        os.makedirs(nl_dir)
        for name in known:
            write_nl(SUITE[name][0](), os.path.join(nl_dir, name + ".nl"))
        sol = os.path.join(tmp, "known.csv")
        with open(sol, "w") as fh:
            fh.writelines(f"{k},{v!r}\n" for k, v in known.items())
        parts = []
        for solver in sorted(run_sweep.SOLVERS):
            out = os.path.join(tmp, solver + ".csv")
            t0 = time.monotonic()
            with tool_output_to_stderr():
                rc = run_sweep.main([nl_dir, "--solver", solver, "--time",
                                     str(TOOLS["sweep_time"]), "--out", out,
                                     "--solutions", sol, "--device",
                                     DEVICE])
            dt = time.monotonic() - t0
            check(rc == 0, f"15a run_sweep --solver {solver} exited {rc}")
            with open(out) as fh:
                rows = list(csv.reader(fh))
            check(tuple(rows[0]) == run_sweep.COLUMNS,
                  f"15a columns {rows[0]}")
            check(sorted(r[0] for r in rows[1:]) == sorted(known),
                  f"15a rows {rows[1:]}")
            cells = []
            for name, status, ub, lb, _, nodes, wall, dev in rows[1:]:
                opt, ub, lb = known[name], float(ub), float(lb)
                tol = 1e-6 * (1 + abs(opt))
                check(lb <= opt + tol and opt <= ub + tol,
                      f"15a {solver} {name} unsound: lb {lb} opt {opt} "
                      f"ub {ub}")
                check(abs(float(dev)) <= 1e-5 * max(1.0, abs(opt)),
                      f"15a {solver} {name}: dev_from_known {dev}")
                cells.append(f"{name} {status} ub {ub:.10g} nodes {nodes} "
                             f"{wall} s")
            parts.append(f"{solver} ({dt:.1f} s): " + ", ".join(cells))
        say("[15a] run_sweep on the card, every row sound and within 1e-5 "
            "of its optimum: " + "; ".join(parts))

        # 15b: the QPD A/B on its stand-in (QPD active) and on qknap12
        stand_in = ab_qpd.cases()
        name = next(iter(stand_in))
        lines = []
        for label, mk, active in ((name, stand_in[name], True), (
                "qknap12", lambda: quadratic_knapsack(12, density=0.4,
                                                      seed=3), False)):
            r = {proc: ab_qpd.run(mk, proc, device=DEVICE)
                 for proc in ab_qpd.PROCS}
            for proc, x in r.items():
                check(x["status"] == "SOLVED_OPTIMAL",
                      f"15b {label} {proc}: {x}")
            check(abs(r["pcb"]["ub"] - r["qpd"]["ub"]) <=
                  1e-6 * (1 + abs(r["pcb"]["ub"])),
                  f"15b {label}: pcb {r['pcb']} vs qpd {r['qpd']}")
            check((r["qpd"]["qpd_verified"] > 0) == active,
                  f"15b {label}: qpd verified {r['qpd']['qpd_verified']}")
            lines.append(f"{label}: " + ", ".join(
                f"{proc} {x['status']} nodes {x['nodes']} {x['wall']} s "
                f"ub {x['ub']} verified {x['qpd_verified']}"
                for proc, x in r.items()))
        say("[15b] ab_qpd: " + "; ".join(lines))

        # 15c: the partition-count sweep on one card
        knap = TOOLS["knap"]
        dp = knapsack_dp_optimum(*knap)
        path = os.path.join(tmp, "cknap30.nl")
        write_nl(correlated_knapsack(*knap), path)
        devices = dist_sweep.default_devices(DEVICE)
        with tool_output_to_stderr():
            rows = dist_sweep.sweep([path], devices, TOOLS["max_parts"],
                                    node_batch=TOOLS["node_batch"])
        check([r["parts"] for r in rows] ==
              dist_sweep.part_counts(TOOLS["max_parts"]),
              f"15c partition counts {[r['parts'] for r in rows]}")
        for r in rows:
            check(r["status"] == "SOLVED_OPTIMAL" and
                  abs(r["ub"] - dp) <= 1e-6 * (1 + abs(dp)),
                  f"15c P={r['parts']}: {r['status']} ub {r['ub']} DP {dp}")
            per = [int(c) for c in r["per_part_nodes"].split("|")]
            check(sum(per) == r["nodes"],
                  f"15c P={r['parts']}: partitions {per} vs {r['nodes']}")
        record["dist_sweep"] = rows
        say(f"[15c] dist_sweep correlated_knapsack{knap} node_batch "
            f"{TOOLS['node_batch']} on {devices} (DP {dp:.10g}): " +
            "; ".join(
                f"P={r['parts']} {r['status']} nodes {r['nodes']} in "
                f"{r['wall_s']} s = {r['nodes_per_s']} nodes/s, "
                f"{r['supersteps']} supersteps = "
                f"{r['wall_s'] / max(1, r['supersteps']):.3f} s a superstep, "
                f"rebalances {r['rebalances']}, migrated {r['migrated']}, "
                f"per partition {r['per_part_nodes']}" for r in rows))

    # 15d: graft_entry: the superstep once, then the dry run
    fn, args = graft_entry.entry(DEVICE)
    t0 = time.monotonic()
    out = fn(*args)
    objs = out.obj.cpu().numpy()
    dt = time.monotonic() - t0
    check(out.status.cpu().tolist() == [1] * 8 and np.isfinite(objs).all(),
          f"15d entry: statuses {out.status.tolist()} objs {objs}")
    say(f"[15d] graft_entry.entry(): 8 lanes OPTIMAL in {dt:.2f} s, obj "
        f"{np.round(objs, 4).tolist()}")
    t0 = time.monotonic()
    n_dev = len(devices)                # torch.cuda.device_count()
    with tool_output_to_stderr():
        graft_entry.dryrun_multichip(n_dev, DEVICE)
    say(f"[15d] graft_entry.dryrun_multichip({n_dev}) passed its checks "
        f"in {time.monotonic() - t0:.1f} s (its lines on stderr)")
    counts = mdev.launch_counts()
    for name, cnt in counts.items():
        check(cnt > 0, f"kernel {name} was not launched by phase 15")
    record["tools_launches"] = counts
    say(f"[15] launches in 15a-d: {counts}")


def phase_microbench(record):
    """15e: the three op-cost microbenchmarks (K1 launched by
    microbench_inv, outside the counts of the path's run)."""
    from minotaur_tpu_torch.tools import (microbench_calib, microbench_inv,
                                          microbench_tailops)
    from minotaur_tpu_torch.device import resolve_device
    from minotaur_tpu_torch.tools.timing import card_clocks
    dev = resolve_device(DEVICE)
    t0 = time.monotonic()
    say(f"[15e] clocks before: {card_clocks(dev)}")
    out = {}
    for name, mod in (("inv", microbench_inv), ("tailops", microbench_tailops),
                      ("calib", microbench_calib)):
        out[name] = mod.run(device=DEVICE)
    say(f"[15e] clocks after: {card_clocks(dev)}")
    for r in out["inv"]:
        say(f"[15e] inv ({r['B']},{r['n']},{r['n']}) {r['dtype']} "
            f"{r['name']}: {r['ms']:.4f} ms, |residual| {r['residual']:.3g}"
            + (f", launches {r['launches']}" if "launches" in r else ""))
    for key in ("tailops", "calib"):
        for r in out[key]:
            val = (f"{r['ms']:.5f} ms ({r['clock']})" +
                   (f" {r['tflops']:.2f} TFLOP/s" if "tflops" in r else "")
                   if "ms" in r else f"{r['rel_err']:.3g}")
            say(f"[15e] {key} {r['name']}: {val}")
    record["microbench"] = out
    say(f"[15e] microbenchmarks in {time.monotonic() - t0:.1f} s")


def tool_output_to_stderr():
    """The tools print their tables: keep them off this stdout."""
    import contextlib
    return contextlib.redirect_stdout(sys.stderr)


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
    seconds = {}
    for phase in (phase_k1, phase_k2, phase_ipm, phase_main_path,
                  phase_nl_kernels, phase_nl_ipm, phase_nl_bnb, phase_cli,
                  phase_qg_small, phase_qg_kernels, phase_qg_full,
                  phase_qg_cli, phase_f32_path, phase_qpd,
                  phase_ckpt_sos_weak, phase_glob_step, phase_glob_full,
                  phase_glob_cli, phase_glob_obbt, phase_dist_step,
                  phase_dist_qg, phase_dist_kernels, phase_dist_cli,
                  phase_device_tree, phase_bench, phase_examples,
                  phase_tools, phase_microbench):
        t0 = time.monotonic()
        phase(record)
        seconds[phase.__name__[6:]] = round(time.monotonic() - t0, 1)
    say(f"[t] wall s by phase: {seconds}")
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
               "qg_launches": int(record["qg_launches"][name]),
               "f32_launches": int(record["f32_launches"][name]),
               "obbt_launches": int(record["obbt_launches"][name]),
               "qpd_launches": int(record["qpd_launches"][name]),
               "glob_step_launches": int(
                   record["glob_step_launches"][name]),
               "glob_launches": int(record["glob_launches"][name]),
               "glob_obbt_launches": int(
                   record["glob_obbt_launches"][name]),
               "dist_launches": int(record["dist_launches"][name]),
               "device_tree_launches": int(
                   record["device_tree_launches"][name]),
               "bench_launches": int(record["bench_launches"][name]),
               "tools_launches": int(record["tools_launches"][name])}
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
