"""Where the time of the main path goes on one CUDA card.

Runs `BranchAndBound` on intquad(300, 4, 0) at the bench settings
(node_batch 64, pad_full 1, ipm_max_iters 28, ipm_tail_kkt_rounds 4,
ipm_refine_steps 0, ipm_chol_retry 0) and prints one JSON object:

- `runs`: the same capped search through the kernels and through their
  plain PyTorch versions, in the order kernel, plain, plain, kernel (so
  drift of the card or the host shows as spread), then once through the
  kernels under `dtype f64`.  Each run: status, nodes, seconds, nodes/s,
  IPM iterations (summed over lanes), KKT factorizations/s, lb, ub, and
  each kernel wrapper's launches.
- `profile` (mixed policy) and `profile_f64` (`dtype f64`): a shorter
  kernel run under torch.profiler: wall seconds, the union of device
  kernel intervals (device busy share under the profiler, which slows the
  host), the top device kernels by time, each port kernel's share of
  kernel time with its device launches beside the wrapper's count (K1
  is three device kernels per call, K2 one), the device kernels run just
  before and just after each of its launches (so a cast kernel around
  every K2 call would show), and the host's seconds blocked in CUDA
  synchronisation calls (what is left of the wall is the host's own
  work, during which the device runs queued kernels).

Usage: python -m minotaur_tpu_torch.tools.profile_bnb [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

BENCH_OPTIONS = (("node_batch", 64), ("pad_full", 1), ("ipm_max_iters", 28),
                 ("ipm_tail_kkt_rounds", 4), ("ipm_refine_steps", 0),
                 ("ipm_chol_retry", 0), ("bnb_time_limit", 600.0),
                 ("log_level", 1))
TIMED_NODES = 4096          # node cap of the timed runs
PROFILED_NODES = 640        # node cap of the profiled run (the profiler
                            # slows the host several-fold)
TOP = 12                    # device kernels listed
# CUDA runtime calls in which the host waits for the device
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


@contextlib.contextmanager
def plain_kernels():
    """Route the IPM through the kernels' plain versions (comparison runs
    only; the main path never takes this route)."""
    from minotaur_tpu_torch.engines import ipm
    from minotaur_tpu_torch.ops.spd_inverse import spd_inverse_plain
    from minotaur_tpu_torch.ops.spd_solve import spd_solve_plain
    saved = ipm.spd_inverse, ipm.spd_solve
    ipm.spd_inverse = spd_inverse_plain
    ipm.spd_solve = spd_solve_plain
    try:
        yield
    finally:
        ipm.spd_inverse, ipm.spd_solve = saved


def _neighbours(kern, name: str) -> dict:
    """For the device kernels whose name contains `name`: counts, by name,
    of the kernel run just before and just after each of them (the port
    uses one stream, so device order is launch order).  A cast kernel
    around every K2 launch would show here."""
    seq = sorted(kern, key=lambda e: e.time_range.start)
    out = {"before": {}, "after": {}}
    for i, e in enumerate(seq):
        if name not in e.name:
            continue
        for side, j in (("before", i - 1), ("after", i + 1)):
            if 0 <= j < len(seq):
                n = seq[j].name[:80]
                out[side][n] = out[side].get(n, 0) + 1
    return out


def solve_intquad300(nodes: int, dtype: str = "mixed", n: int = 300,
                     device: str = "cuda") -> dict:
    """One capped B&B search; returns its end-to-end numbers."""
    from minotaur_tpu_torch import device as mdev
    from minotaur_tpu_torch.bnb.bnb import BranchAndBound
    from minotaur_tpu_torch.models.convex_suite2 import intquad
    from minotaur_tpu_torch.utils.environment import Environment
    env = Environment()
    for k, v in BENCH_OPTIONS + (("bnb_node_limit", nodes), ("dtype", dtype)):
        env.set_option(k, v)
    bab = BranchAndBound(intquad(n, 4, 0), env, device=device)
    mdev.reset_launches()
    t0 = time.monotonic()
    st = bab.solve()
    dt = time.monotonic() - t0
    s = bab.stats
    return dict(status=st.name, nodes=s.nodes_processed, s=dt,
                nodes_per_s=s.nodes_processed / dt, ipm_iters=s.ipm_iters,
                kkt_fact_per_s=s.ipm_iters / dt, batches=s.batches,
                lb=float(bab.lb), ub=float(bab.ub),
                launches=mdev.launch_counts())


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def profile_run(nodes: int, dtype: str = "mixed") -> dict:
    """A kernel-path run under torch.profiler: device busy share, the top
    device kernels by total time, and the device kernels per wrapper
    call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from minotaur_tpu_torch import device as mdev
    mdev.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run = solve_intquad300(nodes, dtype)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_s = _union_us((e.time_range.start, e.time_range.end)
                       for e in kern) / 1e6
    by_name = {}
    for e in kern:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), c + 1)
    total = sum(t for t, _ in by_name.values())
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    launches = mdev.launch_counts()
    port = {}
    for kname in launches:
        mine = [(t, c, n) for n, (t, c) in by_name.items() if kname in n]
        calls = launches[kname]
        port[kname] = dict(
            ms=sum(t for t, _, _ in mine) / 1e3,
            share=sum(t for t, _, _ in mine) / total if total else None,
            device_launches={n[:80]: c for _, c, n in mine},
            wrapper_calls=calls,
            device_kernels_per_call=(sum(c for _, c, _ in mine) / calls
                                     if calls else None),
            neighbours=_neighbours(kern, kname))
    blocked_us = sum(e.time_range.elapsed_us() for e in events
                     if e.device_type == DeviceType.CPU and e.name in SYNC_CALLS)
    return dict(dtype=dtype, run=run, wall_s=wall, device_kernels=len(kern),
                device_busy_s=busy_s,
                device_busy_share=busy_s / wall if kern else None,
                kernel_time_s=total / 1e6,
                host_blocked_in_sync_s=blocked_us / 1e6,
                launches=launches, port_kernels=port,
                top=[dict(name=name[:120], ms=t / 1e3, count=c,
                          share=t / total) for name, (t, c) in rows])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_bnb: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    solve_intquad300(64)                 # build the kernels, warm up
    out = dict(card=card, nodes_cap=TIMED_NODES, runs=[])
    for label in ("kernel", "plain", "plain", "kernel", "kernel_f64"):
        ctx = plain_kernels() if label == "plain" else contextlib.nullcontext()
        with ctx:
            r = solve_intquad300(TIMED_NODES,
                                 "f64" if label == "kernel_f64" else "mixed")
        r["label"] = label
        print(json.dumps(r), flush=True)
        out["runs"].append(r)
    out["profile"] = profile_run(PROFILED_NODES)
    out["profile_f64"] = profile_run(PROFILED_NODES, "f64")
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
