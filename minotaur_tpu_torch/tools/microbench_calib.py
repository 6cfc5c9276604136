"""Calibrate the card's op costs: peak matmul, the per-op overhead
floor, the IPM's small shapes, and the split-f32 matvec.

Port of scripts/microbench_calib.py:

1. a 2048^3 matmul in float32 at full precision, in float32 under TF32
   (enabled inside this tool only, and restored) and in bfloat16, with
   TFLOP/s;
2. the per-op floor: a chain of (256,) vector adds, timed two ways:
   eager launches by the host clock (each window ended by a
   synchronisation: what Python pays an op), and the same chain
   captured in one CUDA graph and replayed between CUDA events (the
   device's time alone).  Their difference is the host's dispatch cost
   of one op;
3. the IPM's shapes, B = 64, n = 300: the shared f32 (B,n)@(n,n)
   product, the batched f32 matvec, the batched f32 product at k = 128,
   the split-f32 shared matvec against the true f64 one (and the
   split's error), the batched f32 Cholesky and Cholesky plus
   cholesky_solve on I.

Each row gives ms per op (CUDA events around back-to-back calls, the
median of several windows; the host clock on the CPU, where the graph
rows are not measured).  The card's name, power limit and clocks are
printed before and after.

    python -m minotaur_tpu_torch.tools.microbench_calib [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import List

import numpy as np

PEAK_N, FLOOR_LEN, FLOOR_OPS = 2048, 256, 64
B, N, K_RHS = 64, 300, 128


@contextlib.contextmanager
def tf32():
    """TF32 matmuls inside the block only (the counterpart of the JAX
    script's DEFAULT precision); the IPM refuses them."""
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def _row(name, ms, clock, flops=None):
    r = dict(name=name, ms=ms, clock=clock)
    if flops:
        r["tflops"] = flops / (ms * 1e-3) / 1e12
    return r


def per_op_floor(a, ops: int = FLOOR_OPS, reps: int = 5) -> List[dict]:
    """The chain x <- x + a of `ops` adds on the float32 vector `a`:
    eager by the host clock, eager by CUDA events and one replayed CUDA
    graph, each per op; and the host dispatch cost an op (eager host
    minus graph)."""
    from .timing import clock_name, graph_ms, host_ms, time_ms
    dev, length = a.device, a.shape[0]
    x = a.clone()

    def chain():
        y = x
        for _ in range(ops):
            y = y + a
        return y

    label = f"vector add ({length},) chain of {ops}"
    eager_host = host_ms(chain, dev, 10, reps) / ops
    rows = [_row(f"{label}, eager, host clock", eager_host, "host")]
    if dev.type != "cuda":
        return rows
    rows.append(_row(f"{label}, eager, CUDA events",
                     time_ms(chain, dev, 10, reps) / ops, clock_name(dev)))
    graphed = graph_ms(chain, 10, reps) / ops
    rows.append(_row(f"{label}, one CUDA graph", graphed, clock_name(dev)))
    rows.append(dict(name="host dispatch an op (eager host - graph)",
                     ms=eager_host - graphed, clock="difference"))
    return rows


def split_mv(hi, lo, x):
    """W @ x' from W = hi + lo and x split the same way: three float32
    products, float64 combines."""
    import torch
    xh = x.to(torch.float32)
    xl = (x - xh.to(torch.float64)).to(torch.float32)
    main = xh @ hi.T
    corr = xl @ hi.T + xh @ lo.T
    return main.to(torch.float64) + corr.to(torch.float64)


def run(peak_n: int = PEAK_N, B: int = B, n: int = N, k: int = K_RHS,
        device="cuda", calls: int = 10, reps: int = 5) -> List[dict]:
    """Every row of the three parts, then the split-f32 error row."""
    import torch
    from ..device import check_fp32_matmul, resolve_device
    from .timing import clock_name, time_ms
    dev = resolve_device(device)
    check_fp32_matmul(dev)
    clock = clock_name(dev)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    timed = lambda fn: time_ms(fn, dev, calls, reps)  # noqa: E731
    rows = []

    # 1. peak matmul
    Ab = t(rng.standard_normal((peak_n, peak_n)).astype(np.float32))
    fl = 2 * peak_n ** 3
    rows.append(_row(f"f32 {peak_n}^3 matmul, full f32",
                     timed(lambda: Ab @ Ab), clock, fl))
    if dev.type == "cuda":
        with tf32():
            rows.append(_row(f"f32 {peak_n}^3 matmul, TF32",
                             timed(lambda: Ab @ Ab), clock, fl))
        check_fp32_matmul(dev)
    Bb = t(rng.standard_normal((peak_n, peak_n)).astype(np.float32)).to(
        torch.bfloat16)
    rows.append(_row(f"bf16 {peak_n}^3 matmul", timed(lambda: Bb @ Bb),
                     clock, fl))
    del Ab, Bb

    # 2. the per-op floor
    rows += per_op_floor(t(rng.standard_normal(FLOOR_LEN).astype(
        np.float32)), reps=reps)

    # 3. the IPM's shapes
    W32 = t(rng.standard_normal((n, n)).astype(np.float32))
    Vb = t(rng.standard_normal((B, n)).astype(np.float32))
    mv = 2 * B * n * n
    rows.append(_row("shared f32 (B,n)@(n,n)", timed(lambda: Vb @ W32),
                     clock, mv))
    Mb = t(rng.standard_normal((B, n, n)).astype(np.float32))
    rows.append(_row("batched f32 mv (B,n,n)@(B,n)", timed(
        lambda: torch.einsum("bij,bj->bi", Mb, Vb)), clock, mv))
    Vk = t(rng.standard_normal((B, n, k)).astype(np.float32))
    rows.append(_row(f"batched f32 matmat k={k}", timed(lambda: Mb @ Vk),
                     clock, mv * k))
    W64 = rng.standard_normal((n, n))
    v64 = rng.standard_normal((B, n))
    Wh = W64.astype(np.float32)
    Wl = (W64 - Wh.astype(np.float64)).astype(np.float32)
    Whd, Wld, vd, W64d = t(Wh), t(Wl), t(v64), t(W64)
    rows.append(_row("split-f32 shared mv", timed(
        lambda: split_mv(Whd, Wld, vd)), clock, 3 * mv))
    rows.append(_row("true f64 shared mv", timed(lambda: vd @ W64d.T),
                     clock, mv))
    Md = Mb @ Mb.transpose(1, 2) / n + 3.0 * torch.eye(n, device=dev)
    eye = torch.eye(n, device=dev).expand(B, n, n)
    rows.append(_row("batched f32 cholesky", timed(
        lambda: torch.linalg.cholesky(Md)), clock, B * n ** 3 / 3))
    rows.append(_row("chol + cholesky_solve(I)", timed(
        lambda: torch.cholesky_solve(eye, torch.linalg.cholesky(Md))),
        clock, 2 * B * n ** 3))
    want = vd @ W64d.T
    err = float((split_mv(Whd, Wld, vd) - want).abs().max() /
                want.abs().max())
    rows.append(dict(name="split-f32 rel err", rel_err=err))
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m minotaur_tpu_torch.tools.microbench_calib",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from ..bench import card_name
    from ..device import resolve_device
    from .timing import CLOCK_QUERY, card_clocks
    dev = resolve_device(args.device)
    print(f"card: {card_name(dev)}", flush=True)
    print(f"clocks before ({CLOCK_QUERY}): {card_clocks(dev)}", flush=True)
    rows = run(device=dev)
    print(f"clocks after: {card_clocks(dev)}", flush=True)
    for r in rows:
        if "ms" in r:
            extra = f"  {r['tflops']:8.2f} TFLOP/s" if "tflops" in r else ""
            print(f"{r['name']:44s} {r['ms']:10.5f} ms ({r['clock']}){extra}",
                  flush=True)
        else:
            print(f"{r['name']:44s} {r['rel_err']:.3g}", flush=True)
    print(json.dumps({"microbench_calib": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
