"""Microbenchmark: the IPM tail iteration's non-kernel ops and their
alternatives.

Port of scripts/microbench_tailops.py, at B = 64 lanes, n = 300:

- the batched per-lane masked f64 matvec (B,n,n)@(B,n) (the defect-
  correction products against per-lane masked operators), against the
  mask-factored shared f64 matvec mask * ((mask * v) @ W') (one shared
  (B,n)@(n,n) product), and the split-f32 shared matvec: W = W_hi + W_lo
  and v = v_hi + v_lo in float32, three float32 products and float64
  combines, with its error against float64;
- the batched f32 matvec as einsum and as matmul with a trailing unit
  axis, and the matrix right-hand side product at k = 64;
- the masked (B,n,n) builds in f64 and f32.

The inputs are the JAX script's seeded draws.  Each row gives ms per
call (CUDA events around back-to-back calls, the median of several
windows; the host clock on the CPU).  On CUDA the float32 products must
run in full float32, as the IPM requires (`device.check_fp32_matmul`):
the split-f32 error printed is then float32's, not TF32's.

    python -m minotaur_tpu_torch.tools.microbench_tailops [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import List

import numpy as np

B, N, M_ROWS, K_RHS = 64, 300, 189, 64


def make_inputs(B: int, n: int, m: int, k: int, device, seed: int = 0):
    """The JAX script's draws, in its order, as tensors on `device`."""
    import torch
    rng = np.random.default_rng(seed)
    W64 = rng.standard_normal((n, n))
    W64 = W64 + W64.T
    rng.standard_normal((m, n))      # the script's unused row matrix
    Mb = rng.standard_normal((B, n, n)).astype(np.float32)
    v64 = rng.standard_normal((B, n))
    mask = rng.random((B, n)) > 0.1
    R32 = rng.standard_normal((B, n, k)).astype(np.float32)
    W32 = W64.astype(np.float32)
    Wlo = (W64 - W32.astype(np.float64)).astype(np.float32)
    Wb64 = np.where(mask[:, :, None] & mask[:, None, :], W64[None], 0.0)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return dict(W64=t(W64), W32=t(W32), Wlo=t(Wlo), Mb=t(Mb), Wb64=t(Wb64),
                v=t(v64), v32=t(v64.astype(np.float32)),
                mask=t(mask.astype(np.float64)),
                mask32=t(mask.astype(np.float32)), R32=t(R32))


def split_mv(hi, lo, v, mk):
    """mask * (W @ (mask * v)) from W = hi + lo, v split the same way:
    three float32 products, float64 combines."""
    import torch
    v = v * mk
    vh = v.to(torch.float32)
    vl = (v - vh.to(torch.float64)).to(torch.float32)
    main = vh @ hi.T
    corr = vl @ hi.T + vh @ lo.T
    return mk * (main.to(torch.float64) + corr.to(torch.float64))


def ops(x):
    """name -> zero-argument callable on the inputs `x`."""
    import torch
    mk, mk32 = x["mask"], x["mask32"]
    return {
        "batched f64 (B,n,n)@(B,n)": lambda: torch.einsum(
            "bij,bj->bi", x["Wb64"], x["v"]),
        "shared f64 (B,n)@(n,n)": lambda: mk * ((x["v"] * mk) @ x["W64"].T),
        "split-f32 shared matvec": lambda: split_mv(x["W32"], x["Wlo"],
                                                    x["v"], mk),
        "batched f32 einsum mv": lambda: torch.einsum(
            "bij,bj->bi", x["Mb"], x["v32"]),
        "batched f32 matmul[...,None]": lambda: (
            x["Mb"] @ x["v32"][..., None])[..., 0],
        f"batched f32 matmat k={x['R32'].shape[-1]}": lambda: x["Mb"] @ x["R32"],
        "f64 (B,n,n) masked build": lambda: torch.where(
            (mk[:, :, None] * mk[:, None, :]) > 0, x["W64"][None], 0.0),
        "f32 (B,n,n) masked build": lambda: torch.where(
            (mk32[:, :, None] * mk32[:, None, :]) > 0, x["W32"][None], 0.0),
    }


def split_error(x) -> float:
    """max |split-f32 - f64| / max |f64| of the mask-factored matvec."""
    want = x["mask"] * ((x["v"] * x["mask"]) @ x["W64"].T)
    got = split_mv(x["W32"], x["Wlo"], x["v"], x["mask"])
    return float((got - want).abs().max() / want.abs().max())


def run(B: int = B, n: int = N, m: int = M_ROWS, k: int = K_RHS,
        device="cuda", calls: int = 20, reps: int = 5) -> List[dict]:
    """One row per op (name, ms, clock), then the split-f32 error row."""
    from ..device import check_fp32_matmul, resolve_device
    from .timing import clock_name, time_ms
    dev = resolve_device(device)
    check_fp32_matmul(dev)
    x = make_inputs(B, n, m, k, dev)
    rows = [dict(name=name, B=B, n=n, ms=time_ms(fn, dev, calls, reps),
                 clock=clock_name(dev)) for name, fn in ops(x).items()]
    rows.append(dict(name="split-f32 vs f64 rel err", B=B, n=n,
                     rel_err=split_error(x)))
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m minotaur_tpu_torch.tools.microbench_tailops",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from ..bench import card_name
    from ..device import resolve_device
    dev = resolve_device(args.device)
    print(f"card: {card_name(dev)}", flush=True)
    rows = run(device=dev)
    for r in rows:
        if "ms" in r:
            print(f"{r['name']:30s} {r['ms']:9.4f} ms ({r['clock']})",
                  flush=True)
        else:
            print(f"{r['name']:30s} {r['rel_err']:.3g}", flush=True)
    print(json.dumps({"microbench_tailops": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
