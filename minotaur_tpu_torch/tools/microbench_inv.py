"""Microbenchmark: batched SPD inverse alternatives at the IPM's shapes.

Port of scripts/microbench_inv.py.  The IPM factors and inverts the
(B, n, n) condensed KKT matrix once an iteration (K1,
`ops/spd_inverse.py`).  This times the ways to get an n x n inverse, or
an equivalent solve operator, per lane:

  chol+cho_solve   torch.linalg.cholesky, then cholesky_solve on I
  lu_inv           torch.linalg.inv (LU)
  solve_eye        torch.linalg.solve(M, I)
  chol_only        the factorization alone (a floor for the chol paths)
  ns_refresh(2)    two Newton-Schulz steps X <- X (2I - M X) from a stale
                   inverse (two batched products a step)
  K1               the port's kernel (its plain version on the CPU)

at B = 64, n = 300 in float32 (the main path's shape) and B = 64,
n = 1024 in float64 (the NL path's).  The matrices are the JAX script's:
M = A A' / n + (1 + u) I from seeded normals, and a stale inverse, that
of M + 0.1 I.  Each row gives ms per call (CUDA events around
back-to-back calls, the median of several windows; the host clock on the
CPU) and the residual max |I - M X| in float64 (for chol_only,
max |M - L L'|).  On CUDA, float32 products must run in full float32
(the IPM's rule, `device.check_fp32_matmul`), and the tool raises if K1
was not launched.

    python -m minotaur_tpu_torch.tools.microbench_inv [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import List, Sequence, Tuple

import numpy as np

SHAPES = ((64, 300, "f32"), (64, 1024, "f64"))
ALTERNATIVES = ("chol+cho_solve", "lu_inv", "solve_eye", "chol_only",
                "ns_refresh(2)", "K1")


def make_inputs(B: int, n: int, dtype: str, device, seed: int = 0):
    """(M, stale inverse) on `device`: the JAX script's construction
    (scripts/microbench_inv.py:52-60), the products taken on the
    device."""
    import torch
    tdt = torch.float32 if dtype == "f32" else torch.float64
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, n, n))
    shift = 1.0 + rng.random((B, 1, 1))
    if dtype == "f32":
        a, shift = a.astype(np.float32), shift.astype(np.float32)
    A = torch.as_tensor(a, device=device)
    eye = torch.eye(n, dtype=tdt, device=device)
    M = A @ A.transpose(1, 2) / n + eye * torch.as_tensor(shift, device=device)
    stale = torch.linalg.inv((M + 0.1 * eye).double()).to(tdt)
    return M.contiguous(), stale.contiguous()


def alternatives(M, X):
    """name -> zero-argument callable computing that alternative on M."""
    import torch
    from ..ops.spd_inverse import spd_inverse
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device).expand_as(M)

    def ns2():
        Y = X
        for _ in range(2):
            Y = Y @ (2.0 * eye - M @ Y)
        return Y

    return {
        "chol+cho_solve": lambda: torch.cholesky_solve(
            eye, torch.linalg.cholesky(M)),
        "lu_inv": lambda: torch.linalg.inv(M),
        "solve_eye": lambda: torch.linalg.solve(M, eye),
        "chol_only": lambda: torch.linalg.cholesky(M),
        "ns_refresh(2)": ns2,
        "K1": lambda: spd_inverse(M)[0],
    }


def residual(name: str, M, out) -> float:
    """max |I - M X| in float64, or max |M - L L'| for chol_only."""
    import torch
    Md, Od = M.double(), out.double()
    if name == "chol_only":
        return float((Md - Od @ Od.transpose(1, 2)).abs().max())
    eye = torch.eye(M.shape[-1], dtype=torch.float64, device=M.device)
    return float((eye - Md @ Od).abs().max())


def run(shapes: Sequence[Tuple[int, int, str]] = SHAPES, device="cuda",
        calls: int = 10, reps: int = 5) -> List[dict]:
    """One row per (shape, alternative): name, B, n, dtype, ms, clock,
    residual; plus K1's launches on CUDA."""
    from ..device import check_fp32_matmul, resolve_device
    from ..ops.spd_inverse import spd_inverse
    from .timing import clock_name, time_ms
    dev = resolve_device(device)
    check_fp32_matmul(dev)
    rows = []
    for B, n, dtype in shapes:
        M, X = make_inputs(B, n, dtype, dev)
        before = spd_inverse.launches
        for name, fn in alternatives(M, X).items():
            ms = time_ms(fn, dev, calls, reps)
            rows.append(dict(name=name, B=B, n=n, dtype=dtype, ms=ms,
                             clock=clock_name(dev),
                             residual=residual(name, M, fn())))
        launched = spd_inverse.launches - before
        if dev.type == "cuda":
            if launched == 0:
                raise RuntimeError(f"K1 was not launched at ({B}, {n}, {n}) "
                                   f"{dtype}")
            rows[-1]["launches"] = launched
        del M, X
    return rows


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(
        prog="python -m minotaur_tpu_torch.tools.microbench_inv",
        description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    from ..bench import card_name
    from ..device import resolve_device
    dev = resolve_device(args.device)
    print(f"card: {card_name(dev)}", flush=True)
    rows = run(device=dev)
    for r in rows:
        print(f"({r['B']},{r['n']},{r['n']}) {r['dtype']} {r['name']:16s} "
              f"{r['ms']:9.4f} ms ({r['clock']})  |residual| "
              f"{r['residual']:.3g}", flush=True)
    print(json.dumps({"microbench_inv": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
