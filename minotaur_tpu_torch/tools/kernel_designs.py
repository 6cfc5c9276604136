"""K1 and K2 under each of their designs, at the shapes the port's paths
give them, on one CUDA card.

For each shape it runs the kernel under its one-CTA design and under each
cluster size, checks every design against the kernel's plain version
(flags equal and values within 5e-5 / 1e-5 relative for f32 factors,
1e-11 for f64) and against the one-CTA design bit for bit (a row that
fails a check carries `fault`, and the exit code is 1; a cluster size the
card cannot place carries `error`), and times each
design, the plain version and, for K1, `torch.linalg.inv_ex`: K1 by CUDA
events around back-to-back calls (median of windows), K2 by a replayed
CUDA graph (device time).  It prints one JSON line a shape with the
design the launcher picks (`auto`), the times by design, and the bound
(operations over the card's peak or bytes over 3.35 TB/s, the larger).
These are the times that set the designs' thresholds (the header note of
each kernel's source, csrc/spd_inverse.cuh and csrc/spd_solve.cuh).

Usage: python -m minotaur_tpu_torch.tools.kernel_designs [--only k1|k2]
       [--out FILE]   (needs a CUDA card; the JSON lines also go to FILE)
"""

from __future__ import annotations

import argparse
import json
import sys

from minotaur_tpu_torch.tools.timing import card_clocks, graph_ms, time_ms

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12        # f32 CUDA cores; f64 tensor cores (H100 SXM)

# (B, k, dtype): the table's rows (main path, partitions, QG master, glob,
# NL), then orders between 300 and 1024 that place the threshold
K1_SHAPES = [(64, 300, "f32"), (64, 300, "f64"), (16, 1024, "f32"),
             (64, 1024, "f32"), (64, 1378, "f32"), (64, 1024, "f64"),
             (16, 300, "f32"), (64, 416, "f32"), (64, 512, "f32"),
             (64, 640, "f32"), (16, 512, "f32"), (64, 512, "f64"),
             (64, 384, "f32")]
# (B, k, factor, operator, refine steps): the main path's call (refine 0,
# the row-block grid whatever the cluster argument) and the IPM's refining
# calls (f32 factor and operator with f64 r and x; the NL path's f64),
# then orders from 128 to 512 that place the threshold, then odd orders
# (f32 rows that start 4 bytes off on every other row): the QKP lane's
# 1339 and orders about the threshold
K2_SHAPES = [(64, 300, "f32", 0), (64, 1378, "f32", 2), (16, 1024, "f32", 2),
             (64, 1024, "f32", 2), (64, 1024, "f64", 3),
             (64, 128, "f32", 2), (64, 192, "f32", 2), (64, 256, "f32", 2),
             (64, 300, "f32", 2), (64, 256, "f64", 3), (64, 300, "f64", 3),
             (16, 128, "f32", 2), (16, 192, "f32", 2), (16, 256, "f32", 2),
             (16, 300, "f32", 2), (64, 512, "f32", 2), (16, 512, "f32", 2),
             (64, 1339, "f32", 2), (16, 1339, "f32", 2), (64, 1377, "f32", 2),
             (64, 193, "f32", 2), (16, 193, "f32", 2), (64, 257, "f32", 2),
             (16, 257, "f32", 2), (64, 301, "f32", 2)]
# one CTA a lane, then the cluster sizes the launchers take (C = 8 lost to
# C = 4 at B = 16: the header notes)
CLUSTERS = (1, 2, 4)


def _bound_ms(flops, nbytes):
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_S) * 1e3


def k1_row(B, k, dt, clusters=CLUSTERS):
    import torch
    from minotaur_tpu_torch.ops.spd_inverse import (spd_inverse_cuda,
                                                    spd_inverse_design,
                                                    spd_inverse_plain)
    dtype = torch.float32 if dt == "f32" else torch.float64
    dev = torch.device("cuda")
    g = torch.Generator(device="cuda").manual_seed(1000 * k + B)
    A = torch.randn((B, k, k), generator=g, dtype=torch.float64,
                    device="cuda")
    ms = (A @ A.transpose(1, 2) / k + 2.0 * torch.eye(
        k, dtype=torch.float64, device="cuda")).to(dtype)
    del A
    pminv, pflag = spd_inverse_plain(ms)
    ref = None
    tol = 5e-5 if dt == "f32" else 1e-11
    calls = 3 if k >= 1000 else 10
    row = {"kernel": "K1", "B": B, "k": k, "dtype": dt,
           "auto": spd_inverse_design(B, k), "ms": {}, "max_rel_err": {}}
    for C in clusters:
        try:
            minv, flag = spd_inverse_cuda(ms, C)
            torch.cuda.synchronize()
        except RuntimeError as exc:     # a cluster size the card cannot place
            row.setdefault("error", {})[C] = str(exc)
            continue
        err = ((minv - pminv).abs().max() / pminv.abs().max()).item()
        bad = [what for what, ok in (
            ("flags differ from plain", torch.equal(flag, pflag)),
            (f"vs plain {err:.3g}", err <= tol),
            ("not the one-CTA bits", ref is None or torch.equal(minv, ref)))
            if not ok]
        if bad:
            row.setdefault("fault", {})[C] = bad
        if ref is None:
            ref = minv
        del minv, flag
        row["max_rel_err"][C] = err
        row["ms"][C] = time_ms(lambda: spd_inverse_cuda(ms, C), dev, calls,
                               reps=3)
    row["plain_ms"] = time_ms(lambda: spd_inverse_plain(ms), dev, calls,
                              reps=3)
    row["library_ms"] = time_ms(lambda: torch.linalg.inv_ex(ms), dev, calls,
                                reps=3)
    isz = ms.element_size()
    row["bound_ms"] = _bound_ms(B * k ** 3,
                                B * (k * (k + 1) // 2 + k * k) * isz)
    return row


def k2_row(B, k, dt, steps, clusters=CLUSTERS):
    import torch
    from minotaur_tpu_torch.ops.spd_inverse import spd_inverse_plain
    from minotaur_tpu_torch.ops.spd_solve import (spd_solve_cuda,
                                                  spd_solve_design,
                                                  spd_solve_plain)
    F64 = torch.float64
    dtype = torch.float32 if dt == "f32" else F64
    g = torch.Generator(device="cuda").manual_seed(1000 * k + B + 1)
    f64 = dict(dtype=F64, device="cuda")
    A = torch.randn((B, k, k), generator=g, **f64)
    M = A @ A.transpose(1, 2) + k * torch.eye(k, **f64)
    del A
    dinv = 1.0 / torch.diagonal(M, dim1=1, dim2=2).sqrt()
    Ms = (M * dinv[:, :, None] * dinv[:, None, :]).to(dtype)
    shift = 1e-3 * torch.rand((B, k), generator=g, **f64)
    minv = spd_inverse_plain(Ms)[0]
    del Ms
    r = torch.randn((B, k), generator=g, **f64)
    args = (minv, M.to(dtype), dinv.to(dtype), shift.to(dtype), r, steps, F64)
    del M
    px = spd_solve_plain(*args)
    tol = 1e-5 if dt == "f32" else 1e-11
    row = {"kernel": "K2", "B": B, "k": k, "dtype": dt, "refine": steps,
           "auto": spd_solve_design(B, k, 1, dtype, dtype, steps), "ms": {},
           "max_rel_err": {}}
    ref = None
    for C in clusters if steps else (0,):
        try:
            x = spd_solve_cuda(*args, cluster=C)
            torch.cuda.synchronize()
        except RuntimeError as exc:     # a cluster size the card cannot place
            row.setdefault("error", {})[C] = str(exc)
            continue
        err = ((x - px).abs().max() / px.abs().max()).item()
        bad = [what for what, ok in (
            (f"vs plain {err:.3g}", err <= tol),
            ("not the one-CTA bits", ref is None or torch.equal(x, ref)))
            if not ok]
        if bad:
            row.setdefault("fault", {})[C] = bad
        if ref is None:
            ref = x
        row["max_rel_err"][C] = err
        row["ms"][C] = graph_ms(lambda: spd_solve_cuda(*args, cluster=C),
                                reps=3)
    row["plain_ms"] = graph_ms(lambda: spd_solve_plain(*args), reps=3)
    isz = minv.element_size()
    prods = 2 + 2 * steps
    row["bound_ms"] = _bound_ms(2 * B * k * k * prods,
                                2 * B * k * k * isz + 4 * B * k * isz)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("k1", "k2"))
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_designs: needs a CUDA card", file=sys.stderr)
        return 2
    lines = [json.dumps({"card": card_clocks(torch.device("cuda", 0)),
                         "torch": torch.__version__})]
    print(lines[0], flush=True)
    rows = []
    if args.only != "k2":
        rows += [lambda s=s: k1_row(*s) for s in K1_SHAPES]
    if args.only != "k1":
        rows += [lambda s=s: k2_row(*s) for s in K2_SHAPES]
    faults = 0
    for make in rows:
        row = make()
        faults += "fault" in row
        line = json.dumps(row)
        lines.append(line)
        print(line, flush=True)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n")
    return 1 if faults else 0


if __name__ == "__main__":
    raise SystemExit(main())
