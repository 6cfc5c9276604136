"""Example: solve just the root relaxation of an instance, then enable
an extra row and re-solve.

Reference analogues: examples/root-relaxation (solve the continuous
relaxation, print the bound) and examples/root-relax-cut (add a cut row
and resolve).  Rows are DATA — the matrix and bounds are arguments of
the batched solver, so enabling a row reuses the same solver (no
rebuild, unlike re-loading an Osi LP).

The demo row is the down-branch restriction x_j <= floor(x_j*) on the
most fractional integer — the first thing a B&B would try — showing how
branching, like cutting, is a pure array edit here.

    python -m minotaur_tpu_torch.examples.root_relaxation instance.nl
"""

import dataclasses
import sys

import numpy as np

from minotaur_tpu_torch.engines.ipm import build_batch_solver
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.io.nl_reader import read_nl


def main(path, log=True, device="cuda"):
    p = read_nl(path)
    sp = stage_problem(p)

    # one preallocated, initially-disabled extra row: bounds (-inf, inf)
    A = np.vstack([sp.A, np.zeros((1, sp.n))])
    clb = np.concatenate([sp.clb, [-np.inf]])
    cub = np.concatenate([sp.cub, [np.inf]])
    sp2 = dataclasses.replace(sp, m=sp.m + 1, A=A, clb=clb, cub=cub)
    solve = build_batch_solver(sp2, device=device)

    res = solve(A, clb, cub, sp.vlb[None, :], sp.vub[None, :])
    obj0 = float(res.obj[0])
    x0 = np.asarray(res.x[0])
    if log:
        print(f"root relaxation: obj {obj0:.8g}  status "
              f"{int(res.status[0])}")
        print(f"row duals: {np.asarray(res.y[0])[:sp.m]}")

    ints = np.where(sp.int_mask)[0]
    fr = np.abs(x0[ints] - np.round(x0[ints]))
    j = int(ints[np.argmax(fr)])
    A[-1, j] = 1.0
    cub[-1] = np.floor(x0[j])
    res2 = solve(A, clb, cub, sp.vlb[None, :], sp.vub[None, :])
    obj1 = float(res2.obj[0])
    if log:
        print(f"after enabling row x[{j}] <= {cub[-1]:g}: obj {obj1:.8g} "
              f"(bound moved {obj1 - obj0:+.4g})")
    return obj0, obj1


if __name__ == "__main__":
    main(sys.argv[1])
