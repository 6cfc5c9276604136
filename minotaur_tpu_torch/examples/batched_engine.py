"""Example: direct use of the batched IPM engine.

Reference analogue: examples/simple-base and examples/root-relaxation
(load a problem into an engine, solve the relaxation, inspect duals).
The engine solves a whole BATCH of boxes in one batched call — the unit
of work is "many relaxations", not one.

    python -m minotaur_tpu_torch.examples.batched_engine instance.nl
"""

import sys

import numpy as np

from minotaur_tpu_torch.engines.ipm import build_batch_solver
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.io.nl_reader import read_nl


def main(path, batch=8, device="cuda"):
    p = read_nl(path)
    sp = stage_problem(p)
    solve = build_batch_solver(sp, device=device)

    # batch = the root box + progressively shrunk copies (as if branching)
    vlb = np.tile(sp.vlb, (batch, 1))
    vub = np.tile(sp.vub, (batch, 1))
    rng = np.random.default_rng(0)
    for b in range(1, batch):
        lo = np.where(np.isfinite(sp.vlb), sp.vlb, -10.0)
        hi = np.where(np.isfinite(sp.vub), sp.vub, 10.0)
        cut = rng.uniform(0.0, 0.4 * (hi - lo))
        vlb[b] = lo + cut * rng.integers(0, 2, sp.n)
        vub[b] = hi - cut * rng.integers(0, 2, sp.n)
        bad = vlb[b] > vub[b]
        vlb[b][bad], vub[b][bad] = vub[b][bad], vlb[b][bad]

    res = solve(sp.A, sp.clb, sp.cub, vlb, vub)
    print("status:", np.asarray(res.status))
    print("obj   :", np.round(np.asarray(res.obj), 6))
    print("dual  :", np.round(np.asarray(res.dual_bound), 6))
    return res


if __name__ == "__main__":
    main(sys.argv[1])
