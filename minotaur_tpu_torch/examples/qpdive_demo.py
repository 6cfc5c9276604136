"""Example: QP-diving primal heuristic (qpdive analogue).

Reference analogue: examples/qpdive + QPDProcessor.cpp — dive through
integer fixings on a cheap quadratic model of the NLP instead of full
NLP solves.  Here a POPULATION of dives advances one batched QP solve
per depth (the reference dives one node at a time).

    python -m minotaur_tpu_torch.examples.qpdive_demo
"""

import numpy as np

from minotaur_tpu_torch.bnb.qpd import QPDiver
from minotaur_tpu_torch.engines.ipm import build_batch_solver
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.models.generators import convex_miqp


def main(lanes=8, log=True, device="cuda"):
    p = convex_miqp(n_cont=3, n_int=5, seed=0)
    sp = stage_problem(p)

    # root relaxation gives the reference point for the QP model
    solve = build_batch_solver(sp, device=device)
    res = solve(sp.A, sp.clb, sp.cub, sp.vlb[None, :], sp.vub[None, :])
    x0 = np.asarray(res.x[0])
    if log:
        print(f"root relaxation obj {float(res.obj[0]):.8g}")

    diver = QPDiver(p, sp, x_ref=x0, lanes=lanes, device=device)
    cands = diver.run(sp.vlb, sp.vub, x0)
    if log:
        for x, val in cands[:3]:
            print(f"feasible candidate: obj {val:.8g}")
        if not cands:
            print("no feasible candidate found")
    return cands


if __name__ == "__main__":
    main()
