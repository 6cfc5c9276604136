"""mmultistart: multistart B&B for nonconvex (MI)NLP.

Reference: src/solvers/{MultiStartMain.cpp,MultiStart.cpp,MsBnb.cpp} with
MsProcessor (`msbnb_*` options).  Continuous problems get a pure batched
multistart; integer problems run B&B seeded with a multistart incumbent.

    python -m minotaur_tpu_torch.solvers.mmultistart instance.nl [--options]

Port of minotaur_tpu/solvers/mmultistart.py.  Runs on the first CUDA device;
`main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np

from ..bnb.bnb import BranchAndBound
from ..bnb.multistart import multistart_solve
from ..engines.staging import stage_problem
from ..utils.types import SolveStatus
from .base import Solver


class MultiStart(Solver):
    name = "mmultistart"

    def solve(self) -> int:
        log = self.env.logger
        sp = stage_problem(self.problem)
        n_starts = max(8, int(self.env.options.get("node_batch")))
        seed = int(self.env.options.get("rand_seed"))
        x, obj, info = multistart_solve(sp, self.problem,
                                        n_starts=n_starts, seed=seed,
                                        device=self.device)
        log.info(f"multistart: {info['n_feasible']}/{info['n_starts']} "
                 f"feasible local solves, "
                 f"{info['distinct_objs']} distinct optima")
        if self.problem.n_ints() == 0:
            status = (SolveStatus.SOLVED_OPTIMAL if x is not None
                      else SolveStatus.SOLVED_INFEASIBLE)
            self.write_solution(status, obj, x)
            return 0
        from ..bnb.multistart import MsBranchAndBound
        is_nl = (sp.obj_nl is not None or len(sp.nl_rows) > 0 or
                 sp.Qobj is not None)
        cls = MsBranchAndBound if is_nl else BranchAndBound
        bab = cls(self.problem, env=self.env, staged=sp,
                  device=self.device)
        if x is not None:
            # seed the tree with the multistart incumbent if it is
            # integer-feasible after rounding
            xr = x.copy()
            xr[sp.int_mask] = np.round(xr[sp.int_mask])
            if self.problem.is_feasible(xr, atol=1e-5):
                bab.ub = float(self.problem.eval_objective(xr))
                bab.best_x = xr
        status = bab.solve()
        log.info(f"nodes: {bab.stats.nodes_processed}  "
                 f"time: {bab.stats.time:.2f}s  lb: {bab.lb:.10g}")
        self.write_solution(status, bab.ub, bab.best_x)
        return 0


def main(argv=None, device="cuda") -> int:
    return MultiStart(device=device).main(argv)


if __name__ == "__main__":
    sys.exit(main())
