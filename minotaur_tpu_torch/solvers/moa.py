"""moa: multi-tree Outer Approximation for convex MINLP.

Reference: src/solvers/OA.cpp (`moa`, commented out of the reference's
CMake but shipped; OA.cpp:457-624).

    python -m minotaur_tpu_torch.solvers.moa instance.nl [--options]

Port of minotaur_tpu/solvers/moa.py.  Runs on the first CUDA device;
`main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import sys

from ..bnb.oa import OABranchAndBound
from .base import Solver


class OA(Solver):
    name = "moa"

    def solve(self) -> int:
        bab = OABranchAndBound(self.problem, env=self.env,
                               device=self.device)
        status = bab.solve()
        log = self.env.logger
        s = bab.oa_stats
        log.info(f"major iterations: {s.major_iters}  milp nodes: "
                 f"{s.milp_nodes}  nlp solves: {s.nlp_solves}  "
                 f"cuts: {s.cuts_added}")
        log.info(f"lower bound: {bab.lb:.10g}  upper bound: {bab.ub:.10g}")
        self.write_solution(status, bab.ub, bab.best_x)
        return 0


def main(argv=None, device="cuda") -> int:
    return OA(device=device).main(argv)


if __name__ == "__main__":
    sys.exit(main())
