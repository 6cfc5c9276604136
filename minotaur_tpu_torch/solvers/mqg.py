"""mqg: Quesada-Grossmann LP/NLP branch-and-cut for convex MINLP.

Reference: src/solvers/{QGMain.cpp,QG.{h,cpp}} (SURVEY.md §3.2).

    python -m minotaur_tpu_torch.solvers.mqg instance.nl [--options]

Port of minotaur_tpu/solvers/mqg.py.  Runs on the first CUDA device;
`main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import sys

from ..bnb.qg import QGBranchAndBound
from .base import Solver


class QG(Solver):
    name = "mqg"

    def solve(self) -> int:
        bab = QGBranchAndBound(self.problem, env=self.env,
                               device=self.device)
        status = bab.solve()
        log = self.env.logger
        s = bab.qg_stats
        log.info(f"nodes: {bab.stats.nodes_processed}  "
                 f"cuts: {s.cuts_added}  nlp solves: {s.nlp_solves} "
                 f"(feasible {s.nlp_feasible})  time: {bab.stats.time:.2f}s")
        log.info(f"lower bound: {bab.lb:.10g}  upper bound: {bab.ub:.10g}")
        self.write_solution(status, bab.ub, bab.best_x)
        return 0


def main(argv=None, device="cuda") -> int:
    return QG(device=device).main(argv)


if __name__ == "__main__":
    sys.exit(main())
