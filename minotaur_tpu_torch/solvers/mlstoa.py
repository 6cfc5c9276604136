"""mlstoa: single-tree outer approximation with lazy cuts.

Reference: src/solvers/LSTOA.cpp + STOAHandler.{h,cpp} — single-tree OA
driven by CPLEX lazy-constraint callbacks (the reference does not build
this binary either; see src/CMakeLists.txt:484-494).

Batch-native note: our QG branch-and-cut IS single-tree lazy-cut OA — the
preallocated in-master cut pool plays the role of the callback-added
lazy constraints, and cuts at integral LP solutions are exactly the
STOA separation.  This entry point therefore runs the QG stack under
the mlstoa name with LSTOA-flavored defaults (cuts only where violation
persists: max_vio_per=1 when the user did not set it).

    python -m minotaur_tpu_torch.solvers.mlstoa instance.nl [--options]

Port of minotaur_tpu/solvers/mlstoa.py.  Runs on the first CUDA device;
`main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import sys

from ..bnb.qg import QGBranchAndBound
from .base import Solver


class LSTOA(Solver):
    name = "mlstoa"

    def solve(self) -> int:
        if not self.env.options.find("max_vio_per").was_set:
            self.env.set_option("max_vio_per", 1.0)
        bab = QGBranchAndBound(self.problem, env=self.env,
                               device=self.device)
        status = bab.solve()
        log = self.env.logger
        s = bab.qg_stats
        log.info(f"nodes: {bab.stats.nodes_processed}  "
                 f"lazy cuts: {s.cuts_added}  nlp solves: {s.nlp_solves} "
                 f"(feasible {s.nlp_feasible})  time: {bab.stats.time:.2f}s")
        log.info(f"lower bound: {bab.lb:.10g}  upper bound: {bab.ub:.10g}")
        self.write_solution(status, bab.ub, bab.best_x)
        return 0


def main(argv=None, device="cuda") -> int:
    return LSTOA(device=device).main(argv)


if __name__ == "__main__":
    sys.exit(main())
