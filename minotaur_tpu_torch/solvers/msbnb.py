"""msbnb: multistart NLP branch-and-bound.

Reference: src/solvers/MsBnb.cpp with MsProcessor (`msbnb_*` options) —
B&B where every node is processed from multiple start points.

TPU-native shape: the restart lanes ride INSIDE the vmapped superstep
(`bnb/multistart.py::MsBranchAndBound`), so a node's restarts and the
node batch share one device call.

    python -m minotaur_tpu_torch.solvers.msbnb instance.nl --msbnb_restarts 4

Port of minotaur_tpu/solvers/msbnb.py.  Runs on the first CUDA device;
`main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import sys

from ..bnb.multistart import MsBranchAndBound
from .base import Solver


class MsBnb(Solver):
    name = "msbnb"

    def solve(self) -> int:
        bab = MsBranchAndBound(self.problem, env=self.env,
                               device=self.device)
        status = bab.solve()
        log = self.env.logger
        log.info(f"nodes: {bab.stats.nodes_processed}  "
                 f"batches: {bab.stats.batches}  time: {bab.stats.time:.2f}s")
        log.info(f"lower bound: {bab.lb:.10g}  upper bound: {bab.ub:.10g}")
        self.write_solution(status, bab.ub, bab.best_x)
        return 0


def main(argv=None, device="cuda") -> int:
    return MsBnb(device=device).main(argv)


if __name__ == "__main__":
    sys.exit(main())
