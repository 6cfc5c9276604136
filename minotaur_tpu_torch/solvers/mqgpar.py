"""mqgpar: "parallel" QG branch-and-cut.

Reference: src/solvers/QGPar.cpp — OpenMP QG via
ParQGBranchAndBound::parsolveOppor (not built upstream either; see
src/CMakeLists.txt:484-494).

Batch-native note: intra-host parallelism here IS the node-batch axis —
every superstep processes `node_batch` nodes in one lane-batched device call,
deterministic by construction (the reference's opportunistic mode is
not).  This entry point runs the QG stack with a `threads`-compatible
mapping: `--threads K` scales the node batch like the reference's
thread count scaled concurrent node processors.

    python -m minotaur_tpu_torch.solvers.mqgpar instance.nl --threads 8

Port of minotaur_tpu/solvers/mqgpar.py.  Runs on the first CUDA device;
`main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import sys

from ..bnb.qg import QGBranchAndBound
from .base import Solver


class QGPar(Solver):
    name = "mqgpar"

    def solve(self) -> int:
        threads = int(self.env.options.get("threads"))
        if threads > 0 and not self.env.options.find("node_batch").was_set:
            # reference semantics: K threads ~ K concurrent nodes; keep
            # batches in the compiled geometric buckets
            self.env.set_option("node_batch", max(4, threads))
        bab = QGBranchAndBound(self.problem, env=self.env,
                               device=self.device)
        status = bab.solve()
        log = self.env.logger
        s = bab.qg_stats
        log.info(f"nodes: {bab.stats.nodes_processed}  "
                 f"batches: {bab.stats.batches}  cuts: {s.cuts_added}  "
                 f"nlp solves: {s.nlp_solves}  time: {bab.stats.time:.2f}s")
        log.info(f"lower bound: {bab.lb:.10g}  upper bound: {bab.ub:.10g}")
        self.write_solution(status, bab.ub, bab.best_x)
        return 0


def main(argv=None, device="cuda") -> int:
    return QGPar(device=device).main(argv)


if __name__ == "__main__":
    sys.exit(main())
