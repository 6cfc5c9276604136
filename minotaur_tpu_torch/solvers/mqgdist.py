"""mqgdist: distributed Quesada-Grossmann branch-and-cut over a list of
devices — the `mqgmpi` equivalent (the reference fork's headline binary)
in one process.

Reference: src/solvers/{QGMpiMain.cpp,QGMpi.{h,cpp}} +
src/base/MpiBranchAndBound.cpp.  Where the reference MPI_Bcasts the .nl
bytes so every rank parses an identical problem (QGMpiMain.cpp:85-106),
a single controller shares the parsed problem and splits the node batch
over the devices; incumbent gossip is the min of the partitions' best
objectives inside the sharded superstep and LoadBalance_ is the periodic
global sort + round-robin deal (parallel/dist_bnb.py).

    python -m minotaur_tpu_torch.solvers.mqgdist instance.nl \\
        [--mesh_hosts N] [--options]

`mesh_hosts` picks the number of node-pool partitions.  On CUDA they are
cuda:0..N-1 (every card when N <= 1, at most the card count);
`main(argv, device="cpu")` runs N partitions on the CPU, the counterpart
of the JAX package's virtual CPU mesh.

Port of minotaur_tpu/solvers/mqgdist.py.
"""

from __future__ import annotations

import sys

import torch

from ..device import resolve_device
from .base import Solver


class QGDist(Solver):
    name = "mqgdist"

    def partition_devices(self):
        """The partitions' devices: cuda:0..count-1 clamped to
        `mesh_hosts`, or `mesh_hosts` copies of the CPU."""
        want = int(self.env.options.get("mesh_hosts"))
        if self.device.type == "cpu":
            return [self.device] * max(1, want)
        resolve_device(self.device)
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if want <= 1:
            want = len(devs)
        if want > len(devs):
            self.env.logger.info(
                f"mesh_hosts={want} > {len(devs)} devices; using "
                f"{len(devs)}")
            want = len(devs)
        return devs[:want]

    def solve(self) -> int:
        from ..parallel.dist_bnb import DistQGBranchAndBound

        bab = DistQGBranchAndBound(self.problem, self.partition_devices(),
                                   env=self.env)
        status = bab.solve()
        log = self.env.logger
        s = bab.qg_stats
        log.info(f"partitions: {bab.n_parts}  "
                 f"nodes: {bab.stats.nodes_processed}  "
                 f"cuts: {s.cuts_added}  nlp solves: {s.nlp_solves} "
                 f"(feasible {s.nlp_feasible})  "
                 f"rebalances: {bab.stats.rebalances}  "
                 f"time: {bab.stats.time:.2f}s")
        log.info(f"lower bound: {bab.lb:.10g}  upper bound: {bab.ub:.10g}")
        self.write_solution(status, bab.ub, bab.best_x)
        return 0


def main(argv=None, device="cuda") -> int:
    return QGDist(device=device).main(argv)


if __name__ == "__main__":
    sys.exit(main())
