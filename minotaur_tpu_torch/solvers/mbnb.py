"""mbnb: NLP-relaxation branch-and-bound for (convex) MINLP.

Port of minotaur_tpu/solvers/mbnb.py (reference: src/solvers/{BnbMain.cpp,
Bnb.{h,cpp}}, the canonical solver path).  Runs on the first CUDA device;
`main(argv, device="cpu")` runs it on the CPU.  Usage:

    python -m minotaur_tpu_torch.solvers.mbnb instance.nl [--options]
"""

from __future__ import annotations

import sys

from ..bnb.bnb import BranchAndBound
from .base import Solver


class Bnb(Solver):
    name = "mbnb"

    def solve(self) -> int:
        log = self.env.logger
        problem = self.problem
        n_orig = problem.n_vars
        if self.env.options.get("bin2lin"):
            from ..bnb.bin2lin import binary_products_to_linear
            res = binary_products_to_linear(problem)
            if res is not None:
                problem, n_orig = res
                log.info(
                    f"bin2lin: exact MIQP->MILP reformulation "
                    f"({problem.n_vars - n_orig} product auxiliaries); "
                    "tree runs on LP relaxations")
        o = self.env.options.find("presolve_subst")
        if o is not None and not o.was_set:
            # the solver entry point defaults the substitution presolve
            # ON (reference Presolver default); library users opt in
            self.env.set_option("presolve_subst", 1)
        bab = BranchAndBound(problem, env=self.env, device=self.device)
        status = bab.solve()
        if bab.best_x is not None:
            bab.best_x = bab.best_x_original    # postsolve lift
            if len(bab.best_x) > n_orig:
                bab.best_x = bab.best_x[:n_orig]
        log.info(f"nodes processed: {bab.stats.nodes_processed}  "
                 f"created: {bab.stats.nodes_created}  "
                 f"batches: {bab.stats.batches}  "
                 f"time: {bab.stats.time:.2f}s")
        log.info(f"lower bound: {bab.lb:.10g}  upper bound: {bab.ub:.10g}")
        self.write_solution(status, bab.ub, bab.best_x)
        return 0


def main(argv=None, device="cuda") -> int:
    return Bnb(device=device).main(argv)


if __name__ == "__main__":
    sys.exit(main())
