"""mglob: global optimization of (MI)QCQPs.

Reference: src/solvers/{GlobMain.cpp,Glob.{h,cpp}} — transform to
term-separable standard form, convexity check (convex -> forward to QG,
Glob.cpp:392-400), else spatial B&B over McCormick/secant envelopes.

    python -m minotaur_tpu_torch.solvers.mglob instance.nl [--options]

Port of minotaur_tpu/solvers/mglob.py.  Runs on the first CUDA device;
`main(argv, device="cpu")` runs it on the CPU.
"""

from __future__ import annotations

import sys

from ..glob.glob_bnb import GlobBranchAndBound
from ..glob.transformer import is_convex_quadratic
from .base import Solver


class Glob(Solver):
    name = "mglob"

    def solve(self) -> int:
        log = self.env.logger
        p = self.problem
        if is_convex_quadratic(p):
            log.info("convex quadratic instance: forwarding to QG "
                     "(reference Glob fwd2QG_)")
            from ..bnb.qg import QGBranchAndBound
            bab = QGBranchAndBound(p, env=self.env, device=self.device)
            status = bab.solve()
            self.write_solution(status, bab.ub, bab.best_x)
            return 0
        try:
            bab = GlobBranchAndBound(p, env=self.env, device=self.device)
        except ValueError as e:
            # factorable transformer rejects (nonsmooth op, ...): fall
            # back to NLP-based B&B (reference Glob handles MIQCQP only
            # and hands everything else to bnb)
            log.info(f"transformer: {e}; forwarding to mbnb")
            from ..bnb.bnb import BranchAndBound
            bab = BranchAndBound(p, env=self.env, device=self.device)
            status = bab.solve()
            self.write_solution(status, bab.ub, bab.best_x)
            return 0
        status = bab.solve()
        log.info(f"nodes: {bab.nodes_processed}  lb: {bab.lb:.10g}  "
                 f"ub: {bab.ub:.10g}")
        self.write_solution(status, bab.ub, bab.best_x)
        return 0


def main(argv=None, device="cuda") -> int:
    return Glob(device=device).main(argv)


if __name__ == "__main__":
    sys.exit(main())
