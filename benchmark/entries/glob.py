"""Entry of `GlobBranchAndBound.solve()` (glob/glob_bnb.py), the spatial
B&B over McCormick relaxations that glob/glob_step.py builds a lane.

The benchmark wraps the glob step (`gbab._step`) to time each call and to
keep each lane's box (the original variables' part) and answer.
"""

from __future__ import annotations

import time

import numpy as np

from ..harness.problem import to_problem


class GlobStepTap:
    def __init__(self, step, run, n):
        self._step, self._run, self._n = step, run, n
        self.dispatch, self.unpack = step.dispatch, step.unpack
        self.device = step.device

    def __call__(self, vlb_b, vub_b, x0_b):
        self._run.boundary()
        t0 = time.monotonic()
        res = self._step(vlb_b, vub_b, x0_b)
        self._run.rec.span("superstep", t0, time.monotonic())
        n = self._n
        self._run.keep_lanes(np.array(vlb_b)[:, :n], np.array(vub_b)[:, :n],
                             res.status, res.dual_bound, res.x[:, :n])
        return res


class Entry:
    def __init__(self, run):
        self.run = run
        self.bab = None

    def build(self, inst: dict, time_limit: float) -> None:
        from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
        from minotaur_tpu_torch.utils.environment import Environment
        env = Environment()
        for k, v in self.run.options().items():
            env.set_option(k, v)
        env.set_option("bnb_time_limit", float(time_limit))
        self.bab = GlobBranchAndBound(to_problem(inst), env,
                                      device=self.run.device)
        self.bab._step = GlobStepTap(self.bab._step, self.run,
                                     len(inst["lb"]))

    def close(self) -> None:
        self.bab = None

    def warm_up(self) -> None:
        """One glob step of node_batch lanes on the root box."""
        bab = self.bab
        gs, B = bab.gs, bab._batch
        bab._step._step(np.tile(gs.vlb, (B, 1)), np.tile(gs.vub, (B, 1)),
                        np.zeros((B, gs.n)))

    def search(self) -> bool:
        from minotaur_tpu_torch.utils.types import SolveStatus
        return self.bab.solve() == SolveStatus.SOLVED_TIME_LIMIT

    def nodes(self) -> int:
        return int(self.bab.nodes_processed)

    def final(self) -> dict:
        bab = self.bab
        return dict(lb=float(bab.lb), ub=float(bab.ub),
                    x=None if bab.best_x is None else
                    np.array(bab.best_x, dtype=np.float64))

    def counters(self) -> dict:
        return dict(nodes_processed=self.bab.nodes_processed,
                    batches=self.bab._steps_done)
