"""Entry of `BranchAndBound.solve()` (bnb/bnb.py): the host tree, and with
`device_tree` in the traffic's options the device pool (bnb/device_pool.py).

The benchmark wraps the node superstep (`bab._step`; in the pool, the
`step_b` that `DevicePoolRunner` builds) to time each call, and to keep
every lane's box and answer for the comparison after the window.
"""

from __future__ import annotations

import time

import numpy as np

from ..harness.problem import to_problem


class StepTap:
    """`bab._step` as the host loop sees it, with a span around each
    dispatch and each lane's box and answer kept."""

    def __init__(self, step, run, n):
        self._step, self._run, self._n = step, run, n
        self.device = step.device
        self._boxes = {}

    def dispatch(self, A, clb, cub, vlb_b, vub_b, x0_b, y0_b):
        self._run.boundary()
        t0 = time.monotonic()
        packed = self._step.dispatch(A, clb, cub, vlb_b, vub_b, x0_b, y0_b)
        self._run.rec.span("superstep", t0, time.monotonic())
        self._boxes[id(packed)] = (np.array(vlb_b, dtype=np.float64),
                                   np.array(vub_b, dtype=np.float64))
        return packed

    def unpack(self, packed):
        res = self._step.unpack(packed)
        lb, ub = self._boxes.pop(id(packed))
        n = self._n
        self._run.keep_lanes(lb[:, :n], ub[:, :n], res.status,
                             res.dual_bound, res.x[:, :n])
        return res

    def __call__(self, A, clb, cub, vlb_b, vub_b, x0_b, y0_b):
        return self.unpack(self.dispatch(A, clb, cub, vlb_b, vub_b, x0_b,
                                         y0_b))


def pool_step_tap(make_step, run, n):
    """Wraps `build_node_step_unjitted` so that the pool's rounds keep
    their lanes too: one copy to the host a round, beside the IPM's own
    reads of the host every iteration.  (Clones kept on the device instead
    made each round about 1.5 times slower on the H100; PERF.md.)"""
    def build(sp, opts, dev):
        step_b = make_step(sp, opts, dev)

        def tapped(A, clb, cub, vlb, vub, x0, y0=None):
            run.boundary()
            res = step_b(A, clb, cub, vlb, vub, x0, y0)
            host = {k: res[k].cpu().numpy() for k in
                    ("status", "dual_bound", "x")}
            run.keep_lanes(vlb[:, :n].cpu().numpy(), vub[:, :n].cpu().numpy(),
                           host["status"], host["dual_bound"],
                           host["x"][:, :n])
            return res
        return tapped
    return build


class Entry:
    def __init__(self, run):
        self.run = run
        self.bab = None
        self._pool_mod = None
        self._pool_saved = None

    def build(self, inst: dict, time_limit: float) -> None:
        from minotaur_tpu_torch.bnb import device_pool
        from minotaur_tpu_torch.bnb.bnb import BranchAndBound
        from minotaur_tpu_torch.utils.environment import Environment
        env = Environment()
        for k, v in self.run.options().items():
            env.set_option(k, v)
        env.set_option("bnb_time_limit", float(time_limit))
        n = len(inst["lb"])
        self.bab = BranchAndBound(to_problem(inst), env,
                                  device=self.run.device)
        self.bab._step = StepTap(self.bab._step, self.run, n)
        if self._pool_saved is None:
            self._pool_mod = device_pool
            self._pool_saved = device_pool.build_node_step_unjitted
            device_pool.build_node_step_unjitted = pool_step_tap(
                self._pool_saved, self.run, n)

    def close(self) -> None:
        if self._pool_saved is not None:
            self._pool_mod.build_node_step_unjitted = self._pool_saved
            self._pool_saved = None
        self.bab = None

    def warm_up(self) -> None:
        """One superstep of node_batch lanes on the root box."""
        bab = self.bab
        sp, B = bab.sp, bab._batch
        bab._step._step(sp.A, sp.clb, sp.cub, np.tile(sp.vlb, (B, 1)),
                        np.tile(sp.vub, (B, 1)), np.zeros((B, sp.n)),
                        np.zeros((B, sp.m)))

    def search(self) -> bool:
        """`solve()`; True when it stopped at its time limit."""
        from minotaur_tpu_torch.utils.types import SolveStatus
        return self.bab.solve() == SolveStatus.SOLVED_TIME_LIMIT

    def nodes(self) -> int:
        return int(self.bab.stats.nodes_processed)

    def final(self) -> dict:
        bab = self.bab
        x = bab.best_x_original
        return dict(lb=float(bab.lb), ub=float(bab.ub),
                    x=None if x is None else np.array(x, dtype=np.float64))

    def counters(self) -> dict:
        s = self.bab.stats
        out = dict(t_host=s.t_host, t_device=s.t_device,
                   ipm_iters=s.ipm_iters, batches=s.batches,
                   nodes_processed=s.nodes_processed)
        pool = self.bab._dev_pool
        if pool is not None:
            out.update(pool_calls=pool.calls, pool_rounds=pool.rounds,
                       pool_processed=pool.processed)
        return out
