"""The benchmark's own instrumentation around calls into the program.

- `Recorder`: host-clock spans (name, start, end, traced).
- `KernelSeam`: while active, the IPM's two kernel seams
  (`engines.ipm.spd_inverse`, `engines.ipm.spd_solve`) are wrapped so that
  the shape, dtypes and refinement steps of each call in the profiled
  slice are kept (only in `--trace 1` runs); their kernels' device time
  comes from the profiler's trace.
- `ProfilerSlice`: torch.profiler over the last part of the window: the
  device's busy time (union of kernel intervals), the device time of each
  kernel by name, the top device ops and the longest idle gaps by the host
  op that was running.
"""

from __future__ import annotations

import bisect
import time
from typing import List, Optional


class Recorder:
    def __init__(self):
        self.spans: List[tuple] = []         # (name, t0, t1, traced)
        self.traced_since: Optional[float] = None

    def span(self, name: str, t0: float, t1: float) -> None:
        traced = self.traced_since is not None and t0 >= self.traced_since
        self.spans.append((name, t0, t1, traced))


class KernelSeam:
    """Keeps the shape of every call through the IPM's kernel seams that
    starts in the profiled slice."""

    def __init__(self, rec: Recorder):
        self.rec = rec
        self.calls: List[tuple] = []
        self._saved = None

    def __enter__(self):
        from minotaur_tpu_torch.engines import ipm
        inv, sol = ipm.spd_inverse, ipm.spd_solve
        calls, rec = self.calls, self.rec

        def spd_inverse(ms):
            if rec.traced_since is not None:
                calls.append(("k1", dict(B=ms.shape[0], k=ms.shape[1],
                                         itemsize=ms.element_size())))
            return inv(ms)

        def spd_solve(minv_s, m_op, dinv, shift, r, refine_steps=0,
                      out_dtype=None):
            if rec.traced_since is not None:
                calls.append(("k2", dict(
                    B=minv_s.shape[0], k=minv_s.shape[1],
                    sf=minv_s.element_size(), sm=m_op.element_size(),
                    steps=int(refine_steps),
                    R=1 if r.dim() == 2 else int(r.shape[2]))))
            return sol(minv_s, m_op, dinv, shift, r, refine_steps, out_dtype)

        self._saved = (ipm, inv, sol)
        ipm.spd_inverse, ipm.spd_solve = spd_inverse, spd_solve
        return self

    def __exit__(self, *exc):
        ipm, inv, sol = self._saved
        ipm.spd_inverse, ipm.spd_solve = inv, sol
        return False


def union_s(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class ProfilerSlice:
    TOP = 10
    SCAN = 4096          # host ops looked at back from an idle gap

    def __init__(self, rec: Recorder):
        self.rec = rec
        self.prof = None
        self.t0 = self.t1 = None

    def warm_up(self):
        """Start and stop the profiler once, so that its first start (which
        loads and sets up the device tracing) falls in set-up."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.zeros(1, device="cuda" if torch.cuda.is_available()
                        else "cpu").add_(1)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        # the device finishes what was launched before the slice, so that
        # every kernel traced belongs to a call made inside it
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.start()
        self.t0 = time.monotonic()
        self.rec.traced_since = self.t0

    def stop(self):
        import torch
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.stop()

    def summary(self) -> Optional[dict]:
        """busy_s, window_s, the device seconds of each kernel by name
        (`kernel_s`) and the breakdown, from the profiler's events; None
        when no slice was traced."""
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        # the raw kineto events: building FunctionEvents (prof.events())
        # takes about 70 us an event
        raw = self.prof.profiler.kineto_results.events()
        kern, cpu = [], []
        for e in raw:
            dt = e.device_type()
            if dt == DeviceType.CUDA:
                kern.append((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()))
            elif dt == DeviceType.CPU and not e.name().startswith("cuda"):
                cpu.append((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name()))
        iv = sorted((a, b) for a, b, _ in kern)
        busy_us = union_s(iv)
        by_name = {}
        for a, b, name in kern:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:self.TOP]
        # idle gaps between merged kernel intervals, each named by the
        # innermost host op running at its midpoint
        cpu.sort()
        starts = [a for a, _, _ in cpu]
        gaps = {}
        end = None
        for a, b in iv:
            if end is not None and a > end:
                mid = 0.5 * (a + end)
                # the latest-starting op that still runs at mid
                i = bisect.bisect_right(starts, mid) - 1
                name = "no host op"
                for _ in range(self.SCAN):
                    if i < 0:
                        break
                    if cpu[i][1] >= mid:
                        name = cpu[i][2]
                        break
                    i -= 1
                gaps[name] = gaps.get(name, 0.0) + (a - end)
            end = b if end is None else max(end, b)
        window_us = (self.t1 - self.t0) * 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:self.TOP]
        return dict(
            busy_s=busy_us / 1e6, window_s=window_us / 1e6,
            kernel_s={n: t / 1e6 for n, t in by_name.items()},
            breakdown=dict(
                device_ops=[[n[:120], t / 1e6] for n, t in ops],
                idle_gaps=[[n[:120], t / 1e6] for n, t in idle]))
