"""Timers and card reports of the microbenchmarks (microbench_*.py).

On a CUDA device a time is device time from CUDA events; on the CPU it
is the host clock, reported under `clock: "host"` and never as a device
number.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, Optional

import torch

CLOCK_QUERY = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
               "clocks.mem,temperature.gpu")


def clock_name(device: torch.device) -> str:
    return "cuda events" if device.type == "cuda" else "host"


def time_ms(fn: Callable, device: torch.device, calls: int = 10,
            reps: int = 5, warmup: int = 2) -> float:
    """Milliseconds per call of fn(): `calls` back-to-back calls a window
    after `warmup` calls, the median of `reps` windows.  On CUDA the
    window is timed by CUDA events (the device's time where the host
    keeps ahead of it); on the CPU by the host clock."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / calls)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
    times.sort()
    return times[len(times) // 2]


def host_ms(fn: Callable, device: torch.device, calls: int = 10,
            reps: int = 5, warmup: int = 2) -> float:
    """Milliseconds per call by the host clock, each window ended by a
    device synchronisation: what a caller waits for calls issued one by
    one from Python."""
    for _ in range(warmup):
        fn()
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    times.sort()
    return times[len(times) // 2]


def graph_ms(fn: Callable, calls: int = 10, reps: int = 5) -> float:
    """Device milliseconds per call of fn() on CUDA: `calls` calls
    captured in one CUDA graph (after warm-up on a side stream), the
    graph replayed between CUDA events, the median of `reps` replays.
    No host dispatch falls inside the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    times.sort()
    return times[len(times) // 2]


def card_clocks(device: torch.device) -> Optional[str]:
    """nvidia-smi's name, power limit and draw, SM clock, its maximum,
    memory clock and temperature of the card, or None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={CLOCK_QUERY}", "--format=csv,noheader",
         f"--id={device.index or 0}"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"
