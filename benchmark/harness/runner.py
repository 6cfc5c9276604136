"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

    set-up   instance 0 of the seed's stream from the configuration's
             generator, the program's solver object, one warm-up superstep
             of node_batch lanes (setup_s runs from the process's start)
    window   the program's solve() with the time limit --seconds; it ends
             at the first superstep (or multiround call) boundary past it.
             A search that ends sooner is followed by the stream's next
             instance, built inside the window.
    check    once the window has closed, the peak memory read and the
             program's state freed: every lane the window solved (or a
             sample of them drawn from the seed) and each instance's final
             bounds and incumbent, held to the reference.
"""

from __future__ import annotations

import contextlib
import gc
import json
import sys
import time

import numpy as np

from . import registry
from .trace import KernelSeam, ProfilerSlice, Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "minotaur_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Run:
    """What the entries report to while the program runs."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device, overrides=None):
        self.cell = registry.workload(cell)
        over = dict(overrides or {})
        self.traffic = {**registry.traffic(self.cell["traffic"]),
                        **over.pop("traffic", {})}
        self.cfg = {**registry.config(self.cell["config"]), **over}
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.rec = Recorder()
        self.prof = ProfilerSlice(self.rec) if trace else None
        self.trace_at = None
        self.instances = []
        self.entry = None
        self.t_window = None
        self.snapshot = None

    def options(self) -> dict:
        return {**self.cfg["solver"], **self.traffic.get("options", {})}

    def new_instance(self, inst: dict) -> None:
        self.instances.append(dict(fam=inst["family"], lanes=[], final=None))

    def keep_lanes(self, lb, ub, status, db, x) -> None:
        self.instances[-1]["lanes"].append(
            (np.asarray(lb, np.float64).copy(), np.asarray(ub, np.float64)
             .copy(), np.asarray(status).astype(np.int64).copy(),
             np.asarray(db, np.float64).copy(),
             np.asarray(x, np.float64).copy()))

    def boundary(self) -> None:
        """At each superstep boundary: start the profiled slice once its
        time has come."""
        if self.prof is None or self.trace_at is None or \
                self.prof.prof is not None or time.monotonic() < self.trace_at:
            return
        self.snapshot = dict(elapsed=time.monotonic() - self.t_window,
                             counters=self.entry.counters())
        self.prof.start()


def _lanes(inst: dict, limit, rng):
    """(every captured lane of one instance's box and status, stacked; the
    lanes to compare: at most `limit` of them (distinct boxes, the first
    lane always among them), drawn with `rng`, where a limit is set)."""
    parts = inst["lanes"]
    if not parts:
        return None, None
    lb, ub, st, db, x = (np.concatenate([p[i] for p in parts])
                         for i in range(5))
    every = dict(lb=lb, ub=ub, status=st)
    if limit is not None:
        key = np.concatenate([lb, ub], axis=1)
        _, first = np.unique(key, axis=0, return_index=True)
        first = np.sort(first)
        rest = first[first != 0]
        take = rng.choice(rest, size=min(len(rest), int(limit) - 1),
                          replace=False) if len(rest) else rest
        idx = np.concatenate([[0], np.sort(take)]).astype(int)
        lb, ub, st, db, x = lb[idx], ub[idx], st[idx], db[idx], x[idx]
    return every, dict(lb=lb, ub=ub, status=st, db=db, x=x)


def _captures(run: Run):
    """(instance data, captured lanes and final) of each instance that
    solved a lane, the lanes to compare sampled with one generator drawn
    from the seed."""
    rng = np.random.default_rng([run.seed % 2 ** 64, 7])
    for inst in run.instances:
        every, lanes = _lanes(inst, run.cfg.get("check_lanes"), rng)
        if lanes is not None:
            yield inst["fam"], dict(every=every, lanes=lanes,
                                    final=inst["final"])


def judge(run: Run, device) -> tuple:
    """The numbers compared (worst over the window's instances), lanes
    compared, lanes failed."""
    from ..reference import judge as J
    fam_mod = J.family(run.cfg["family"])
    limits = run.cfg["limits"]
    worst = {k: -np.inf for k in J.NUMBERS}
    attempted = failed = 0
    for fam, cap in _captures(run):
        vals, per_lane = J.numbers(fam_mod, fam, cap, limits, device=device)
        attempted += len(cap["lanes"]["db"]) + 1
        failed += per_lane + int(vals["incumbent_err"] >
                                 limits["incumbent_err"])
        for k in J.NUMBERS:
            worst[k] = _worse(worst[k], vals[k])
    return worst, attempted, failed


def control_readings(run: Run, device) -> dict:
    """The reference put in the program's place in float32, on the lanes
    and incumbents of this run (worst over its instances)."""
    from ..reference import judge as J
    fam_mod = J.family(run.cfg["family"])
    worst = {k: -np.inf for k in J.NUMBERS}
    for fam, cap in _captures(run):
        vals = J.control_numbers(fam_mod, fam, cap, device=device)
        for k in J.NUMBERS:
            worst[k] = _worse(worst[k], vals[k])
    return {k: v for k, v in worst.items() if k in run.cfg["limits"]}


def _worse(a: float, b: float) -> float:
    """The larger; NaN (a number that could not be read) wins."""
    return float("nan") if np.isnan(a) or np.isnan(b) else max(a, b)


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(torch, device, chips) -> dict:
    if device.type != "cuda":
        # only the tests drive a run on the CPU; run.py refuses it
        return dict(platform="cpu", kind="cpu", count=0,
                    memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=chips,
                memory_peak_bytes=int(max(torch.cuda.max_memory_allocated(i)
                                          for i in range(chips))))


def main(args, t_start: float) -> int:
    import torch
    bench = registry.benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        log(f"run: no workload {args.workload!r} in BENCHMARK.json")
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"run: the cell needs {chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = execute(args, t_start, torch.device("cuda", 0), chips, bench)
    bad = sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)
    if bad:
        log(f"run: forbidden modules loaded: {', '.join(bad)}")
        return 3
    for k, c in line["checks"].items():
        v = float(c["value"])
        log(f"check {k} {v:.6g} limit {c['limit']:.6g} "
            f"{'ok' if v <= c['limit'] else 'FAIL'}")
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


def execute(args, t_start: float, device, chips: int, bench: dict,
            overrides=None, control=False) -> dict:
    """A run of the cell on `device`, once the chips are known to be
    there; returns the result line.  `overrides` replace keys of the
    configuration (the control's solver options, the tests' small sizes;
    under `traffic`, keys of the traffic mix);
    with `control` the line also holds `control`: the numbers that the
    reference reads in the program's place one precision down."""
    import torch
    run = Run(args.workload, args.seed, float(args.seconds),
              bool(args.trace), device, overrides)
    gen = registry.module("generators", run.cfg["family"])
    entry_mod = registry.module("entries", run.traffic["entry"])

    def instance(index):
        return gen.generate(run.cfg["sizes"], run.cfg["instance_seed"],
                            args.seed, index)

    # ---- set-up
    inst = instance(0)
    run.new_instance(inst)
    entry = run.entry = entry_mod.Entry(run)
    entry.build(inst, run.seconds)
    entry.warm_up()
    if run.prof is not None:
        run.prof.warm_up()
    _sync(torch, device)
    setup_s = time.monotonic() - t_start
    log(f"run: {args.workload} seed {args.seed}: set-up {setup_s:.3f} s")

    # ---- the window
    timed = run.trace and device.type == "cuda"
    seam = KernelSeam(run.rec) if timed else contextlib.nullcontext()
    nodes, index = 0, 0
    run.t_window = t0 = time.monotonic()
    if run.prof is not None:
        run.trace_at = t0 + run.seconds - float(run.traffic["trace_slice_s"])
    with seam:
        while True:
            timed_out = entry.search()
            nodes += entry.nodes()
            run.instances[-1]["final"] = entry.final()
            elapsed = time.monotonic() - t0
            if timed_out or elapsed >= run.seconds:
                break
            index += 1
            inst = instance(index)
            run.new_instance(inst)
            entry.build(inst, run.seconds - elapsed)
        _sync(torch, device)
        window_s = time.monotonic() - t0
        if run.prof is not None:
            run.prof.stop()
    counters = entry.counters()
    final = run.instances[-1]["final"]
    dev = _device(torch, device, chips)
    entry.close()
    run.entry = entry = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    summary = run.prof.summary() if run.prof is not None else None
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    log(f"run: window {window_s:.3f} s, {nodes} nodes, "
        f"{len(run.instances)} instance(s), lb {final['lb']:.10g} "
        f"ub {final['ub']:.10g}; counters {counters}")

    # ---- the comparison
    values, attempted, failed = judge(run, device)
    from ..reference.judge import verdict
    correct, lines = verdict(values, run.cfg["limits"])

    # ---- the metrics
    ctx = dict(window_s=window_s, setup_s=setup_s, nodes=nodes,
               final=final, counters=counters, snapshot=run.snapshot,
               spans=run.rec.spans,
               calls=seam.calls if timed else None, trace=summary,
               instances=len(run.instances))
    metrics = {}
    for m in registry.metrics_of(bench, args.workload, run.trace):
        v = registry.metric(m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])

    line = dict(correct=bool(correct), attempted=int(attempted),
                failed=int(failed), metrics=metrics, device=dev)
    if summary is not None:
        line["breakdown"] = summary["breakdown"]
    if control:
        line["control"] = control_readings(run, device)
    # a number that is not finite goes out as text: strict JSON has none
    line["checks"] = {k: dict(value=v if np.isfinite(v) else str(v),
                              limit=lim) for k, v, lim, _ in lines}
    return line
