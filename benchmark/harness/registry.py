"""Finds every part of the benchmark by its name in BENCHMARK.json.

    configs/<config>.json          a configuration: source, family, sizes,
                                   instance_seed, solver options, limits
    traffic/<traffic>.json         a traffic mix: entry, options, trace slice
    workloads/<workload>.json      a cell: config, traffic, why
    metrics/<metric>.py            a metric: read(ctx) -> number or None
    generators/<family>.py         an instance family: generate(...)
    reference/<family>.py          its plain reference
    entries/<entry>.py             the entry of the program a traffic drives

A later change adds a cell, a configuration, a traffic mix or a metric by
adding files of these names; no file here lists them.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
PACKAGE = os.path.basename(HERE)


def _json(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, name + ".json")
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def workload(name: str) -> dict:
    return _json("workloads", name)


def module(kind: str, name: str):
    """generators/<name>.py, reference/<name>.py or entries/<name>.py."""
    return importlib.import_module(f"{PACKAGE}.{kind}.{name}")


def metric(name: str):
    """metrics/<name>.py (metric names hold dots, so it is loaded by
    path)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of `cell` reports: its end-to-end metrics
    with --trace 0, its per-layer metrics with --trace 1."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in mine
                             else [])]
