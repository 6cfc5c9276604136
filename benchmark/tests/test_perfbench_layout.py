"""BENCHMARK.json and the files it names; parts found by name; imports."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def test_every_cell_config_and_metric_has_its_files():
    b = _bench()
    for w in b["workloads"]:
        cell = _json("workloads", w["name"] + ".json")
        assert (cell["config"], cell["traffic"], cell["why"]) == \
            (w["config"], w["traffic"], w["why"])
        traffic = _json("traffic", w["traffic"] + ".json")
        assert os.path.isfile(os.path.join(BENCH, "entries",
                                           traffic["entry"] + ".py"))
    for c in b["configs"]:
        cfg = _json("configs", c["name"] + ".json")
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert (cfg["source"], cfg["reduced"]) == (c["source"], c["reduced"])
        for kind in ("generators", "reference"):
            assert os.path.isfile(os.path.join(BENCH, kind,
                                               cfg["family"] + ".py"))
    for m in b["end_to_end"] + b["per_layer"]:
        assert os.path.isfile(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))


def test_metrics_of_each_cell():
    from benchmark.harness.registry import metrics_of
    b = _bench()
    names = lambda c, t: {m["name"] for m in metrics_of(b, c, t)}  # noqa
    assert names("qkp-ghs-100-25.glob", False) == {"nodes_per_s", "setup_s"}
    assert names("intquad300-f64.tree", False) == {"nodes_per_s", "gap_rel",
                                                "setup_s"}
    assert "pool.nodes_per_call" in names("intquad300-f64.pool", True)
    assert "pool.nodes_per_call" not in names("intquad300-f64.tree", True)


def _tree_hashes(top):
    import hashlib
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".pyc"):
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_new_config_cell_and_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    and a per-layer metric by new files and new BENCHMARK.json entries
    alone; a run of the new cell reports the new metric."""
    dst = tmp_path / "benchmark"
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "minotaur_tpu_torch"),
               tmp_path / "minotaur_tpu_torch")
    before = _tree_hashes(dst)
    cfg = _json("configs", "intquad300-f64.json")
    cfg.update(name="intquad40", sizes={"n": 40, "u": 4},
               solver={**cfg["solver"], "node_batch": 8})
    (dst / "configs" / "intquad40.json").write_text(json.dumps(cfg))
    (dst / "traffic" / "serial.json").write_text(json.dumps(
        {"entry": "bnb", "options": {"bnb_pipeline": 0},
         "trace_slice_s": 1.0}))
    why = "a smaller instance searched without the pipelined loop"
    (dst / "workloads" / "intquad40.serial.json").write_text(json.dumps(
        {"config": "intquad40", "traffic": "serial", "why": why}))
    (dst / "metrics" / "nodes_total.py").write_text(
        "def read(ctx):\n    return ctx['nodes']\n")
    b = _bench()
    b["configs"].append({"name": "intquad40", "source": cfg["source"],
                         "file": "benchmark/configs/intquad40.json",
                         "reduced": [], "why": why})
    b["workloads"].append({"name": "intquad40.serial", "config": "intquad40",
                           "traffic": "serial", "chips": 1, "why": why})
    b["per_layer"].append({"name": "nodes_total", "unit": "nodes",
                           "better": "higher", "source": "program_counter",
                           "layer": "host loop", "moves": "nodes_per_s",
                           "workloads": ["intquad40.serial"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = """
import argparse, json, sys, time, torch
torch.set_num_threads(1)
sys.path.insert(0, '.')
from benchmark.harness import registry, runner
a = argparse.Namespace(workload='intquad40.serial', seed=3, seconds=2.0,
                       trace=1)
line = runner.execute(a, time.monotonic(), torch.device('cpu'), 1,
                      registry.benchmark())
print(json.dumps(sorted(line['metrics'])))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "nodes_total" in json.loads(out.stdout.strip().splitlines()[-1])
    after = _tree_hashes(dst)
    assert all(after[k] == v for k, v in before.items())


_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
import importlib, pkgutil
mods = {mods!r}
for m in mods:
    importlib.import_module(m)
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in {forbidden!r})
print(','.join(bad))
"""


def _loaded(mods, forbidden):
    out = subprocess.run(
        [sys.executable, "-c", _IMPORTS.format(root=ROOT, mods=mods,
                                               forbidden=forbidden)],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip()


def _modules(kind):
    return [f"benchmark.{kind}.{f[:-3]}"
            for f in sorted(os.listdir(os.path.join(BENCH, kind)))
            if f.endswith(".py")]


def test_reference_imports_nothing_of_the_program_or_jax():
    mods = _modules("reference") + _modules("generators")
    assert _loaded(mods, ("jax", "jaxlib", "flax", "minotaur_tpu",
                          "minotaur_tpu_torch")) == ""


def test_harness_imports_neither_jax_nor_the_jax_package():
    mods = _modules("harness") + _modules("entries") + ["benchmark.run",
                                                        "benchmark.control"]
    assert _loaded(mods, ("jax", "jaxlib", "flax", "minotaur_tpu")) == ""


def test_a_small_run_loads_no_jax():
    code = """
import argparse, sys, time, torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from conftest import small_run
small_run('qkp-ghs-100-25.glob', seconds=1.0)
small_run('intquad300-f64.pool', seconds=2.0)
print('loaded:' + ','.join(sorted(k for k in sys.modules if
      k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'minotaur_tpu'))))
""".format(root=ROOT, tests=os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded:"


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_run_exits_without_a_line_without_the_card_or_the_program(
        where, tmp_path):
    """Without CUDA (here), or in a directory that holds only
    BENCHMARK.json and the benchmark, run.py prints nothing and fails."""
    cwd = ROOT
    if where == "alone":
        shutil.copytree(BENCH, tmp_path / "benchmark",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
        cwd = tmp_path
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "intquad300-f64.tree", "--seed", "5", "--seconds", "1", "--trace",
         "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300)
    import torch
    if torch.cuda.is_available() and where == "checkout":
        pytest.skip("a card is present: the run would measure")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_keeps_the_format():
    import re
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    line = lambda s: 1 <= len(s) <= 200 and "\n" not in s and \
        "\t" not in s  # noqa: E731
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert name.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(name.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and line(w["why"])
        assert all(name.match(w[k]) for k in ("name", "config", "traffic"))
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and line(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(json.dumps(b)) <= 64 * 1024
