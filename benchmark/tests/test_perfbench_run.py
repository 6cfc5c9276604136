"""A run of each cell on the CPU at a small size: the result line, the
faults that `correct` must catch, and the control."""

import contextlib
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import ROOT, small_run

CELLS = ("intquad300-f64.tree", "intquad300-f64.pool", "qkp-ghs-100-25.glob")


def test_result_line_shape():
    # long enough for the search to find an incumbent (gap_rel is left out
    # of the line before one exists) on a loaded CPU
    line = small_run("intquad300-f64.tree", seconds=8.0)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"nodes_per_s", "gap_rel", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["checks"]) == {"bound_excess", "opt_gap", "primal_viol",
                                   "short_share", "incumbent_err"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert line["attempted"] > 64 and 0 <= line["failed"] <= \
        line["attempted"]
    json.dumps(line)


def test_traced_line_has_the_layers():
    line = small_run("intquad300-f64.tree", trace=1, seconds=4.0)
    assert {"host_loop.host_share", "superstep.s_p90",
            "ipm.lane_iters_per_node"} <= set(line["metrics"])
    assert "nodes_per_s" not in line["metrics"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(line["device"]) or \
        line["device"]["platform"] == "cpu"


# ---- faults planted in the timed path ------------------------------------
def _unchanged(res, vlb, vub, x0):
    """The step hands back the state it was given."""
    res["x"] = x0.clone() if torch.is_tensor(x0) else np.array(x0)
    res["dual_bound"] = res["dual_bound"] * 0 - float("inf")
    return res


def _half(res, vlb, vub, x0):
    """The second half of the batch is left out: it gets the first half's
    answers."""
    B = len(res["dual_bound"])
    h = B // 2
    for k, v in res.items():
        if hasattr(v, "shape") and v.shape[:1] == (B,):
            v = v.clone() if torch.is_tensor(v) else np.array(v)
            v[h:] = v[:B - h]
            res[k] = v
    return res


def _altered(res, vlb, vub, x0):
    """One lane's bound altered where it is produced."""
    db = res["dual_bound"]
    db = db.clone() if torch.is_tensor(db) else np.array(db)
    db[0] = db[0] + 1e-2 * (1 + abs(float(db[0])))
    res["dual_bound"] = db
    return res


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


@contextlib.contextmanager
def broken(fault):
    from minotaur_tpu_torch.bnb import device_pool, step
    from minotaur_tpu_torch.glob import glob_bnb
    f = FAULTS[fault]

    def node_maker(build):
        def b(sp, opts, dev):
            step_b = build(sp, opts, dev)

            def bad(A, clb, cub, vlb, vub, x0, y0=None):
                return f(dict(step_b(A, clb, cub, vlb, vub, x0, y0)), vlb,
                         vub, x0)
            return bad
        return b

    def glob_maker(build):
        def b(gs, opts, dev):
            st = build(gs, opts, dev)

            def bad(vlb, vub, x0):
                r = st(vlb, vub, x0)
                return type(r)(**f(r._asdict(), vlb, vub, x0))
            bad.dispatch, bad.unpack, bad.device = st.dispatch, st.unpack, \
                st.device
            return bad
        return b

    saved = (step.build_node_step_unjitted,
             device_pool.build_node_step_unjitted, glob_bnb.build_glob_step)
    step.build_node_step_unjitted = node_maker(saved[0])
    device_pool.build_node_step_unjitted = node_maker(saved[1])
    glob_bnb.build_glob_step = glob_maker(saved[2])
    try:
        yield
    finally:
        (step.build_node_step_unjitted, device_pool.build_node_step_unjitted,
         glob_bnb.build_glob_step) = saved


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault):
    with broken(fault):
        line = small_run(cell, seconds=3.0)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_ipm_cut_short_is_not_correct(cell):
    """The IPM stopped after two iterations: valid but weak bounds, lanes
    left short of optimal, and a faster search."""
    line = small_run(cell, seconds=3.0, solver={"ipm_max_iters": 2})
    assert line["correct"] is False, line["checks"]


def test_the_qkp_control_is_not_correct():
    """The control of the QKP cell: the reference's LP in float32 in the
    program's place, on the run's own lanes."""
    line = small_run("qkp-ghs-100-25.glob", seconds=3.0, control=True)
    limits = {k: c["limit"] for k, c in line["checks"].items()}
    assert any(v > limits[k] for k, v in line["control"].items()), \
        line["control"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["intquad300-f64.tree",
                                  "qkp-ghs-100-25.glob"])
def test_the_control_on_the_card_is_not_correct(card, cell, tmp_path):
    """The control at the cell's size, over a short window: one of its
    numbers passes its limit."""
    out = tmp_path / "control.jsonl"
    run = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", cell,
         "--seeds", "2147483901", "--seconds", "20", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads(out.read_text().splitlines()[-1])
    from benchmark.harness import registry
    limits = registry.config(registry.workload(cell)["config"])["limits"]
    assert rec["correct"] is True, rec["program"]
    assert any(v > limits[k] for k, v in rec["control"].items()), rec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483811", "--seconds", "5", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
