"""The port's node-processor A/B (`minotaur_tpu_torch/tools/ab_qpd.py`)
against the JAX package, on the CPU.

- `run(...)` under `nodeproc pcb` and `qpd` on qknap12 (the JAX script's
  case) against the JAX `BranchAndBound` under the same options (those
  of scripts/ab_qpd.py::run): the same status and node count, ub and lb
  within 1e-6 relative (the same search; f32 factors may round the last
  digits differently), and no lane verified (a quadratic objective alone
  leaves QPD inactive).
- On the stand-in for nvs08 (batchdes_a, with exp rows) QPD is active:
  `qpd_verified > 0`, and pcb and qpd reach the oracle's optimum.
- The case table names the stand-in, and `main` prints and returns one
  row per case and processor (run on the stand-in only here).
"""

import pytest
import torch

from minotaur_tpu_torch.models.convex_suite import SUITE
from minotaur_tpu_torch.models.generators import quadratic_knapsack
from minotaur_tpu_torch.tools import ab_qpd


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small problems: intra-op threads only contend with the other test
    workers, so the port runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_run(nodeproc):
    from minotaur_tpu.bnb.bnb import BranchAndBound
    from minotaur_tpu.models.generators import quadratic_knapsack as jqk
    from minotaur_tpu.utils.environment import Environment
    env = Environment()
    for k, v in (("log_level", 0), ("nodeproc", nodeproc), ("node_batch", 8),
                 ("bnb_node_limit", 4000)):
        env.set_option(k, v)
    bab = BranchAndBound(jqk(12, density=0.4, seed=3), env)
    st = bab.solve()
    return dict(status=st.name, nodes=bab.stats.nodes_processed, ub=bab.ub,
                lb=bab.lb, qpd_verified=bab._qpd_verified)


@pytest.mark.parametrize("nodeproc", ab_qpd.PROCS)
def test_qknap12_matches_jax(nodeproc):
    r = ab_qpd.run(lambda: quadratic_knapsack(12, density=0.4, seed=3),
                   nodeproc, device="cpu")
    j = _jax_run(nodeproc)
    assert set(r) == {"status", "nodes", "wall", "ub", "lb", "qpd_verified"}
    assert r["status"] == j["status"] == "SOLVED_OPTIMAL"
    assert r["nodes"] == j["nodes"]
    for key in ("ub", "lb"):
        assert abs(r[key] - j[key]) <= 1e-6 * max(1.0, abs(j[key]))
    assert r["qpd_verified"] == j["qpd_verified"] == 0


def test_stand_in_verifies_on_the_true_model(monkeypatch, capsys):
    cases = ab_qpd.cases()
    name = next(iter(cases))
    assert name == "batchdes_a (stand-in for nvs08)"
    assert list(cases)[1:] == ["qknap12", "qknap16"]
    monkeypatch.setattr(ab_qpd, "cases", lambda nvs08=None: {
        name: cases[name]})
    rows = ab_qpd.main(["--device", "cpu"])
    assert [(r["instance"], r["proc"]) for r in rows] == [
        (name, "pcb"), (name, "qpd")]
    pcb, qpd = rows
    assert qpd["qpd_verified"] > 0 and pcb["qpd_verified"] == 0
    opt = SUITE["batchdes_a"][1]()
    for r in rows:
        assert r["status"] == "SOLVED_OPTIMAL"
        assert abs(r["ub"] - opt) <= 1e-5 * max(1.0, abs(opt))
    out = capsys.readouterr().out
    assert out.startswith("card: cpu") and name in out
