"""The port's example gallery, QG/OA and global scripts, on the CPU.

Each script of `minotaur_tpu_torch/examples/` runs with `device="cpu"` at
the arguments `tests/test_examples.py` gives the JAX package's script,
under the same assertions and known optima: -4 for `simple_glob`, 0.25
for `outer_approx`, -400 for `water_network` (Haverly pooling), the
brute-force optimum over every facility set for `benders_demo`.
`simple_qg`, `simple_glob` and `outer_approx` are also held to the JAX
scripts at the same arguments (slow: the JAX side compiles), and so is
`bilinear_demo`'s own run (slow: about 2 min on the CPU).
"""

import importlib
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small problems: intra-op threads only contend with the other test
    workers, so the port runs on one."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(name):
    return importlib.import_module("minotaur_tpu_torch.examples." + name)


def _jax(name):
    spec = importlib.util.spec_from_file_location(
        "jax_example_" + name, os.path.join(ROOT, "examples", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_simple_qg():
    bab = _port("simple_qg").main(node_batch=4, log_level=1, device="cpu")
    assert bab.ub < 1e19


def test_simple_glob():
    bab = _port("simple_glob").main(node_batch=4, log_level=1, device="cpu")
    # optimum -4 at (2, 2, 0): -x0*x1 - x2 with x0+x1+2x2 <= 4
    assert bab.ub == pytest.approx(-4.0, abs=1e-4)


def test_outer_approx():
    bab = _port("outer_approx").main(node_batch=4, log_level=1,
                                     device="cpu")
    # nearest integer point to (1.3, 2.6) satisfying x0+x1>=2 -> (1, 3)
    assert bab.ub == pytest.approx(0.09 + 0.16, abs=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["simple_qg", "simple_glob",
                                  "outer_approx"])
def test_matches_jax(name):
    pb = _port(name).main(node_batch=4, log_level=1, device="cpu")
    jb = _jax(name).main(node_batch=4, log_level=1)
    assert pb.status == jb.status
    assert abs(pb.ub - jb.ub) <= 1e-6 * (1 + abs(jb.ub))
    np.testing.assert_allclose(pb.best_x, jb.best_x, atol=1e-5)


def test_multilinear_demo():
    bab = _port("multilinear_demo").main(node_batch=4, log_level=1,
                                         device="cpu")
    assert bab.ub < 1e19


def test_multistart_demo():
    bab = _port("multistart_demo").main(log_level=1, device="cpu")
    assert bab.ub <= -0.95


def test_rlt_demo():
    out = _port("rlt_demo").main(log=False, device="cpu")
    # RLT cuts strictly lift the root dual bound on this model
    assert out[(12, 1)][1] > out[(0, 1)][1] + 0.5
    assert out[(12, 30)][1] >= out[(0, 30)][1] - 1e-6


@pytest.mark.slow
def test_bilinear_demo():
    bab = _port("bilinear_demo").main(node_batch=8, log=False, device="cpu")
    assert bab.ub < 1e19
    assert bab.lb <= bab.ub + 1e-6


def test_water_network():
    bab = _port("water_network").main(log=False, device="cpu")
    # Haverly pooling: global optimum profit 400; lb must stay sound
    assert bab.lb <= -400.0 + 1e-4
    assert bab.ub == pytest.approx(-400.0, abs=1e-3)


def test_benders_demo():
    from minotaur_tpu_torch.engines.ipm import build_batch_solver
    mod = _port("benders_demo")
    y, cost = mod.main(log=False, device="cpu")
    # brute-force the tiny instance with the demo's own subproblem pricer
    sub = mod._build_sub()
    solve = build_batch_solver(sub, device="cpu")
    nf = len(mod.F_COST)
    best = np.inf
    for mask in range(2 ** nf):
        yy = np.array([(mask >> i) & 1 for i in range(nf)], float)
        tot = float(mod.F_COST @ yy)
        for s in range(len(mod.PROBS)):
            clb = np.concatenate([mod.DEMANDS[s], -mod.CAP * yy])
            r = solve(sub.A, clb, sub.cub, sub.vlb[None, :],
                      sub.vub[None, :])
            tot += float(mod.PROBS[s]) * float(r.obj[0])
        best = min(best, tot)
    assert cost == pytest.approx(best, rel=1e-5)

