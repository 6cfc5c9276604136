"""The port's example gallery, LP/QP B&B and NL scripts, on the CPU.

Each script of `minotaur_tpu_torch/examples/` runs with `device="cpu"` at
the arguments `tests/test_examples.py` gives the JAX package's script,
under the same assertions.  The six scripts that read a .nl file get
`batchdes_like()` (`models/convex_suite.py`, the batchdes_a suite row:
two integers, two continuous log-volumes, an exp objective) written by
the port's `io/nl_writer.py`, whose exact optimum `batchdes_like_optimum`
takes the place of nvs08's 23.449673; its continuous relaxation is held
to scipy's SLSQP on the same problem (within 1e-6).  `simple_bnb` is
also held to the JAX script at the same arguments (slow: the JAX side
compiles).
"""

import importlib
import os

import numpy as np
import pytest

from minotaur_tpu_torch.io.nl_writer import write_nl
from minotaur_tpu_torch.models.convex_suite import (batchdes_like,
                                                    batchdes_like_optimum)
from minotaur_tpu_torch.utils.types import SolveStatus

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


@pytest.fixture(scope="module")
def nl_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("examples") / "batchdes_a.nl")
    write_nl(batchdes_like(), path)
    return path


OPT = batchdes_like_optimum()


def _relaxation_optimum(p):
    """Continuous relaxation of `p` by SLSQP from the box midpoint (the
    instance is convex, so the local optimum is the global one)."""
    from scipy.optimize import minimize
    lo, hi = p.var_bounds()
    clb = np.array([c.lb for c in p.cons])
    cub = np.array([c.ub for c in p.cons])
    cons = []
    for bnd, sign in ((clb, 1.0), (cub, -1.0)):
        keep = np.isfinite(bnd)
        if keep.any():
            cons.append(dict(type="ineq", fun=lambda x, b=bnd, s=sign, k=keep:
                             s * (p.eval_constraints(x)[k] - b[k])))
    r = minimize(p.eval_objective, 0.5 * (lo + hi), method="SLSQP",
                 bounds=list(zip(lo, hi)), constraints=cons,
                 options=dict(ftol=1e-14, maxiter=500))
    assert r.success, r.message
    return float(r.fun)


def test_simple_bnb():
    bab = _port("simple_bnb").main(node_batch=4, log_level=1, device="cpu")
    assert bab.ub < 1e19 and bab.best_x is not None


@pytest.mark.slow
def test_simple_bnb_matches_jax():
    pb = _port("simple_bnb").main(node_batch=4, log_level=1, device="cpu")
    jb = _jax("simple_bnb").main(node_batch=4, log_level=1)
    assert pb.status == jb.status
    assert abs(pb.ub - jb.ub) <= 1e-9 * (1 + abs(jb.ub))
    np.testing.assert_allclose(pb.best_x, jb.best_x, atol=1e-6)


def test_knapsack_qp():
    mod = _port("knapsack_qp")
    bab = mod.main(device="cpu")
    p, w, cap = mod.build()
    best = np.inf
    for mask in range(2 ** len(w)):
        x = np.array([(mask >> j) & 1 for j in range(len(w))], float)
        if w @ x <= cap:
            best = min(best, p.eval_objective(x))
    assert bab.status == SolveStatus.SOLVED_OPTIMAL
    assert bab.ub == pytest.approx(best, abs=1e-6)


def test_batched_engine(nl_path):
    res = _port("batched_engine").main(nl_path, batch=4, device="cpu")
    assert np.asarray(res.status).shape == (4,)
    # lane 0 is the root box: its objective is the continuous relaxation
    obj0, _ = _port("root_relaxation").main(nl_path, log=False,
                                            device="cpu")
    assert float(res.obj[0]) == pytest.approx(obj0, abs=1e-9)


def test_root_relaxation(nl_path):
    from minotaur_tpu_torch.io.nl_reader import read_nl
    obj0, obj1 = _port("root_relaxation").main(nl_path, log=False,
                                               device="cpu")
    assert obj0 == pytest.approx(_relaxation_optimum(read_nl(nl_path)),
                                 abs=1e-6)
    # the down-branch can only raise the bound
    assert obj1 >= obj0 - 1e-7


def test_custom_brancher():
    results = _port("custom_brancher").main(node_batch=8, log=False,
                                            device="cpu")
    ubs = {rule: ub for rule, (ub, _) in results.items()}
    assert set(results) == {"maxvio", "lexico", "random"}
    # every rule must land on the same optimum
    assert max(ubs.values()) - min(ubs.values()) < 1e-5


def test_reliability_branching_demo():
    st, ub, probes = _port("reliability_branching_demo").main(
        log=False, device="cpu")
    assert st == SolveStatus.SOLVED_OPTIMAL
    assert probes > 0


def test_checkpoint_resume(nl_path):
    bab2 = _port("checkpoint_resume").main(nl_path, log_level=1,
                                           device="cpu")
    assert bab2.ub == pytest.approx(OPT, abs=1e-4)


def test_solve_nl(nl_path):
    bab = _port("solve_nl").main(nl_path, device="cpu")
    assert bab.status == SolveStatus.SOLVED_OPTIMAL
    assert abs(bab.ub - OPT) <= 1e-6 * (1 + abs(OPT))
    assert bab.lb <= OPT + 1e-6 * (1 + abs(OPT))


def test_nl_roundtrip(nl_path):
    p2 = _port("nl_roundtrip").main(nl_path)
    assert p2.n_vars > 0


def test_expr_dag_demo():
    val, grad, (nlo, nhi) = _port("expr_dag_demo").main(log=False,
                                                        device="cpu")
    assert val == pytest.approx(np.exp(0.5) + 2.0, abs=1e-10)
    assert grad[2] == pytest.approx(0.5, abs=1e-10)


def test_polynomial_demo():
    poly = _port("polynomial_demo").main()
    assert poly.degree() == 3


def test_quad_socp():
    bab = _port("quad_socp").main(node_batch=4, log=False, device="cpu")
    assert bab.ub == pytest.approx(-4.0, abs=1e-5)


def test_qpd_processor_demo(nl_path):
    st, ub, verified = _port("qpd_processor_demo").main(nl_path, log=False,
                                                        device="cpu")
    assert st == SolveStatus.SOLVED_OPTIMAL
    assert abs(ub - OPT) < 1e-4
    assert verified > 0


def test_qpdive_demo():
    cands = _port("qpdive_demo").main(log=False, device="cpu")
    assert cands, "QP diving found no feasible candidate"
    x, val = cands[0]
    assert np.isfinite(val)
