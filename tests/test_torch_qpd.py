"""The QP-diving module (bnb/qpd.py) and the QPD node processor, against
the JAX package on the CPU: the four cases of tests/test_qpd.py, on the
suite's small MINLPs (tests/test_qpd.py reads nvs08.nl, which this tree
does not have).

- The QP model at a reference point: PSD objective, linearized rows that
  keep each row's slack at the point, and every array equal to the JAX
  package's within 1e-9 (ex1223_a: one nonlinear row).
- A population dive finds a feasible point whose value is not below the
  oracle; its best value equals the JAX diver's within 1e-6 relative.
- `qpdheur 1` and `nodeproc qpd` in the driver: SOLVED_OPTIMAL at the
  oracle within 1e-6 relative and at the JAX driver's ub within 1e-6
  relative; under `nodeproc qpd` the prune guard re-solved lanes on the
  true model (`_qpd_verified > 0`), as many as in the JAX driver, and the
  bound is sound (batchdes_a).
"""

import numpy as np
import pytest
import torch

from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
from minotaur_tpu.bnb.qpd import QPDiver as JaxDiver
from minotaur_tpu.bnb.qpd import build_qp_approx as jax_qp_approx
from minotaur_tpu.engines.staging import stage_problem as jax_stage
from minotaur_tpu.models.convex_suite import SUITE as JSUITE
from minotaur_tpu.utils.environment import Environment as JEnv
from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.bnb.qpd import QPDiver, build_qp_approx
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.models.convex_suite import SUITE
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import SolveStatus


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(cls=Environment, **opts):
    env = cls()
    env.set_option("log_level", 1)
    env.set_option("node_batch", 16)
    for k, v in opts.items():
        env.set_option(k, v)
    return env


def _x0(sp):
    return np.clip(0.5 * (np.clip(sp.vlb, -10, 10) + np.clip(sp.vub, -10, 10)),
                   sp.vlb, sp.vub)


def test_qp_approx_model_matches_jax():
    p = SUITE["ex1223_a"][0]()
    sp = stage_problem(p)
    x0 = _x0(sp)
    qp = build_qp_approx(sp, x0)
    assert len(qp.nl_rows) == 0 and len(sp.nl_rows) > 0
    assert qp.Qobj is None or np.linalg.eigvalsh(qp.Qobj).min() >= -1e-9
    # the linearized rows keep each row's slack at x0
    g_true = sp.constraint_fn()(torch.as_tensor(x0)).numpy()
    g_qp = qp.A @ x0
    for r in sp.nl_rows:
        if np.isfinite(sp.cub[r]):
            assert sp.cub[r] - g_true[r] == pytest.approx(
                qp.cub[r] - g_qp[r], abs=1e-8)
    jqp = jax_qp_approx(jax_stage(JSUITE["ex1223_a"][0]()), x0)
    for f in ("c", "A", "clb", "cub", "vlb", "vub"):
        a, b = getattr(qp, f), np.asarray(getattr(jqp, f))
        assert np.array_equal(np.isfinite(a), np.isfinite(b)), f
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-9, atol=1e-9)
    assert (qp.Qobj is None) == (jqp.Qobj is None)
    if qp.Qobj is not None:
        np.testing.assert_allclose(qp.Qobj, np.asarray(jqp.Qobj), atol=1e-9)


def test_qp_dive_finds_incumbent():
    name = "ex1223_a"
    p = SUITE[name][0]()
    sp = stage_problem(p)
    x0 = _x0(sp)
    out = QPDiver(p, sp, x0, lanes=8, device="cpu").run(sp.vlb, sp.vub, x0)
    assert out, "QP diving found no feasible point"
    x, val = out[0]
    opt = SUITE[name][1]()
    assert p.is_feasible(x, atol=1e-5, int_tol=1e-6)
    assert val >= opt - 1e-6 * (1 + abs(opt))
    jp = JSUITE[name][0]()
    jsp = jax_stage(jp)
    jout = JaxDiver(jp, jsp, x0, lanes=8).run(jsp.vlb, jsp.vub, x0)
    assert jout and val == pytest.approx(jout[0][1], rel=1e-6)


@pytest.mark.parametrize("opts", [dict(qpdheur=1), dict(nodeproc="qpd")],
                         ids=["qpdheur", "nodeproc_qpd"])
def test_qpd_driver_matches_jax(opts):
    name = "batchdes_a"
    opt = SUITE[name][1]()
    pb = BranchAndBound(SUITE[name][0](), _env(**opts), device="cpu")
    assert pb.solve() == SolveStatus.SOLVED_OPTIMAL
    tol = 1e-6 * (1 + abs(opt))
    assert abs(pb.ub - opt) <= tol
    assert pb.lb <= pb.ub + 1e-9
    jb = JaxBnB(JSUITE[name][0](), _env(JEnv, **opts))
    assert jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(pb.ub - jb.ub) <= tol
    if "nodeproc" in opts:
        assert pb._qpd_step is not None and pb._qpd_verified > 0
        assert pb._qpd_verified == jb._qpd_verified
