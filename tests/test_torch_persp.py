"""Perspective structure (bnb/persp.py) and QG's perspective cuts and
`persp_ref`, the port against the JAX package, on the CPU.

- `detect_perspective` finds the same rows, binaries and variables on
  the semicontinuous models of tests/test_persp.py, and none where the
  indicator row is missing.
- `perspective_reform` rewrites the same rows into the same expression
  tables and bounds (exact: bnb/persp.py is the JAX package's file).
- QG on the semicontinuous model with `persp_cuts` on and off, and on
  the three-indicator model under `persp_ref` (the reformulation runs
  before staging, inside QG): SOLVED_OPTIMAL at the closed-form optimum,
  and the JAX driver's ub, within 1e-6 * (1 + |opt|).
- The plain B&B takes `persp_ref` (the reformulation at presolve,
  under `nl_presolve`) and `fpump` (accepted, no effect, as in the JAX
  plain driver): on the semicontinuous model it reaches the closed-form
  optimum and the JAX plain driver's ub within 1e-6 * (1 + |opt|); QG
  takes both too.
"""

import math

import numpy as np
import pytest
import torch

import minotaur_tpu.ir.functions as jfun
import minotaur_tpu.ir.problem as jprob
import minotaur_tpu.utils.types as jtypes
import minotaur_tpu_torch.ir.functions as tfun
import minotaur_tpu_torch.ir.problem as tprob
import minotaur_tpu_torch.utils.types as ttypes
from minotaur_tpu.bnb.persp import detect_perspective as jax_detect
from minotaur_tpu.bnb.persp import perspective_reform as jax_reform
from minotaur_tpu.bnb.qg import QGBranchAndBound as JaxQG
from minotaur_tpu.engines.staging import stage_problem as jax_stage
from minotaur_tpu.utils.environment import Environment as JEnv
from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.bnb.persp import detect_perspective, \
    perspective_reform
from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import SolveStatus


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These problems have at most a few dozen variables: intra-op threads
    only contend with the other test workers, so the port runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INF = float("inf")
JAX = (jprob, jfun, jtypes)
PORT = (tprob, tfun, ttypes)


def _semicont(pkg, linked=True):
    """min -x + 0.9 z  s.t.  x^2 <= 2,  x <= 4 z,  x in [0,4], z binary:
    optimum z = 1, x = sqrt(2), 0.9 - sqrt(2)."""
    P, F, T = pkg
    p = P.Problem("semicont")
    p.new_variable(0, 4)
    p.new_variable(0, 1, T.VarType.BINARY)
    qf = F.QuadraticFunction()
    qf.add_term(0, 0, 1.0)
    p.new_constraint(F.Function(qf=qf), -INF, 2.0)
    if linked:
        p.new_constraint(F.Function(lf=F.LinearFunction({0: 1.0, 1: -4.0})),
                         -INF, 0.0)

    p.new_objective(F.Function(lf=F.LinearFunction({0: -1.0, 1: 0.9})))
    return p


def _semicont_multi(pkg, n=3):
    """n on/off rows x_i^2 <= 2 (x_i <= 4 z_i), sum z <= n - 1: optimum
    z = 1 on the two cheapest, x = sqrt(2) there."""
    P, F, T = pkg
    p = P.Problem("semicont_multi")
    for i in range(n):
        p.new_variable(0, 4, T.VarType.CONTINUOUS, f"x{i}")
    for i in range(n):
        p.new_variable(0, 1, T.VarType.BINARY, f"z{i}")
    for i in range(n):
        qf = F.QuadraticFunction()
        qf.add_term(i, i, 1.0)
        p.new_constraint(F.Function(qf=qf), -INF, 2.0, f"q{i}")
        p.new_constraint(F.Function(lf=F.LinearFunction(
            {i: 1.0, n + i: -4.0})), -INF, 0.0, f"link{i}")
    p.new_constraint(F.Function(lf=F.LinearFunction(
        {n + i: 1.0 for i in range(n)})), -INF, float(n - 1), "card")
    p.new_objective(F.Function(lf=F.LinearFunction(
        {**{i: -1.0 for i in range(n)},
         **{n + i: 0.35 + 0.05 * i for i in range(n)}})))
    return p


MULTI_OPT = 2 * (-math.sqrt(2.0)) + 0.35 + 0.40


def _rows(found):
    return [(r.k, r.row, r.z, np.asarray(r.vars).tolist()) for r in found]


@pytest.mark.parametrize("make", [_semicont, _semicont_multi])
def test_detect_perspective_equal(make):
    port = detect_perspective(stage_problem(make(PORT)))
    ref = jax_detect(jax_stage(make(JAX)))
    assert _rows(port) == _rows(ref) and len(port) >= 1
    assert detect_perspective(stage_problem(_semicont(PORT, False))) == []


def test_perspective_reform_equal():
    tp, jp = _semicont_multi(PORT), _semicont_multi(JAX)
    assert perspective_reform(tp) == jax_reform(jp) == 3
    for ct, cj in zip(tp.cons, jp.cons):
        assert (ct.lb, ct.ub) == (cj.lb, cj.ub)
        gt, gj = ct.fun.nlf, cj.fun.nlf
        assert (gt is None) == (gj is None)
        if gt is not None:
            assert gt.root == gj.root
            for a, b in zip(gt.tables, gj.tables):
                assert np.array_equal(a, b)


def _env(cls, **opts):
    env = cls()
    for k, v in dict(log_level=1, node_batch=16, pad_full=1, **opts).items():
        env.set_option(k, v)
    return env


@pytest.mark.parametrize("make,opt,opts", [
    (_semicont, 0.9 - math.sqrt(2.0), dict(persp_cuts=True)),
    (_semicont, 0.9 - math.sqrt(2.0), dict(persp_cuts=False)),
    (_semicont_multi, MULTI_OPT, dict(persp_ref=True)),
])
def test_qg_semicontinuous_matches_jax(make, opt, opts):
    tb = QGBranchAndBound(make(PORT), _env(Environment, **opts),
                          device="cpu")
    if "persp_cuts" in opts:
        assert bool(tb._persp) == opts["persp_cuts"]
    assert tb.solve() == SolveStatus.SOLVED_OPTIMAL
    tol = 1e-6 * (1 + abs(opt))
    assert abs(tb.ub - opt) <= tol
    jb = JaxQG(make(JAX), _env(JEnv, **opts))
    assert jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(tb.ub - jb.ub) <= tol


@pytest.mark.parametrize("name", ["persp_ref", "fpump"])
def test_plain_bnb_still_raises(name):
    """No longer raises: the plain B&B matches the JAX plain driver under
    each option (the name is kept from when both raised)."""
    from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
    opt = 0.9 - math.sqrt(2.0)
    tb = BranchAndBound(_semicont(PORT), _env(Environment, **{name: True}),
                        device="cpu")
    assert tb.solve() == SolveStatus.SOLVED_OPTIMAL
    tol = 1e-6 * (1 + abs(opt))
    assert abs(tb.ub - opt) <= tol
    jb = JaxBnB(_semicont(JAX), _env(JEnv, **{name: True}))
    assert jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(tb.ub - jb.ub) <= tol
    # QG takes both
    QGBranchAndBound(_semicont(PORT), _env(Environment, **{name: True}),
                     device="cpu")
