"""Multistart (bnb/multistart.py), the port against the JAX package, on
the CPU.

- `sample_starts`: equal arrays from the same seed, finite and infinite
  bounds (exact: the same numpy code).
- `multistart_solve` on the continuous relaxations of st_e14a (convex)
  and of a wavy nonconvex NLP (sin(3x) + 0.1 x^2 + (y-1)^2, three local
  minima, tests/test_msbnb.py's model): the same feasible-lane count, the
  same best status, best objectives within 1e-6 * (1 + |obj|).
- `MsBranchAndBound` (restart lanes inside the superstep) on st_e14a
  reaches the suite oracle within 1e-6 * (1 + |opt|).
"""

import numpy as np
import pytest
import torch

import minotaur_tpu.ir.expr as jexpr
import minotaur_tpu.ir.functions as jfun
import minotaur_tpu.ir.problem as jprob
import minotaur_tpu.ops.opcodes as jops
import minotaur_tpu.utils.types as jtypes
import minotaur_tpu_torch.ir.expr as texpr
import minotaur_tpu_torch.ir.functions as tfun
import minotaur_tpu_torch.ir.problem as tprob
import minotaur_tpu_torch.ops.opcodes as tops
import minotaur_tpu_torch.utils.types as ttypes
from minotaur_tpu.bnb import multistart as jms
from minotaur_tpu.engines.staging import stage_problem as jax_stage
from minotaur_tpu.models.convex_suite import SUITE as JSUITE
from minotaur_tpu_torch.bnb import multistart as tms
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.models.convex_suite import SUITE
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


JAX = (jprob, jfun, jexpr, jops, jtypes)
PORT = (tprob, tfun, texpr, tops, ttypes)


def _wavy(pkg):
    P, F, E, O, T = pkg
    p = P.Problem("wavy")
    p.new_variable(-3.0, 3.0)
    p.new_variable(0.0, 2.0, vtype=T.VarType.INTEGER)
    g = E.ExprGraph()
    g.set_root(g.node(O.Op.SIN, g.node(O.Op.MULT, g.num(3.0), g.var(0))))
    qf = F.QuadraticFunction()
    qf.add_term(0, 0, 0.1)
    qf.add_term(1, 1, 1.0)
    p.new_objective(F.Function(lf=F.LinearFunction({1: -2.0}), qf=qf,
                               nlf=g), const=1.0)

    return p


def test_sample_starts_equal():
    vlb = np.array([0.0, -np.inf, -2.0, 1.0])
    vub = np.array([1.0, np.inf, np.inf, 1.0])
    for seed, k in ((0, 9), (5, 16), (2, 1)):
        a = tms.sample_starts(vlb, vub, k, np.random.default_rng(seed))
        b = jms.sample_starts(vlb, vub, k, np.random.default_rng(seed))
        assert np.array_equal(a, b) and np.all(np.isfinite(a))


@pytest.mark.parametrize("name", ["st_e14a", "wavy"])
def test_multistart_solve_matches_jax(name):
    if name == "wavy":
        tp, jp = _wavy(PORT), _wavy(JAX)
    else:
        tp, jp = SUITE[name][0](), JSUITE[name][0]()
    xt, ot, it = tms.multistart_solve(stage_problem(tp), tp, n_starts=16,
                                      seed=1, device="cpu")
    xj, oj, ij = jms.multistart_solve(jax_stage(jp), jp, n_starts=16, seed=1)
    assert xt is not None and xj is not None
    assert it["n_starts"] == ij["n_starts"] == 16
    assert it["n_feasible"] == ij["n_feasible"] > 0
    assert it["best_status"] == ij["best_status"]
    assert abs(ot - oj) <= 1e-6 * (1 + abs(oj))
    assert tp.is_feasible(xt, atol=1e-5, int_tol=np.inf)
    if name == "wavy":
        assert ot < -0.95              # the global basin, near x = -0.512


def test_ms_bnb_reaches_oracle():
    env = Environment()
    for k, v in dict(log_level=1, node_batch=16, msbnb_restarts=4).items():
        env.set_option(k, v)
    gen, oracle, _ = SUITE["st_e14a"]
    bab = tms.MsBranchAndBound(gen(), env, device="cpu")
    opt = oracle()
    assert bab.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(bab.ub - opt) <= 1e-6 * (1 + abs(opt))
