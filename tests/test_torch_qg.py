"""The port's QG branch-and-cut (bnb/qg.py) against the JAX package's, on
the CPU.

- The cut generator: objective values and gradients, nonlinear row
  values and Jacobians on a seeded batch of points, to rel 1e-10
  (st_e14a: two exp rows; normcon(20): one dense quadratic row).
- The root: after `_qg_root` on st_e14a both packages hold the same
  number of cuts, with rows and bounds within 1e-6 relative, and the
  same eta/root floor.
- A stale master: a cut written into the pool after a superstep reaches
  the next superstep's solve (the device copies of the master arrays
  follow the cut epoch).
- Full solves: `QGBranchAndBound` on st_e14a and st_e14b reaches the
  suite's exact oracle and the JAX driver's ub, both within
  1e-6 * (1 + |opt|).  Both packages run at node_batch 16, pad_full 1
  (one padded bucket, so the JAX driver compiles its superstep once).
"""

import numpy as np
import pytest
import torch

from minotaur_tpu.bnb.qg import QGBranchAndBound as JaxQG
from minotaur_tpu.models.convex_suite import SUITE as JSUITE
from minotaur_tpu.utils.environment import Environment as JEnv
from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
from minotaur_tpu_torch.models.convex_suite import SUITE, normcon
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


OPTS = dict(log_level=1, node_batch=16, pad_full=1)


def _env(cls=Environment, **opts):
    env = cls()
    for k, v in {**OPTS, **opts}.items():
        env.set_option(k, v)
    return env


def _pair(make_j, make_t, **opts):
    """(JAX QG, port QG) on the same problem."""
    return (JaxQG(make_j(), _env(JEnv, **opts)),
            QGBranchAndBound(make_t(), _env(**opts), device="cpu"))


def _gens(name):
    if name == "normcon_20":
        from minotaur_tpu.models.convex_suite import normcon as jnormcon
        return (lambda: jnormcon(20, 0)), (lambda: normcon(20, 0))
    return JSUITE[name][0], SUITE[name][0]


@pytest.mark.parametrize("name", ["st_e14a", "normcon_20"])
def test_cut_gen_matches_jax(name):
    jb, tb = _pair(*_gens(name))
    sp = tb.sp_orig
    rng = np.random.default_rng(3)
    lo = np.where(np.isfinite(sp.vlb), sp.vlb, -2.0)
    hi = np.where(np.isfinite(sp.vub), sp.vub, 2.0)
    pts = lo + rng.uniform(size=(7, sp.n)) * (hi - lo)
    jo, to = jb._cut_gen(pts), tb._cut_gen(pts)
    assert sorted(to) == sorted(jo) == ["Jg", "f", "g", "gf"]
    for key in jo:
        ref = np.asarray(jo[key])
        assert to[key].shape == ref.shape, key
        # rel 1e-10 of the largest entry of each field
        np.testing.assert_allclose(to[key], ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max(),
                                   err_msg=key)


def test_root_cut_pool_matches_jax():
    jb, tb = _pair(*_gens("st_e14a"))
    assert jb._qg_root() is None and tb._qg_root() is None
    assert tb.n_cuts == jb.n_cuts > 0
    assert tb.qg_stats.cuts_added == jb.qg_stats.cuts_added
    rows = slice(tb._cut_base, tb._cut_base + tb.n_cuts)
    np.testing.assert_allclose(tb.mA[rows], jb.mA[rows], rtol=1e-6,
                               atol=1e-6 * np.abs(jb.mA[rows]).max())
    for port, ref in ((tb.mclb[rows], jb.mclb[rows]),
                      (tb.mcub[rows], jb.mcub[rows])):
        assert np.array_equal(np.isfinite(port), np.isfinite(ref))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(port[fin], ref[fin], rtol=1e-6,
                                   atol=1e-6)
    # the unused pool rows stay disabled
    assert np.all(np.isinf(tb.mcub[tb._cut_base + tb.n_cuts:]))
    assert tb._root_lb0 == pytest.approx(jb._root_lb0, rel=1e-6)


def test_cut_after_first_superstep_reaches_next_solve():
    """Write a cut into the pool between two supersteps of the same box:
    the second solve must see it.  Objective cut c.x >= obj1 + 0.1 cuts
    off the first optimum, so the second objective rises by 0.1."""
    tb = QGBranchAndBound(SUITE["st_e14a"][0](), _env(), device="cpu")
    assert tb._qg_root() is None
    assert tb._root_presolve() is None
    sp = tb.sp
    box = (sp.vlb[None, :], sp.vub[None, :], np.zeros((1, sp.n)))
    r1 = tb._run_step(*box)
    assert int(r1.status[0]) == 1
    obj1 = float(r1.obj[0])
    n0 = tb.n_cuts
    assert tb._add_cut(-sp.c.copy(), -np.inf, -(obj1 + 0.1))
    assert tb.n_cuts == n0 + 1
    r2 = tb._run_step(*box)
    assert int(r2.status[0]) == 1
    # the new optimum is on the cut, within the mixed-policy IPM's trust
    # margin 10 * tail_tol * (1 + |obj|); a stale master would return obj1
    margin = 1e-4 * (1 + abs(obj1))
    assert float(r2.obj[0]) == pytest.approx(obj1 + 0.1, abs=margin)
    assert float(sp.c @ r2.x[0]) >= obj1 + 0.1 - margin


@pytest.mark.parametrize("name", ["st_e14a", "st_e14b"])
def test_qg_full_solve_matches_jax_and_oracle(name):
    jb, tb = _pair(*_gens(name))
    opt = SUITE[name][1]()
    tol = 1e-6 * (1 + abs(opt))
    assert tb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(tb.ub - opt) <= tol
    assert tb.lb == tb.ub
    assert tb.problem.is_feasible(tb.best_x, atol=1e-5)
    assert tb.qg_stats.nlp_solves > 0 and tb.qg_stats.cuts_added > 0
    assert jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(tb.ub - jb.ub) <= tol
