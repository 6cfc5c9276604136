"""The port's primal heuristics (bnb/heuristics.py) against the JAX
package's, on the CPU.

- The dive scheme library: `dive_scheme_for_lane`, `dive_scores`,
  `dive_round` and `DiveBacktrack` give equal results on seeded random
  arrays (exact: both are the same numpy code).
- `SamplingHeur` returns the same candidates from the same seed (exact).
- `FixVarsHeur` on st_e14a (one lane-batched fix-and-solve of 8
  fixings): the same feasible candidates, objectives within 1e-6
  relative.
- The feasibility pump, run by QG after its root on st_e14a from the
  same start in both packages: each harvests an incumbent that is
  feasible for the problem (1e-5), and the two incumbents' values agree
  within 1e-6 * (1 + |ub|).
"""

import numpy as np
import pytest
import torch

from minotaur_tpu.bnb import heuristics as jh
from minotaur_tpu.bnb.qg import QGBranchAndBound as JaxQG
from minotaur_tpu.engines.staging import stage_problem as jax_stage
from minotaur_tpu.models.convex_suite import SUITE as JSUITE
from minotaur_tpu.utils.environment import Environment as JEnv
from minotaur_tpu_torch.bnb import heuristics as th
from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.models.convex_suite import SUITE
from minotaur_tpu_torch.utils.environment import Environment


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These problems have at most a few dozen variables: intra-op threads
    only contend with the other test workers, so the port runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(cls, **opts):
    env = cls()
    for k, v in dict(log_level=1, node_batch=16, pad_full=1, **opts).items():
        env.set_option(k, v)
    return env


@pytest.mark.parametrize("scheme", ["frac", "veclen", "lex", "rcost"])
def test_dive_scores_and_rounding_equal(scheme):
    rng = np.random.default_rng(11)
    n = 40
    x = rng.uniform(-3, 3, n)
    ints = np.sort(rng.choice(n, 25, replace=False))
    frac = np.abs(x[ints] - np.round(x[ints]))
    args = (x, ints, frac, rng.normal(size=n), rng.integers(0, 6, n) * 1.0,
            rng.normal(size=n))
    assert np.array_equal(th.dive_scores(scheme, *args),
                          jh.dive_scores(scheme, *args))
    for lane in range(9):
        for opt in ("auto", scheme):
            assert th.dive_scheme_for_lane(opt, lane) == \
                jh.dive_scheme_for_lane(opt, lane)
    for direction in ("nearest", "ceil", "floor", "farthest"):
        assert np.array_equal(th.dive_round(direction, x, 1e-6),
                              jh.dive_round(direction, x, 1e-6))


def test_dive_backtrack_equal():
    rng = np.random.default_rng(5)
    n = 12
    tb, jb = th.DiveBacktrack(), jh.DiveBacktrack()
    lo, hi = np.zeros(n), np.full(n, 4.0)
    for step in range(30):
        if rng.uniform() < 0.6:
            pick = rng.choice(n, 3, replace=False)
            v = rng.integers(0, 5, 3).astype(float)
            tb.push(lo, hi, pick, v)
            jb.push(lo, hi, pick, v)
            lo, hi = lo.copy(), hi.copy()
            lo[pick] = hi[pick] = v
        else:
            xl = rng.uniform(0, 4, n)
            a, b = tb.on_death(xl), jb.on_death(xl)
            assert (a is None) == (b is None), step
            if a is not None:
                assert np.array_equal(a[0], b[0]) and \
                    np.array_equal(a[1], b[1])
                lo, hi = a[0].copy(), a[1].copy()
            else:
                lo, hi = np.zeros(n), np.full(n, 4.0)


def test_sampling_heur_equal():
    tp, jp = SUITE["st_e14a"][0](), JSUITE["st_e14a"][0]()
    ts = th.SamplingHeur(tp, stage_problem(tp), seed=4, n_samples=128)
    js = jh.SamplingHeur(jp, jax_stage(jp), seed=4, n_samples=128)
    vlb, vub = tp.var_bounds()
    around = np.array([0.5, 0.5, 0.0, 1.0, 1.0])
    a, b = ts.run(vlb, vub, around), js.run(vlb, vub, around)
    assert len(a) == len(b) > 0
    for (xa, va), (xb, vb) in zip(a, b):
        assert np.array_equal(xa, xb) and va == vb


def test_fixvars_heur_matches_jax():
    tp, jp = SUITE["st_e14a"][0](), JSUITE["st_e14a"][0]()
    tf = th.FixVarsHeur(tp, stage_problem(tp), seed=2, device="cpu")
    jf = jh.FixVarsHeur(jp, jax_stage(jp), seed=2)
    vlb, vub = tp.var_bounds()
    x_ref = np.array([0.3, 0.4, 0.2, 0.7, 0.6])
    a, b = tf.run(vlb, vub, x_ref), jf.run(vlb, vub, x_ref)
    assert len(a) == len(b) > 0
    for (xa, va), (xb, vb) in zip(a, b):
        assert tp.is_feasible(xa, atol=1e-5)
        assert va == pytest.approx(vb, rel=1e-6, abs=1e-6)


def test_pump_finds_feasible_point_in_both_packages():
    tb = QGBranchAndBound(SUITE["st_e14a"][0](), _env(Environment),
                          device="cpu")
    jb = JaxQG(JSUITE["st_e14a"][0](), _env(JEnv))
    start = np.full(5, 0.5)
    for b in (tb, jb):
        assert b._qg_root() is None
        assert b._fp is not None
        b._run_pump(start)
        assert np.isfinite(b.ub), type(b).__module__
        assert b.problem.is_feasible(b.best_x, atol=1e-5)
        assert b.ub == pytest.approx(float(b.problem.eval_objective(b.best_x)))
    assert abs(tb.ub - jb.ub) <= 1e-6 * (1 + abs(jb.ub))
