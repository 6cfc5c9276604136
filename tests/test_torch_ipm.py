"""The batched LP/QP IPM: `build_batch_solver` of both packages on the
same staged problem and the same B=8 lanes of bound boxes.

Lanes: the root box, five seeded sub-boxes (random integer fixings), one
empty box and one box that no point of the linear rows meets (the IPM
must prove it with a Farkas certificate).  Problems cover the x-space
path (convex MIQP, intquad), the m-space path (a one-row knapsack MILP)
and the equality Schur block (an LP with m >= n and equality rows).

Two dtype policies, two sets of tolerances:
- f64 factorizations (the driver's dtype=f64): both packages run the
  same float64 arithmetic with sums in other orders, so every lane
  follows the same path.  Held to: statuses and iteration counts equal;
  SOLVED_OPTIMAL objectives within 1e-6 * (1 + |obj|); the port's dual
  bound at most 1e-6 * (1 + |obj|) above its objective and within
  1e-5 * (1 + |obj|) of the JAX bound.
- mixed (the default and the main path: f32 factors, f64 corrections).
  The f32 factor's rounding differs between the packages' LAPACKs, and
  near the f32 floor the iteration amplifies it: a lane that floors
  near tail_tol (1e-5) can end OPTIMAL in one package and
  ITERATION_LIMIT in the other.  Held to: infeasible lanes proven
  infeasible by both; the root lane SOLVED_OPTIMAL in the port; the
  port optimal on more than half of the lanes JAX solves to optimality
  (where JAX solves any: on eqlp its root lane stalls, the port's not);
  the port's bound sound against its own objective (1e-6 * (1 + |obj|))
  and never above the JAX optimum by more than the IPM's own trust
  margin, 10 * tail_tol * (1 + |obj|); objectives of lanes optimal in
  both within that margin.
"""

import numpy as np
import pytest
import torch

from minotaur_tpu.engines.ipm import IPMOptions as JOpts
from minotaur_tpu.engines.ipm import build_batch_solver as jax_solver
from minotaur_tpu.engines.staging import stage_problem as jax_stage
from minotaur_tpu.ir.functions import Function, LinearFunction
from minotaur_tpu.ir.problem import Problem
from minotaur_tpu.models import generators as G
from minotaur_tpu.models.convex_suite2 import intquad
from minotaur_tpu.utils.types import VarType
from minotaur_tpu_torch.convert import staged_fields, staged_from_numpy
from minotaur_tpu_torch.engines.ipm import IPMOptions, build_batch_solver

B = 8


def eq_lp(seed=0, n=6, m=8):
    """LP with m >= n (x-space), two equality rows (Schur block); row 0 has
    positive coefficients so a raised box can make it infeasible."""
    rng = np.random.default_rng(seed)
    xs = rng.uniform(1.0, 4.0, size=n)
    A = rng.normal(size=(m, n)).round(3)
    A[0] = np.abs(A[0]) + 0.5
    p = Problem(f"eqlp{seed}")
    for j in range(n):
        p.new_variable(0.0, 6.0, VarType.INTEGER if j < 2 else
                       VarType.CONTINUOUS, f"x{j}")
    for i in range(m):
        act = float(A[i] @ xs)
        lo, hi = (act, act) if i < 2 else (-np.inf, act + rng.uniform(0.5, 2))
        p.new_constraint(Function(lf=LinearFunction(
            {j: float(A[i, j]) for j in range(n)})), lo, hi, f"r{i}")
    p.new_objective(Function(lf=LinearFunction(
        {j: float(c) for j, c in enumerate(rng.normal(size=n))})))
    return p


def _infeasible_box(name, vlb, vub):
    lo, hi = vlb.copy(), vub.copy()
    if name == "eqlp":
        lo[:] = np.minimum(vub, 5.5)        # row 0 (positive) overshoots
    else:
        lo[:] = vub                          # every item / coordinate at max
    return lo, hi


CASES = {
    "cmiqp": lambda: G.convex_miqp(4, 4, 0),
    "intquad": lambda: intquad(16, 4, 1),
    "cknap": lambda: G.correlated_knapsack(12, 2),
    "eqlp": lambda: eq_lp(0),
}


def _lanes(sp, name, seed=0):
    rng = np.random.default_rng(seed)
    lo = np.tile(sp.vlb, (B, 1))
    hi = np.tile(sp.vub, (B, 1))
    ints = np.where(sp.int_mask)[0]
    for b in range(1, 6):
        pick = rng.choice(ints, size=min(len(ints), b), replace=False)
        v = np.floor(rng.uniform(sp.vlb[pick], sp.vub[pick] + 1))
        v = np.clip(v, sp.vlb[pick], sp.vub[pick])
        lo[b, pick] = v
        hi[b, pick] = v
    lo[6, 0] = hi[6, 0] + 1.0                # empty box
    lo[7], hi[7] = _infeasible_box(name, sp.vlb, sp.vub)
    return lo, hi


F64_POLICY = dict(factor_f32=False, tail_factor_f32=False)


def _both(name, seed=0, **kw):
    jsp = jax_stage(CASES[name]())
    sp = staged_from_numpy(staged_fields(jsp))
    lo, hi = _lanes(sp, name, seed)
    jr = jax_solver(jsp, JOpts(**kw))(jsp.A, jsp.clb, jsp.cub, lo, hi)
    pr = build_batch_solver(sp, IPMOptions(**kw), device="cpu")(
        sp.A, sp.clb, sp.cub, lo, hi)
    assert pr.x.shape == (B, sp.n) and pr.y.shape == (B, sp.m)
    return jr, pr


def _infeasible_lanes_agree(jr, pr):
    ps = np.asarray(pr.status)
    assert ps[6] == 2 and ps[7] == 2 and np.asarray(jr.status)[6:].tolist() == [2, 2]
    assert np.all(pr.dual_bound[6:] >= 1e19)
    assert pr.kkt_err[7] == -2.0            # the Farkas exit


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_solver_matches_jax_f64_policy(name):
    jr, pr = _both(name, **F64_POLICY)
    js, ps = np.asarray(jr.status), np.asarray(pr.status)
    assert ps.tolist() == js.tolist(), (ps, js)
    assert np.asarray(pr.iters).tolist() == np.asarray(jr.iters).tolist()
    assert ps[0] == 1
    _infeasible_lanes_agree(jr, pr)
    scale = 1.0 + np.abs(pr.obj)
    opt = ps == 1
    np.testing.assert_array_less(np.abs(pr.obj - np.asarray(jr.obj))[opt],
                                 1e-6 * scale[opt])
    feas = ps != 2
    assert np.all(pr.dual_bound[feas] <= pr.obj[feas] + 1e-6 * scale[feas])
    np.testing.assert_array_less(
        np.abs(pr.dual_bound - np.asarray(jr.dual_bound))[feas],
        1e-5 * scale[feas])


def _mixed_policy_holds(jr, pr):
    """The mixed-policy holdings (module docstring)."""
    _infeasible_lanes_agree(jr, pr)
    ps, js = np.asarray(pr.status), np.asarray(jr.status)
    margin = 10 * IPMOptions().tail_tol * (1.0 + np.abs(pr.obj))
    feas = ps != 2
    assert np.array_equal(feas, js != 2)
    assert np.all(pr.dual_bound[feas] <=
                  pr.obj[feas] + 1e-6 * (1.0 + np.abs(pr.obj[feas])))
    assert ps[0] == 1
    jopt = js == 1
    assert np.all(pr.dual_bound[jopt] <= np.asarray(jr.obj)[jopt] + margin[jopt])
    both = jopt & (ps == 1)
    assert not jopt.any() or 2 * both.sum() > jopt.sum(), (ps, js)
    np.testing.assert_array_less(np.abs(pr.obj - np.asarray(jr.obj))[both],
                                 margin[both])


@pytest.mark.parametrize("name", sorted(CASES))
def test_batch_solver_matches_jax_mixed_policy(name):
    _mixed_policy_holds(*_both(name))


def test_single_solver_with_objective_and_packed_layout():
    from minotaur_tpu_torch.engines.ipm import build_single_solver
    sp = staged_from_numpy(staged_fields(jax_stage(G.convex_miqp(3, 3, 2))))
    solve = build_single_solver(sp, IPMOptions(), device="cpu")
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    lo, hi = t(np.tile(sp.vlb, (2, 1))), t(np.tile(sp.vub, (2, 1)))
    c2 = t(np.stack([sp.c, -sp.c]))
    r = solve.with_objective(t(sp.A), t(sp.clb), t(sp.cub), lo, hi,
                             torch.zeros(2, sp.n), c2)
    assert r.status.tolist() == [1, 1]
    base = build_batch_solver(sp, IPMOptions(), device="cpu")
    packed = base.dispatch(sp.A, sp.clb, sp.cub, lo[:1], hi[:1])
    assert packed.dtype == torch.float64
    assert packed.shape == (1, sp.n + sp.m + 5)
    np.testing.assert_allclose(base.unpack(packed).obj[0], r.obj[0].item(),
                               rtol=1e-12)


def test_out_of_slice_options_raise():
    """Every IPM option of the JAX package is ported (the cases that
    raised are test_ipm_option_matches_jax's); asking for CUDA on a
    machine without it still raises."""
    sp = staged_from_numpy(staged_fields(jax_stage(G.convex_miqp(2, 2, 0))))
    for kw in (dict(light_phase1=True), dict(tail_corr_f32=True),
               dict(gondzio_correctors=1)):
        build_batch_solver(sp, IPMOptions(**kw), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            build_batch_solver(sp, IPMOptions())


@pytest.mark.parametrize("name", ["cmiqp", "cknap"])
@pytest.mark.parametrize("option", ["light_phase1", "tail_corr_f32",
                                    "gondzio_correctors"])
def test_ipm_option_matches_jax(option, name):
    """The three IPM options, on the convex MIQP (x-space) and the
    knapsack LP (m-space).  `light_phase1` (f32 phase-1 arithmetic) and
    `tail_corr_f32` (f32 tail corrections) act only with f32 factors, so
    they are held to the mixed policy's holdings, and on these lanes
    also to the JAX statuses; `gondzio_correctors 2` is held under the f64
    policy to the f64 holdings (same statuses, iterations and objectives
    within 1e-6 * (1 + |obj|))."""
    if option == "gondzio_correctors":
        jr, pr = _both(name, gondzio_correctors=2, **F64_POLICY)
        ps, js = np.asarray(pr.status), np.asarray(jr.status)
        assert ps.tolist() == js.tolist()
        assert np.asarray(pr.iters).tolist() == np.asarray(jr.iters).tolist()
        _infeasible_lanes_agree(jr, pr)
        opt = ps == 1
        np.testing.assert_array_less(
            np.abs(pr.obj - np.asarray(jr.obj))[opt],
            1e-6 * (1.0 + np.abs(pr.obj))[opt])
        # the correctors act (other iterates than without them) and
        # change no status
        _, plain = _both(name, **F64_POLICY)
        assert np.asarray(plain.status).tolist() == ps.tolist()
        assert np.abs(np.asarray(plain.x) - np.asarray(pr.x)).max() > 0
    else:
        jr, pr = _both(name, **{option: True})
        _mixed_policy_holds(jr, pr)
        assert np.asarray(pr.status).tolist() == \
            np.asarray(jr.status).tolist()
