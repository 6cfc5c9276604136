"""Options of the port's `BranchAndBound` that the main path leaves off,
against the JAX package on the CPU.

- SOS1 (tests/test_sos.py's model: max x0+x1+x2 with at most one
  nonzero, optimum -1) and SOS2 (five weights under a 1.5 budget, at
  most two adjacent nonzeros, optimum -5): SOLVED_OPTIMAL at the optimum
  within 1e-6, the same ub (1e-9 relative) and node count as the JAX
  driver, and a solution that keeps the set.
- `brancher weak` (reduced-cost pricing of one lane-batched linear FBBT
  sweep over 2K child boxes): on tests/test_branchers_weak.py's integer
  knapsack under `dtype f64`, the same sequence of branching variables
  and the same node count and ub as the JAX driver.
- The root heuristics (`divheur`, `msheur`, `samplingheur`,
  `fixvarsheur`), as tests/test_heuristics2.py runs the last two: each on
  its own reaches the MILP's optimum -6 within 1e-6 and the JAX driver's
  ub, and the incumbent the heuristic itself found equals the JAX one's.
- `dtype f32` (the light phase and the f32 tail corrections): the
  correlated knapsack(20) at its DP optimum within 1e-6 relative and at
  the JAX driver's ub within 1e-9 relative.
- OBBT: the bounds of one lane-batched solve of 2n LPs equal the JAX
  package's within 1e-7 and the same count of tightened bounds, on
  facloc_4x8a (nothing to tighten) and on a seeded model whose linear
  rows cut its box; and `obbt 1` in the driver matches JAX's ub.
"""

import numpy as np
import pytest
import torch

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.ir.functions import Function, LinearFunction
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import SolveStatus, VarType

from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
from minotaur_tpu.ir import functions as jfun
from minotaur_tpu.ir import problem as jprob
from minotaur_tpu.utils.environment import Environment as JEnv
from minotaur_tpu.utils import types as jtypes

INF = float("inf")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(cls=Environment, **opts):
    env = cls()
    env.set_option("log_level", 1)
    for k, v in opts.items():
        env.set_option(k, v)
    return env


# model builders take the package's (Problem, Function, LinearFunction,
# VarType) so both packages build the same model from the same numbers
PORT = (Problem, Function, LinearFunction, VarType)
JAX = (jprob.Problem, jfun.Function, jfun.LinearFunction, jtypes.VarType)


def _sos(kind, mods):
    P, F, L, _ = mods
    if kind == "sos1":
        c, w, cap = [-1.0, -1.0, -1.0], [1.0, 2.0, 3.0], None
    else:
        c, w, cap = [-1.0, -3.0, -2.0, -4.0, -1.0], \
            [1.0, 2.0, 3.0, 4.0, 5.0], 1.5
    p = P(kind)
    for _ in c:
        p.new_variable(0.0, 1.0)
    if cap is not None:
        p.new_constraint(F(lf=L({j: 1.0 for j in range(len(c))})),
                         -INF, cap, "cap")
    p.new_objective(F(lf=L(dict(enumerate(c)))))
    getattr(p, "_" + kind).append((w, list(range(len(c)))))
    return p


@pytest.mark.parametrize("kind,opt", [("sos1", -1.0), ("sos2", -5.0)])
def test_sos_branching_matches_jax(kind, opt):
    pb = BranchAndBound(_sos(kind, PORT), _env(node_batch=4), device="cpu")
    assert pb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert pb.ub == pytest.approx(opt, abs=1e-6)
    nz = np.where(np.abs(pb.best_x) > 1e-6)[0]
    if kind == "sos1":
        assert len(nz) <= 1
    else:
        assert len(nz) <= 2 and (len(nz) < 2 or nz[1] - nz[0] == 1)
    jb = JaxBnB(_sos(kind, JAX), _env(JEnv, node_batch=4))
    assert jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(pb.ub - jb.ub) <= 1e-9 * (1 + abs(opt))
    assert pb.stats.nodes_processed == jb.stats.nodes_processed


def _intknap(mods, n=12, m=5, seed=1, ub=4):
    """tests/test_branchers_weak.py's integer knapsack."""
    P, F, L, V = mods
    rng = np.random.default_rng(seed)
    w = rng.integers(3, 12, size=(m, n)).astype(float)
    cap = w.sum(axis=1) * 0.9
    c = rng.uniform(2, 9, size=n)
    p = P("intknap")
    for j in range(n):
        p.new_variable(0, ub, V.INTEGER, f"x{j}")
    for i in range(m):
        p.new_constraint(F(lf=L({j: float(w[i, j]) for j in range(n)})),
                         -INF, float(cap[i]), f"k{i}")
    p.new_objective(F(lf=L({j: -float(c[j]) for j in range(n)})))
    return p


def _record_weak(bab):
    picks = []
    inner = bab._weak_select

    def rec(*args):
        j = inner(*args)
        picks.append(int(j))
        return j
    bab._weak_select = rec
    return picks


def test_weak_brancher_matches_jax():
    opts = dict(brancher="weak", node_batch=4, dtype="f64")
    pb = BranchAndBound(_intknap(PORT), _env(**opts), device="cpu")
    jb = JaxBnB(_intknap(JAX), _env(JEnv, **opts))
    p_picks, j_picks = _record_weak(pb), _record_weak(jb)
    assert pb.solve() == jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert len(p_picks) > 10
    assert p_picks == j_picks
    assert pb.stats.nodes_processed == jb.stats.nodes_processed
    assert abs(pb.ub - jb.ub) <= 1e-9 * (1 + abs(jb.ub))


def _milp(mods):
    """tests/test_heuristics2.py's MILP (optimum -6)."""
    P, F, L, V = mods
    p = P("milp")
    p.new_variable(0, 1, V.BINARY)
    p.new_variable(0, 1, V.BINARY)
    p.new_variable(0, 4)
    p.new_constraint(F(lf=L({0: 3.0, 1: 5.0, 2: 1.0})), -INF, 7.0)
    p.new_constraint(F(lf=L({0: 1.0, 1: 1.0})), 1.0, INF)
    p.new_objective(F(lf=L({0: -2.0, 1: -3.0, 2: -1.0})))
    return p


def _first_incumbent(bab):
    found = []
    inner = bab._accept_incumbent

    def rec(x, val, *a, **k):
        ok = inner(x, val, *a, **k)
        if ok and not found:
            found.append(float(val))
        return ok
    bab._accept_incumbent = rec
    return found


@pytest.mark.parametrize("heur", ["divheur", "msheur", "samplingheur",
                                  "fixvarsheur"])
def test_root_heuristic_matches_jax(heur):
    opts = {heur: 1, "node_batch": 4}
    pb = BranchAndBound(_milp(PORT), _env(**opts), device="cpu")
    jb = JaxBnB(_milp(JAX), _env(JEnv, **opts))
    p_first, j_first = _first_incumbent(pb), _first_incumbent(jb)
    assert pb.solve() == jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert pb.ub == pytest.approx(-6.0, abs=1e-6)
    assert abs(pb.ub - jb.ub) <= 1e-9 * 7
    assert p_first and j_first
    assert p_first[0] == pytest.approx(j_first[0], abs=1e-6)


def test_dtype_f32_at_oracle_and_jax():
    from minotaur_tpu.models.generators import correlated_knapsack as jck
    from minotaur_tpu_torch.models.generators import (correlated_knapsack,
                                                      knapsack_dp_optimum)
    opt = knapsack_dp_optimum(20, 1)
    pb = BranchAndBound(correlated_knapsack(20, 1), _env(dtype="f32"),
                        device="cpu")
    assert pb._step_opts.ipm.light_phase1 and pb._step_opts.ipm.tail_corr_f32
    assert pb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(pb.ub - opt) <= 1e-6 * (1 + abs(opt))
    jb = JaxBnB(jck(20, 1), _env(JEnv, dtype="f32"))
    assert jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(pb.ub - jb.ub) <= 1e-9 * (1 + abs(opt))


def _boxed_lp(mods, seed=3, n=8, m=5):
    """Seeded rows over a [0, 10] box whose rows cut the box (OBBT has
    something to tighten); every third variable integer."""
    P, F, L, V = mods
    rng = np.random.default_rng(seed)
    A = np.abs(rng.normal(size=(m, n))).round(2) + 0.1
    p = P(f"boxed{seed}")
    for j in range(n):
        p.new_variable(0.0, 10.0, V.INTEGER if j % 3 == 0 else
                       V.CONTINUOUS, f"x{j}")
    for i in range(m):
        p.new_constraint(F(lf=L({j: float(A[i, j]) for j in range(n)})),
                         -INF, float(rng.uniform(3.0, 6.0)), f"r{i}")
    p.new_objective(F(lf=L({j: -float(c) for j, c in
                            enumerate(rng.uniform(0.5, 2.0, size=n))})))
    return p


def _obbt_pair(make_port, make_jax):
    from minotaur_tpu.bnb.presolve import Presolver as JPre
    from minotaur_tpu.engines.staging import stage_problem as jstage
    from minotaur_tpu_torch.bnb.presolve import Presolver
    from minotaur_tpu_torch.engines.staging import stage_problem
    pp, jp = make_port(), make_jax()
    sp, jsp = stage_problem(pp), jstage(jp)
    pre, jpre = Presolver(pp, sp, device="cpu"), JPre(jp, jsp)
    lo, hi = pre.obbt(sp.vlb.copy(), sp.vub.copy())
    jlo, jhi = jpre.obbt(jsp.vlb.copy(), jsp.vub.copy())
    return (lo, hi, pre.stats.obbt_tightened), \
        (np.asarray(jlo), np.asarray(jhi), jpre.stats.obbt_tightened)


@pytest.mark.parametrize("model", ["facloc_4x8a", "boxed_lp"])
def test_obbt_matches_jax(model):
    if model == "boxed_lp":
        port, jax_ = _obbt_pair(lambda: _boxed_lp(PORT),
                                lambda: _boxed_lp(JAX))
        assert port[2] > 0
    else:
        from minotaur_tpu.models.convex_suite import SUITE as JS
        from minotaur_tpu_torch.models.convex_suite import SUITE
        port, jax_ = _obbt_pair(SUITE[model][0], JS[model][0])
    assert port[2] == jax_[2]
    for a, b in zip(port[:2], jax_[:2]):
        assert np.array_equal(np.isfinite(a), np.isfinite(b))
        fin = np.isfinite(a)
        np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=1e-7)


def test_obbt_option_matches_jax():
    pb = BranchAndBound(_boxed_lp(PORT), _env(obbt=1), device="cpu")
    jb = JaxBnB(_boxed_lp(JAX), _env(JEnv, obbt=1))
    assert pb.solve() == jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(pb.ub - jb.ub) <= 1e-9 * (1 + abs(jb.ub))
