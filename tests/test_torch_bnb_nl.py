"""The port's branch-and-bound on nonlinear problems, on the CPU.

`BranchAndBound(device="cpu")` on five NL rows of the convex suite
(normcon_20a: a quadratic row; expbudget_8a: an exp-sum row; ex1223_a:
exp row and quadratic objective; batchdes_a: exp objective; ball_mk_10a:
a ball row) reaches SOLVED_OPTIMAL with its ub within 1e-6 relative of
the suite's exact oracle.  On the two quick rows the JAX driver runs
beside it with the same options (one padded bucket of 32 lanes, so JAX
compiles once) and the two ubs agree to 1e-9 relative.  On the other
three the JAX driver's ub is the oracle itself, to the last digit, so
the oracle check covers them (their JAX runs take 15-130 s on the CPU);
they run at the driver's default options.

The root presolves the NL slice brought in are held to the JAX
Presolver's: `presolve_subst` (substitution + postsolve lift) and
`nl_coef_improve` (coefficient improvement on nonlinear rows, with its
debug_sol check).
"""

import numpy as np
import pytest

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.bnb.presolve import Presolver
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.ir.expr import ExprGraph
from minotaur_tpu_torch.ir.functions import (Function, LinearFunction,
                                             QuadraticFunction)
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.models.convex_suite import SUITE
from minotaur_tpu_torch.ops.opcodes import Op
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import SolveStatus, VarType

OPTS = dict(log_level=1, node_batch=32, pad_full=1)
ROWS = ["normcon_20a", "expbudget_8a", "ex1223_a", "batchdes_a", "ball_mk_10a"]
WITH_JAX = ("ex1223_a", "batchdes_a")


def _env(cls=Environment, **opts):
    env = cls()
    for k, v in {**OPTS, **opts}.items():
        env.set_option(k, v)
    return env


def _jax_bnb(name, **opts):
    from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
    from minotaur_tpu.models.convex_suite import SUITE as JSUITE
    from minotaur_tpu.utils.environment import Environment as JEnv
    jb = JaxBnB(JSUITE[name][0](), _env(JEnv, **opts))
    jb.solve()
    return jb


@pytest.mark.parametrize("name", ROWS)
def test_nl_bnb_hits_oracle(name):
    gen, oracle, _ = SUITE[name]
    prob, opt = gen(), oracle()
    env = _env() if name in WITH_JAX else _env(node_batch=256, pad_full=0)
    bab = BranchAndBound(prob, env, device="cpu")
    assert bab.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(bab.ub - opt) <= 1e-6 * (1 + abs(opt))
    assert bab.lb == bab.ub
    assert bab.stats.nodes_processed >= 1 and bab.stats.ipm_iters > 0
    assert prob.is_feasible(bab.best_x, atol=1e-5)
    if name in WITH_JAX:
        jb = _jax_bnb(name)
        assert jb.status == SolveStatus.SOLVED_OPTIMAL
        assert abs(bab.ub - jb.ub) <= 1e-9 * (1 + abs(jb.ub))


def _chain(pkg):
    """min (x-3)^2 + y + w  s.t.  y - 2x = 1, x int in [0,10], y in
    [0,30], w fixed at 5: y and w are eliminable (tests/test_substitute.py);
    optimum 11 at x = 2."""
    p = pkg.Problem("chain")
    p.new_variable(0, 10, pkg.VarType.INTEGER, "x")
    p.new_variable(0.0, 30.0, pkg.VarType.CONTINUOUS, "y")
    p.new_variable(5.0, 5.0, pkg.VarType.CONTINUOUS, "w")
    p.new_constraint(pkg.Function(lf=pkg.LinearFunction({1: 1.0, 0: -2.0})),
                     1.0, 1.0, "def_y")
    p.new_objective(pkg.Function(
        lf=pkg.LinearFunction({0: -6.0, 1: 1.0, 2: 1.0}),
        qf=pkg.QuadraticFunction({(0, 0): 1.0})), const=9.0)
    p.debug_sol = np.array([2.0, 5.0, 5.0])
    return p


class _Port:
    Problem, VarType, Function = Problem, VarType, Function
    LinearFunction, QuadraticFunction = LinearFunction, QuadraticFunction
    ExprGraph = ExprGraph


class _Jax:
    from minotaur_tpu.ir.expr import ExprGraph
    from minotaur_tpu.ir.functions import (Function, LinearFunction,
                                           QuadraticFunction)
    from minotaur_tpu.ir.problem import Problem
    from minotaur_tpu.utils.types import VarType


def test_presolve_subst_matches_jax():
    from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
    from minotaur_tpu.utils.environment import Environment as JEnv
    pb = BranchAndBound(_chain(_Port), _env(presolve_subst=1, node_batch=4),
                        device="cpu")
    jb = JaxBnB(_chain(_Jax), _env(JEnv, presolve_subst=1, node_batch=4))
    assert pb.postsolve is not None and pb.postsolve.n_eliminated == 2
    assert pb.problem.n_vars == jb.problem.n_vars == 1
    assert pb.solve() == jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert pb.ub == pytest.approx(11.0, abs=1e-6)
    assert abs(pb.ub - jb.ub) <= 1e-9 * (1 + abs(jb.ub))
    np.testing.assert_allclose(pb.best_x_original, jb.best_x_original,
                               atol=1e-6)
    np.testing.assert_allclose(pb.best_x_original, [2.0, 5.0, 5.0],
                               atol=1e-6)


def _bigm(pkg, lb_side):
    """x0^2 + 5.5 z <= 6 (or its mirror -x0^2 - 5.5 z >= -6), x0 in
    [0, 1], z binary (tests/test_nlpres.py): the row's coefficient and
    bound tighten to 0.5 and 1."""
    p = pkg.Problem("nlcoef")
    p.new_variable(0, 1)
    p.new_variable(0, 1, pkg.VarType.BINARY)
    g = pkg.ExprGraph()
    sq = g.node(Op.SQR, g.var(0))
    if lb_side:
        g.set_root(g.node(Op.MULT, g.num(-1.0), sq))
        row = (pkg.Function(lf=pkg.LinearFunction({1: -5.5}), nlf=g),
               -6.0, float("inf"))
    else:
        g.set_root(sq)
        row = (pkg.Function(lf=pkg.LinearFunction({1: 5.5}), nlf=g),
               -float("inf"), 6.0)
    p.new_constraint(*row)
    p.new_objective(pkg.Function(lf=pkg.LinearFunction({0: -1.0, 1: -1.0})))
    p.debug_sol = np.array([0.5, 0.0])
    return p


@pytest.mark.parametrize("case", ["ex1223_a", "bigM_ub", "bigM_lb"])
def test_nl_coef_improve_matches_jax(case):
    from minotaur_tpu.bnb.presolve import Presolver as JPre
    from minotaur_tpu.engines.staging import stage_problem as jstage
    from minotaur_tpu.models.convex_suite import SUITE as JSUITE
    if case == "ex1223_a":
        pp, jp = SUITE[case][0](), JSUITE[case][0]()
    else:
        pp, jp = _bigm(_Port, case == "bigM_lb"), _bigm(_Jax, case == "bigM_lb")
    sp, jsp = stage_problem(pp), jstage(jp)
    pre = Presolver(pp, sp, device="cpu")
    jpre = JPre(jp, jsp)
    for p_ in (pre, jpre):
        st, lo, hi = p_.presolve(p_.sp.vlb.copy(), p_.sp.vub.copy())
        p_.nl_coef_improve(lo, hi)
    assert pre.stats.coefs_improved == jpre.stats.coefs_improved
    assert pre.stats.bounds_tightened == jpre.stats.bounds_tightened
    assert pre.stats.coefs_improved >= (case != "ex1223_a")
    np.testing.assert_array_equal(sp.A, jsp.A)
    np.testing.assert_array_equal(sp.clb, jsp.clb)
    np.testing.assert_array_equal(sp.cub, jsp.cub)
    if case == "bigM_ub":
        assert sp.A[0, 1] == pytest.approx(0.5) and sp.cub[0] == pytest.approx(1.0)
    # the debug_sol check runs on the improved rows (an infeasible debug
    # point trips it; a valid improvement never cuts a feasible one)
    if case != "ex1223_a":
        pp.debug_sol = np.array([0.95, 1.0])
        with pytest.raises(AssertionError, match="debug solution"):
            Presolver(pp, stage_problem(pp), device="cpu").nl_coef_improve(
                np.array([0.0, 0.0]), np.array([1.0, 1.0]))
