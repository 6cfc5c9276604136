"""Interval FBBT through expression graphs: the port's
`ops/interval.py` against the JAX package's, rule by rule.

For every opcode, a one- or two-variable graph is staged in both
packages and swept over the same 12 seeded boxes (the port in one
batched call, JAX vmapped): the forward interval (`stage_interval`) and
the forward-then-backward projection (`stage_fbbt`, with a seeded
imposed range inside the forward interval, so backward rules fire)
agree to abs 1e-12, infinities and the infeasibility flag included.
Two multi-node graphs (the exp-sum row of expbudget and the quadratic
row of normcon) run the whole sweep the same way.

A hypothesis test checks soundness: points sampled inside a box
evaluate (host numpy rules) inside the port's forward interval.  So must
the body of a row with both a quadratic and a nonlinear part, whose FBBT
graph the port stages as one graph of both (`staging.fbbt_graph`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from minotaur_tpu.ir.expr import ExprGraph as JGraph
from minotaur_tpu.models import convex_suite as JS
from minotaur_tpu.ops import interval as jiv
from minotaur_tpu_torch.ir.expr import ExprGraph as PGraph
from minotaur_tpu_torch.models import convex_suite as PS
from minotaur_tpu_torch.ops import interval as piv
from minotaur_tpu_torch.ops.opcodes import BINARY_OPS, UNARY_OPS, Op

F64 = torch.float64
B = 12
CONSTS = {Op.POWK: (3.0, 2.0, -2.0, 0.0, 2.5, -0.5), Op.CPOW: (2.0, 0.5, -1.0)}
OPS = sorted(UNARY_OPS | BINARY_OPS)
CASES = [(o, c) for o in OPS for c in CONSTS.get(o, (0.0,))]


def _graph(cls, op, const):
    g = cls()
    a = g.var(0)
    b = g.var(1) if op in BINARY_OPS else -1
    g.set_root(g._push(op, a, b, const, -1))
    return g


def _boxes(seed, n):
    """B boxes over n variables: mixed signs, some straddling 0, some
    tiny, one with an infinite end."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-3, 3, size=(B, n))
    w = rng.choice([0.01, 0.5, 2.0, 5.0], size=(B, n))
    lo, hi = c - w * rng.uniform(0, 1, (B, n)), c + w * rng.uniform(0, 1, (B, n))
    lo[0], hi[0] = 0.2, 1.7          # positive
    lo[1], hi[1] = -1.5, 0.5          # straddles 0
    hi[2, 0] = np.inf
    return lo, hi


def _ranges(flo, fhi, seed):
    """An imposed range per box inside the forward interval (finite)."""
    rng = np.random.default_rng(seed)
    a = np.where(np.isfinite(flo), flo, -10.0)
    b = np.where(np.isfinite(fhi), fhi, 10.0)
    t = np.sort(rng.uniform(0, 1, size=(2, len(a))), axis=0)
    return a + t[0] * 0.5 * (b - a), b - t[1] * 0.3 * (b - a)


def _same(p, j):
    p, j = np.asarray(p), np.asarray(j)
    assert p.shape == j.shape
    np.testing.assert_allclose(p, j, rtol=0, atol=1e-12)


def _sweep_both(jg, pg, n, seed):
    lo, hi = _boxes(seed, n)
    T = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    jf = jax.vmap(jiv.stage_interval(jg))(jnp.asarray(lo), jnp.asarray(hi))
    pf = piv.stage_interval(pg)(T(lo), T(hi))
    _same(pf[0], jf[0])
    _same(pf[1], jf[1])
    rlo, rhi = _ranges(np.asarray(jf[0]), np.asarray(jf[1]), seed + 1)
    jb = jax.vmap(jiv.stage_fbbt(jg, n))(jnp.asarray(lo), jnp.asarray(hi),
                                         jnp.asarray(rlo), jnp.asarray(rhi))
    pb = piv.stage_fbbt(pg, n)(T(lo), T(hi), T(rlo), T(rhi))
    for p, j in zip(pb, jb):
        _same(p, j)
    return pb


@pytest.mark.parametrize("op,const", CASES,
                         ids=[f"{o.name}{c:g}" for o, c in CASES])
def test_rule_matches_jax(op, const):
    n = 2 if op in BINARY_OPS else 1
    _sweep_both(_graph(JGraph, op, const), _graph(PGraph, op, const), n,
                seed=int(op) * 13 + int(10 * const) % 7)


@pytest.mark.parametrize("which", ["expbudget", "normcon"])
def test_row_graph_sweep_matches_jax(which):
    if which == "expbudget":
        jg, pg = JS.expbudget(6, 1).cons[0].fun.nlf, \
            PS.expbudget(6, 1).cons[0].fun.nlf
    else:
        jg = JS.normcon(6, 1).cons[0].fun.qf.to_expr_graph()
        pg = PS.normcon(6, 1).cons[0].fun.qf.to_expr_graph()
    new_lo, new_hi, _ = _sweep_both(jg, pg, 6, seed=17)
    assert new_lo.shape == (B, 6)


def test_row_with_both_parts_bounds_its_whole_body():
    from minotaur_tpu_torch.engines.staging import stage_problem
    from minotaur_tpu_torch.ir.functions import (Function, LinearFunction,
                                                 QuadraticFunction)
    from minotaur_tpu_torch.ir.problem import Problem
    p = Problem("both")
    for _ in range(2):
        p.new_variable(-1.0, 2.0)
    g = PGraph()
    g.set_root(g.node(Op.EXP, g.var(1)))
    body = Function(lf=LinearFunction({0: 1.0}),
                    qf=QuadraticFunction({(0, 0): 1.0}), nlf=g)
    p.new_constraint(body, -np.inf, 3.0)
    sp = stage_problem(p)
    lo, hi = piv.stage_interval(sp.nl_graphs[0])(
        torch.tensor([-1.0, -1.0], dtype=F64), torch.tensor([2.0, 2.0],
                                                           dtype=F64))
    assert float(lo) == pytest.approx(np.exp(-1.0))
    assert float(hi) == pytest.approx(4.0 + np.exp(2.0))
    X = np.random.default_rng(1).uniform(-1.0, 2.0, size=(64, 2))
    vals = X[:, 0] ** 2 + np.exp(X[:, 1])         # the body less its lf
    assert np.all((vals >= float(lo)) & (vals <= float(hi)))


@settings(max_examples=60, deadline=None, derandomize=True)
@given(op=st.sampled_from(sorted(UNARY_OPS | BINARY_OPS)),
       k=st.sampled_from([2.0, 3.0, -2.0, 0.5, 2.5]),
       ends=st.lists(st.floats(-4.0, 4.0), min_size=4, max_size=4),
       seed=st.integers(0, 2 ** 16))
def test_forward_interval_is_sound(op, k, ends, seed):
    const = k if op in (Op.POWK, Op.CPOW) else 0.0
    if op is Op.CPOW:
        const = abs(const) + 0.1
    lo = np.minimum(ends[:2], ends[2:])
    hi = np.maximum(ends[:2], ends[2:])
    g = _graph(PGraph, op, const)
    flo, fhi = piv.stage_interval(g)(torch.as_tensor(lo, dtype=F64),
                                     torch.as_tensor(hi, dtype=F64))
    flo, fhi = float(flo), float(fhi)
    pts = np.random.default_rng(seed).uniform(lo, hi, size=(32, 2))
    pts = np.concatenate([pts, lo[None], hi[None]])
    with np.errstate(all="ignore"):
        for x in pts:
            try:
                v = g.eval_np(x)
            except (ValueError, ZeroDivisionError, OverflowError):
                continue            # outside the host rule's domain
            if not np.isfinite(v):
                continue
            tol = 1e-9 * (1.0 + abs(v))
            assert flo - tol <= v <= fhi + tol, (op, const, lo, hi, x, v,
                                                 flo, fhi)
