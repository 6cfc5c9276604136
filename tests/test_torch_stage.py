"""Staged expression code: the port's `ops/stage.py` against the JAX
package's, opcode by opcode.

Every opcode of the rule table is staged in both packages as a one- or
two-variable graph and evaluated on the same seeded points: values and
gradients (`torch.func.grad` under `vmap` against `jax.grad` under
`jax.vmap`) agree to rel 1e-12, at random interior points and at the
domain clamps (sqrt and fractional powers at 0, log at 1e-300, asin and
acos at +-1, acosh at 1, atanh at its clip, exp at 709, max/min/less at
ties), where both packages split the gradient of a clamp in half.
Beyond a clamp the gradient is not held: JAX gives NaN (inf * 0) where
torch's maximum gives 0.

The Hessian of the Lagrangian (obj_nl + y . con_nl) of three NL suite
models, through `torch.func.hessian` vmapped over lanes, agrees with
`jax.hessian` to rel 1e-10; `stage_stack` and constant folding are
checked on the way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, hessian, vmap

from minotaur_tpu.engines.staging import stage_problem as jax_stage_problem
from minotaur_tpu.ir.expr import ExprGraph as JGraph
from minotaur_tpu.models import convex_suite as JS
from minotaur_tpu.ops import stage as jstage
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.ir.expr import ExprGraph as PGraph
from minotaur_tpu_torch.models import convex_suite as PS
from minotaur_tpu_torch.ops import stage as pstage
from minotaur_tpu_torch.ops.opcodes import Op

F64 = torch.float64

# (op, const, domain of x, domain of y or None for unary)
UNARY = [
    (Op.UMINUS, 0.0, (-3, 3)), (Op.ABS, 0.0, (-3, 3)),
    (Op.SQR, 0.0, (-3, 3)), (Op.SQRT, 0.0, (0.1, 4)),
    (Op.POWK, 3.0, (-2, 2)), (Op.POWK, 2.0, (-2, 2)),
    (Op.POWK, -2.0, (0.3, 2)), (Op.POWK, 0.0, (-2, 2)),
    (Op.POWK, 2.5, (0.1, 3)), (Op.POWK, 0.5, (0.1, 3)),
    (Op.CPOW, 2.0, (-2, 2)), (Op.CPOW, 0.5, (-2, 2)),
    (Op.EXP, 0.0, (-3, 3)), (Op.LOG, 0.0, (0.1, 4)),
    (Op.LOG10, 0.0, (0.1, 4)), (Op.SIN, 0.0, (-3, 3)),
    (Op.COS, 0.0, (-3, 3)), (Op.TAN, 0.0, (-1.2, 1.2)),
    (Op.SINH, 0.0, (-2, 2)), (Op.COSH, 0.0, (-2, 2)),
    (Op.TANH, 0.0, (-2, 2)), (Op.ASIN, 0.0, (-0.9, 0.9)),
    (Op.ACOS, 0.0, (-0.9, 0.9)), (Op.ATAN, 0.0, (-3, 3)),
    (Op.ASINH, 0.0, (-3, 3)), (Op.ACOSH, 0.0, (1.1, 4)),
    (Op.ATANH, 0.0, (-0.9, 0.9)), (Op.FLOOR, 0.0, (-3, 3)),
    (Op.CEIL, 0.0, (-3, 3)),
]
BINARY = [
    (Op.PLUS, (-3, 3), (-3, 3)), (Op.MINUS, (-3, 3), (-3, 3)),
    (Op.MULT, (-3, 3), (-3, 3)), (Op.DIV, (-3, 3), (0.5, 2)),
    (Op.POW, (0.5, 2), (-2, 2)), (Op.ATAN2, (-3, 3), (-3, 3)),
    (Op.INTDIV, (-5, 5), (0.5, 2)), (Op.MAX2, (-3, 3), (-3, 3)),
    (Op.MIN2, (-3, 3), (-3, 3)), (Op.REM, (-5, 5), (0.7, 2)),
    (Op.LESS, (-3, 3), (-3, 3)),
]
# (op, const, point): where a clamp or a tie sits
EDGES = [
    (Op.SQRT, 0.0, (0.0,)), (Op.POWK, 2.5, (0.0,)), (Op.POWK, 0.5, (0.0,)),
    (Op.LOG, 0.0, (1e-300,)), (Op.LOG10, 0.0, (1e-300,)),
    (Op.ASIN, 0.0, (1.0,)), (Op.ASIN, 0.0, (-1.0,)),
    (Op.ACOS, 0.0, (1.0,)), (Op.ACOS, 0.0, (-1.0,)),
    (Op.ACOSH, 0.0, (1.0,)), (Op.ATANH, 0.0, (1.0 - 1e-15,)),
    (Op.ATANH, 0.0, (-1.0 + 1e-15,)), (Op.EXP, 0.0, (709.0,)),
    (Op.MAX2, 0.0, (1.5, 1.5)), (Op.MIN2, 0.0, (-0.5, -0.5)),
    (Op.LESS, 0.0, (2.0, 2.0)),
]


def _graph(cls, op, const, nvar):
    g = cls()
    a = g.var(0)
    b = g.var(1) if nvar == 2 else -1
    g.set_root(g._push(op, a, b, const, -1))
    return g


def _both(op, const, X):
    """Values and gradients of the staged op at the rows of X, by each
    package."""
    nvar = X.shape[1]
    jf = jstage.stage_scalar(_graph(JGraph, op, const, nvar))
    pf = pstage.stage_scalar(_graph(PGraph, op, const, nvar))
    Xt = torch.as_tensor(X, dtype=F64)
    jv = np.asarray(jax.vmap(jf)(jnp.asarray(X)))
    jg = np.asarray(jax.vmap(jax.grad(jf))(jnp.asarray(X)))
    pv = pf(Xt).numpy()
    pg = vmap(grad(pf))(Xt).numpy()
    return jv, jg, pv, pg


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("op,const,dom", UNARY,
                         ids=[f"{o.name}{c:g}" for o, c, _ in UNARY])
def test_unary_rule_values_and_grads(op, const, dom):
    X = np.random.default_rng(int(op) * 31 + 7).uniform(*dom, size=(16, 1))
    jv, jg, pv, pg = _both(op, const, X)
    _close(pv, jv)
    _close(pg, jg)


@pytest.mark.parametrize("op,dx,dy", BINARY, ids=[o.name for o, _, _ in BINARY])
def test_binary_rule_values_and_grads(op, dx, dy):
    rng = np.random.default_rng(int(op) * 31 + 11)
    X = np.stack([rng.uniform(*dx, size=16), rng.uniform(*dy, size=16)], 1)
    jv, jg, pv, pg = _both(op, 0.0, X)
    _close(pv, jv)
    _close(pg, jg)


@pytest.mark.parametrize("op,const,pt", EDGES,
                         ids=[f"{o.name}{c:g}@{p[0]:g}" for o, c, p in EDGES])
def test_clamp_boundaries_split_like_jax(op, const, pt):
    jv, jg, pv, pg = _both(op, const, np.array([pt], dtype=np.float64))
    _close(pv, jv)
    _close(pg, jg)


def test_constant_subtrees_fold_and_stack():
    """exp(2 * 3) * x0 + log(x1), and a bare constant root: folded at
    staging time, same values and gradients; stage_stack of both."""
    graphs = []
    for cls in (JGraph, PGraph):
        g = cls()
        k = g.node(Op.EXP, g.node(Op.MULT, g.num(2.0), g.num(3.0)))
        g.set_root(g.node(Op.PLUS, g.node(Op.MULT, k, g.var(0)),
                          g.node(Op.LOG, g.var(1))))
        c = cls()
        c.set_root(c.node(Op.SQRT, c.num(2.0)))
        graphs.append((g, c))
    X = np.random.default_rng(3).uniform(0.2, 2.0, size=(5, 2))
    jf = jstage.stage_stack(list(graphs[0]))
    pf = pstage.stage_stack(list(graphs[1]))
    Xt = torch.as_tensor(X, dtype=F64)
    _close(pf(Xt).numpy(), np.asarray(jax.vmap(jf)(jnp.asarray(X))))
    assert pf(Xt).shape == (5, 2)
    _close(vmap(grad(lambda x: pf(x).sum()))(Xt).numpy(),
           np.asarray(jax.vmap(jax.grad(lambda x: jf(x).sum()))(
               jnp.asarray(X))))
    assert pstage.stage_stack([])(Xt).shape == (5, 0)


@pytest.mark.parametrize("name", ["expbudget", "ex1223_like", "batchdes_like",
                                  "normcon"])
def test_lagrangian_hessian_matches_jax(name):
    args = {"expbudget": (8, 0), "normcon": (6, 0)}.get(name, ())
    jp, pp = getattr(JS, name)(*args), getattr(PS, name)(*args)
    jsp, sp = jax_stage_problem(jp), stage_problem(pp)
    rows = torch.as_tensor(sp.nl_rows, dtype=torch.long)
    rng = np.random.default_rng(5)
    lo = np.where(np.isfinite(sp.vlb), sp.vlb, -1.0)
    hi = np.where(np.isfinite(sp.vub), sp.vub, 1.0)
    X = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo),
                    size=(4, sp.n))
    Y = rng.uniform(-2.0, 2.0, size=(4, sp.m))

    def jlag(x, y):
        v = jsp.obj_nl(x) if jsp.obj_nl is not None else 0.0
        if jsp.con_nl is not None:
            v = v + y[jnp.asarray(jsp.nl_rows)] @ jsp.con_nl(x)
        return v

    def plag(x, y):
        v = sp.obj_nl(x) if sp.obj_nl is not None else 0.0
        if sp.con_nl is not None:
            v = v + y.index_select(-1, rows) @ sp.con_nl(x)
        return v

    jh = np.asarray(jax.vmap(jax.hessian(jlag))(jnp.asarray(X),
                                                jnp.asarray(Y)))
    ph = vmap(hessian(plag))(torch.as_tensor(X, dtype=F64),
                             torch.as_tensor(Y, dtype=F64)).numpy()
    assert ph.shape == (4, sp.n, sp.n)
    scale = np.abs(jh).max()
    np.testing.assert_allclose(ph, jh, rtol=1e-10, atol=1e-10 * scale)
    # the batched staged bodies equal the JAX ones lane by lane
    for jf, pf in ((jsp.con_nl, sp.con_nl), (jsp.obj_nl, sp.obj_nl)):
        assert (jf is None) == (pf is None)
        if pf is not None:
            np.testing.assert_allclose(
                pf(torch.as_tensor(X, dtype=F64)).numpy(),
                np.asarray(jax.vmap(jf)(jnp.asarray(X))), rtol=1e-12)
