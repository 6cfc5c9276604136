"""The port's copy of ir/polynomial.py (byte-equal to the JAX package's,
tests/test_torch_no_jax.py) on the cases of tests/test_polynomial.py that
need no reference instance, each checked against the JAX package's module
on the same input: the algebra's golden values, the expression-graph
round trip (values to rel 1e-12, the same monomials), and the rejection
of non-polynomial graphs."""

import numpy as np
import pytest

from minotaur_tpu.ir import expr as jexpr
from minotaur_tpu.ir import polynomial as jpoly
from minotaur_tpu_torch.ir import expr as texpr
from minotaur_tpu_torch.ir import polynomial as tpoly
from minotaur_tpu_torch.ops.opcodes import Op

PKGS = [pytest.param((tpoly, texpr), id="port"),
        pytest.param((jpoly, jexpr), id="jax")]


@pytest.mark.parametrize("pkg", PKGS)
def test_algebra_golden(pkg):
    P = pkg[0].PolynomialFunction
    x, y = P.variable(0), P.variable(1)
    p = (x + y) * (x - y)            # x^2 - y^2
    assert p.degree() == 2 and len(p) == 2
    assert p.eval(np.array([3.0, 2.0])) == pytest.approx(5.0)
    q = (x + 1.0).power(3)           # x^3 + 3x^2 + 3x + 1
    assert q.degree() == 3
    assert q.eval(np.array([2.0])) == pytest.approx(27.0)
    assert q.const == pytest.approx(1.0)
    assert list((x * y * x).terms) == [((0, 2), (1, 1))]


def _poly(P):
    x, y = P.variable(0), P.variable(1)
    return 2.0 * x.power(3) * y - 4.0 * y.power(2) + x + 7.0


def test_to_expr_graph_roundtrip_matches_jax():
    p = _poly(tpoly.PolynomialFunction)
    jp = _poly(jpoly.PolynomialFunction)
    g, jg = p.to_expr_graph(), jp.to_expr_graph()
    rng = np.random.default_rng(0)
    for _ in range(10):
        pt = rng.uniform(-2, 2, size=2)
        assert g.eval_np(pt) == pytest.approx(p.eval(pt), rel=1e-12)
        assert g.eval_np(pt) == pytest.approx(jg.eval_np(pt), rel=1e-12)
    p2, jp2 = tpoly.expr_to_polynomial(g), jpoly.expr_to_polynomial(jg)
    assert p2 is not None and p2.terms.keys() == p.terms.keys()
    assert p2.terms.keys() == jp2.terms.keys()
    for k in p.terms:
        assert p2.terms[k] == pytest.approx(p.terms[k])
        assert p2.terms[k] == pytest.approx(jp2.terms[k])
    assert p2.const == pytest.approx(p.const)


@pytest.mark.parametrize("pkg", PKGS)
def test_extraction_rejects_nonpoly(pkg):
    poly, expr = pkg
    g = expr.ExprGraph()
    g.set_root(g.node(Op.EXP, g.var(0)))
    assert poly.expr_to_polynomial(g) is None
    g2 = expr.ExprGraph()
    g2.set_root(g2.node(Op.DIV, g2.num(1.0), g2.var(0)))  # 1/x
    assert poly.expr_to_polynomial(g2) is None
