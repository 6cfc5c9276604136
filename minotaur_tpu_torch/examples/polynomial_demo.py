"""Example: polynomial algebra and factorable reformulation.

Reference analogue: examples/polynomial (PolynomialFunction demo) and
the TransPoly direction.

    python -m minotaur_tpu_torch.examples.polynomial_demo
"""

from minotaur_tpu_torch.ir.expr import ExprGraph
from minotaur_tpu_torch.ir.polynomial import expr_to_polynomial
from minotaur_tpu_torch.ops.opcodes import Op


def main():
    # (x0 + 2 x1)^2 * x0 - 3 x1  built as a DAG, extracted as a polynomial
    g = ExprGraph()
    s = g.node(Op.PLUS, g.var(0), g.node(Op.MULT, g.num(2.0), g.var(1)))
    expr = g.node(Op.MINUS,
                  g.node(Op.MULT, g.node(Op.SQR, s), g.var(0)),
                  g.node(Op.MULT, g.num(3.0), g.var(1)))
    g.set_root(expr)
    poly = expr_to_polynomial(g)
    print("polynomial:", poly)
    print("degree:", poly.degree())
    v = poly.eval([1.5, -0.5])
    ref = (1.5 + 2 * -0.5) ** 2 * 1.5 - 3 * -0.5
    print(f"eval at (1.5,-0.5): {v} (expected {ref})")
    if abs(v - ref) >= 1e-12:
        raise ValueError(f"p(1.5, -0.5) = {v}, expected {ref}")

    # algebra: p^2 + p
    p2 = poly * poly + poly
    print("p^2 + p degree:", p2.degree())
    return poly


if __name__ == "__main__":
    main()
