"""The port's trimloss cover-cut guard (bnb/trimloss.py, family (v)).

The pattern-cover cuts  sum_{j not in S} y_j >= 1  say that a pattern
with y_j = 0 is unused, which holds only when a row forces m_j = 0 at
y_j = 0 (m_j <= cap_j y_j).  The y <= m gating rows that the detector
keys on say only the converse.  On a two-pattern, two-product model in
the square encoding of the tls* family (either pattern alone cannot
cover the demand even at full multiplicity):

- with the m_j <= cap_j y_j rows the port emits the cover cuts
  (y_0 >= 1 and y_1 >= 1);
- with the y <= m rows alone it emits none, where the JAX package
  (the reference-side fault) still emits them;
- every other family (capacity and Chvatal rows on m) is the JAX
  package's in both models.
"""

import numpy as np
import pytest

import minotaur_tpu.ir.expr as jexpr
import minotaur_tpu.ir.functions as jfun
import minotaur_tpu.ir.problem as jprob
import minotaur_tpu.utils.types as jtypes
import minotaur_tpu_torch.ir.expr as texpr
import minotaur_tpu_torch.ir.functions as tfun
import minotaur_tpu_torch.ir.problem as tprob
import minotaur_tpu_torch.utils.types as ttypes
from minotaur_tpu.bnb.trimloss import trimloss_valid_rows as jax_rows
from minotaur_tpu_torch.bnb.trimloss import detect_trimloss, \
    trimloss_valid_rows
from minotaur_tpu_torch.ops.opcodes import Op

INF = float("inf")
JAX = (jprob, jfun, jexpr, jtypes)
PORT = (tprob, tfun, texpr, ttypes)

CAP_M = 2                       # multiplicity cap of each pattern
CAP_N = ((3, 1), (1, 3))        # CAP_N[i][j]: pieces of product i a roll
DEMAND = (5.0, 5.0)


def _model(pkg, cap_rows):
    """Square encoding q = sum_k k b_k, s = 1 + sum_k k(k+2) b_k of each
    multiplicity m_j and content n_ij; demand rows
    -sum_j sqrt(s_mj s_nij) <= -d_i - P; gates y_j <= m_j, and with
    `cap_rows` also m_j <= CAP_M y_j."""
    P_, F, E, T = pkg
    p = P_.Problem("tls_tiny")
    lin = F.LinearFunction

    def group(cap):
        s = p.new_variable(1.0, float((cap + 1) ** 2)).index
        bs = [p.new_variable(0, 1, T.VarType.BINARY).index
              for _ in range(cap)]
        terms = {s: 1.0}
        terms.update({b: -float(k * (k + 2)) for k, b in
                      enumerate(bs, start=1)})
        p.new_constraint(F.Function(lf=lin(terms)), 1.0, 1.0)
        p.new_constraint(F.Function(lf=lin({b: 1.0 for b in bs})), -INF, 1.0)
        return s, bs

    m = [group(CAP_M) for _ in range(2)]
    n = [[group(CAP_N[i][j]) for j in range(2)] for i in range(2)]
    ys = [p.new_variable(0, 1, T.VarType.BINARY).index for _ in range(2)]
    for j, (_, bs) in enumerate(m):
        gate = {ys[j]: 1.0}
        gate.update({b: -float(k) for k, b in enumerate(bs, start=1)})
        p.new_constraint(F.Function(lf=lin(gate)), -INF, 0.0)
        if cap_rows:
            cap = {ys[j]: -float(CAP_M)}
            cap.update({b: float(k) for k, b in enumerate(bs, start=1)})
            p.new_constraint(F.Function(lf=lin(cap)), -INF, 0.0)
    for i in range(2):
        g = E.ExprGraph()
        g.set_root(g.sum_list([
            g.node(Op.UMINUS, g.node(Op.SQRT, g.node(
                Op.MULT, g.var(m[j][0]), g.var(n[i][j][0]))))
            for j in range(2)]))
        p.new_constraint(F.Function(nlf=g), -INF, -DEMAND[i] - 2.0)
    obj = {y: 1.0 for y in ys}
    obj.update({b: float(k) for _, bs in m
                for k, b in enumerate(bs, start=1)})
    p.new_objective(F.Function(lf=lin(obj)))
    return p, ys


def _y_rows(rows, ys):
    """(support, lb) of the rows whose support is y variables only."""
    out = []
    for coefs, lo, _ in rows:
        sup = set(np.nonzero(coefs)[0].tolist())
        if sup and sup <= set(ys):
            out.append((tuple(sorted(sup)), lo))
    return sorted(out)


def _other_rows(rows, ys):
    return [(np.asarray(c), lo, hi) for c, lo, hi in rows
            if not (set(np.nonzero(c)[0].tolist()) <= set(ys))]


@pytest.mark.parametrize("cap_rows", [True, False])
def test_cover_cuts_need_cap_rows(cap_rows):
    p, ys = _model(PORT, cap_rows)
    st = detect_trimloss(p)
    assert st is not None and st.n_patterns == 2 and st.n_products == 2
    assert all(g.y_var >= 0 for g in st.m_groups)
    got = _y_rows(trimloss_valid_rows(p), ys)
    if cap_rows:
        y0, y1 = ys
        assert got == [((y0,), 1.0), ((y1,), 1.0)]
    else:
        assert got == []


@pytest.mark.parametrize("cap_rows", [True, False])
def test_other_families_match_jax(cap_rows):
    p, ys = _model(PORT, cap_rows)
    jp, jys = _model(JAX, cap_rows)
    assert ys == jys
    ours = _other_rows(trimloss_valid_rows(p), ys)
    ref = _other_rows(jax_rows(jp), ys)
    assert len(ours) == len(ref) > 0
    for (a, lo, hi), (b, jlo, jhi) in zip(ours, ref):
        assert np.array_equal(a, b) and lo == jlo and hi == jhi
    # the reference emits the cover cuts with or without the cap rows
    assert len(_y_rows(jax_rows(jp), ys)) == 2
