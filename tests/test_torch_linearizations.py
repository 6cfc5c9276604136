"""The port's root linearizations (bnb/linearizations.py) against the JAX
package's, on the CPU.

- The analytic center of st_e14a's linear relaxation (a log-barrier NLP
  through the IPM, the barrier a torch closure): within 1e-6.
- ESH boundary points along a segment from an interior to an exterior
  point, on st_e14a (two exp rows) and on a problem with a quadratic and
  an exp row: validity flags equal, points within 1e-9.
- The rs1/rs2 and sampled point generators: equal arrays from the same
  seed (exact: the same numpy code).
- QG's root under `root_linearizations both` (analytic center, ESH on
  the master LP's solution, sampled cuts) on st_e14a: the same number of
  cuts in both packages, rows within 1e-6 relative.
"""

import numpy as np
import pytest
import torch

import minotaur_tpu.ir.expr as jexpr
import minotaur_tpu.ir.functions as jfun
import minotaur_tpu.ir.problem as jprob
import minotaur_tpu.ops.opcodes as jops
import minotaur_tpu.utils.types as jtypes
import minotaur_tpu_torch.ir.expr as texpr
import minotaur_tpu_torch.ir.functions as tfun
import minotaur_tpu_torch.ir.problem as tprob
import minotaur_tpu_torch.ops.opcodes as tops
import minotaur_tpu_torch.utils.types as ttypes
from minotaur_tpu.bnb import linearizations as jl
from minotaur_tpu.bnb.qg import QGBranchAndBound as JaxQG
from minotaur_tpu.engines.ipm import IPMOptions as JOpts
from minotaur_tpu.engines.staging import stage_problem as jax_stage
from minotaur_tpu.models.convex_suite import SUITE as JSUITE
from minotaur_tpu.utils.environment import Environment as JEnv
from minotaur_tpu_torch.bnb import linearizations as tl
from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
from minotaur_tpu_torch.engines.ipm import IPMOptions
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


INF = float("inf")
JAX = (jprob, jfun, jexpr, jops, jtypes)
PORT = (tprob, tfun, texpr, tops, ttypes)


def _univar_rows(pkg):
    """x^2 <= 4, exp(y) <= 5, x integer in [0,3], y in [0,3] (the shape
    of tests/test_linearizations.py)."""
    P, F, E, O, T = pkg
    p = P.Problem("univar_rows")
    p.new_variable(0, 3, T.VarType.INTEGER)
    p.new_variable(0, 3)
    qf = F.QuadraticFunction()
    qf.add_term(0, 0, 1.0)
    p.new_constraint(F.Function(qf=qf), -INF, 4.0, "sq")
    g = E.ExprGraph()
    g.set_root(g.node(O.Op.EXP, g.var(1)))
    p.new_constraint(F.Function(nlf=g), -INF, 5.0, "expr")
    p.new_objective(F.Function(lf=F.LinearFunction({0: -1.0, 1: -1.0})))
    return p


def _linearizers(name):
    if name == "st_e14a":
        sj, st = jax_stage(JSUITE[name][0]()), stage_problem(SUITE[name][0]())
    else:
        sj, st = jax_stage(_univar_rows(JAX)), stage_problem(_univar_rows(PORT))
    return (jl.RootLinearizer(sj, JOpts(), seed=3),
            tl.RootLinearizer(st, IPMOptions(), seed=3, device="cpu"))


def test_analytic_center_matches_jax():
    rj, rt = _linearizers("st_e14a")
    sp = rt.sp
    xj = rj.analytic_center(sp.vlb, sp.vub)
    xt = rt.analytic_center(sp.vlb, sp.vub)
    assert xj is not None and xt is not None
    np.testing.assert_allclose(xt, xj, atol=1e-6)
    assert np.all(xt > sp.vlb) and np.all(xt < sp.vub)


@pytest.mark.parametrize("name,xc,xo", [
    ("st_e14a", [0.0] * 5, [2.0, 2.0, 0.0, 0.0, 0.0]),
    ("st_e14a", [0.1, 0.2, 0.5, 0.5, 0.5], [1.8, 0.1, 1.0, 0.0, 1.0]),
    ("univar", [0.5, 0.5], [3.0, 3.0]),
])
def test_esh_points_match_jax(name, xc, xo):
    rj, rt = _linearizers(name)
    xc, xo = np.array(xc), np.array(xo)
    pj, vj = rj.esh_points(xc, xo)
    pt, vt = rt.esh_points(xc, xo)
    assert vt.tolist() == np.asarray(vj).tolist() and vt.any()
    np.testing.assert_allclose(pt, np.asarray(pj), rtol=0, atol=1e-9)


def test_point_generators_equal():
    rj, rt = _linearizers("univar")
    x0 = np.array([1.0, 1.0])
    sj, st = jl.RootSchemes(rj), tl.RootSchemes(rt)
    assert np.array_equal(st.rs1_points(x0, fan=5), sj.rs1_points(x0, fan=5))
    assert np.array_equal(st.rs2_points(x0, nbh=0.25, count=6),
                          sj.rs2_points(x0, nbh=0.25, count=6))
    assert np.array_equal(rt.sample_points(rt.sp.vlb, rt.sp.vub, x0, 9),
                          rj.sample_points(rj.sp.vlb, rj.sp.vub, x0, 9))
    assert tl._univariate_rows(rt.sp) == jl._univariate_rows(rj.sp)


def test_qg_root_linearizations_both_match_jax():
    opts = dict(log_level=1, node_batch=16, pad_full=1,
                root_linearizations="both", root_linearization_samples=6)
    ej, et = JEnv(), Environment()
    for k, v in opts.items():
        ej.set_option(k, v)
        et.set_option(k, v)
    jb = JaxQG(JSUITE["st_e14a"][0](), ej)
    tb = QGBranchAndBound(SUITE["st_e14a"][0](), et, device="cpu")
    assert jb._qg_root() is None and tb._qg_root() is None
    assert tb.n_cuts == jb.n_cuts > 2
    rows = slice(tb._cut_base, tb._cut_base + tb.n_cuts)
    np.testing.assert_allclose(tb.mA[rows], jb.mA[rows], rtol=1e-6,
                               atol=1e-6 * np.abs(jb.mA[rows]).max())
    np.testing.assert_allclose(tb.mcub[rows], jb.mcub[rows], rtol=1e-6,
                               atol=1e-6)
