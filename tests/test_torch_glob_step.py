"""The port's global-pipeline pieces against the JAX package, on the CPU.

The same problems are built in both IRs and transformed by both
packages; the JAX `GlobStaged` is carried into the port with
`convert.glob_staged_from_numpy` where both must see the same arrays.

- `transform`: equal `GlobStaged` arrays (exactly) on qknap(8), the
  pooling model, a univariate model, a multilinear model and a model
  with every univariate opcode.
- `build_envelope_fn` at 32 random boxes per model (some bounds
  infinite, some boxes of zero width): equal rows, row ranges and sets
  of infinite entries; rtol 1e-12 on the McCormick, square, RLT and
  lambda-hull rows, 1e-10 on the univariate (transcendental) ones.
- `make_uni_fns`: value, derivative, forward range and backward
  projection per opcode over random intervals that straddle 0 and the
  poles (rtol 1e-10), and a hypothesis test that the range encloses
  sampled values.  One known difference: where an interval of log or
  log10 starts below 1e-300 the JAX package's range stops at the value
  at 1e-300, which misses the values of smaller positive doubles (the
  hypothesis test found x = 2.2e-311 below it); the port's range starts
  at the value at the smallest positive double (`LOG_FLOOR`).
- Term and univariate FBBT: the step's new boxes and infeasibility flags
  on the same random boxes (with infinite and zero-width bounds).
- The step at B = 16 under f64 factors: equal statuses, branching
  variables, spatial flags and feasibility flags lane by lane; bounds,
  objectives and branch points within 1e-6 (1 + |v|).  Under the default
  mixed policy the two packages' f32 factors round differently, so there
  each certified bound lies below the other package's objective.
- The IPM on (B, m, n) constraint data: equal to the shared-A call when
  every lane carries the same A (to 1e-12), and equal to the JAX `vmap`
  of `build_single_solver` on per-lane rows under f64 factors.
"""

import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import minotaur_tpu.ir.expr as jexpr
import minotaur_tpu.ir.functions as jfun
import minotaur_tpu.ir.problem as jprob
import minotaur_tpu.models.generators as jgen
import minotaur_tpu.utils.types as jtypes
import minotaur_tpu_torch.ir.expr as texpr
import minotaur_tpu_torch.ir.functions as tfun
import minotaur_tpu_torch.ir.problem as tprob
import minotaur_tpu_torch.models.generators as tgen
import minotaur_tpu_torch.utils.types as ttypes
from minotaur_tpu.engines.ipm import IPMOptions as JIPMOptions
from minotaur_tpu.engines.ipm import build_single_solver as jbuild_single
from minotaur_tpu.engines.staging import StagedProblem as JStaged
from minotaur_tpu.glob import glob_step as jstep
from minotaur_tpu.glob.transformer import transform as jtransform
from minotaur_tpu.glob.univariate import make_uni_fns as jmake_uni_fns
from minotaur_tpu.ops.opcodes import Op
from minotaur_tpu_torch.convert import GLOB_FIELDS, glob_staged_from_numpy
from minotaur_tpu_torch.engines.ipm import IPMOptions, build_single_solver
from minotaur_tpu_torch.engines.staging import StagedProblem
from minotaur_tpu_torch.glob import glob_step as tstep
from minotaur_tpu_torch.glob.transformer import transform as ttransform
from minotaur_tpu_torch.glob.univariate import (LOG_FLOOR, make_uni_fns,
                                                 term_meta, uni_eval_np)

INF = float("inf")
JAX = SimpleNamespace(P=jprob, F=jfun, E=jexpr, T=jtypes, G=jgen)
PORT = SimpleNamespace(P=tprob, F=tfun, E=texpr, T=ttypes, G=tgen)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The problems are a few dozen columns wide: intra-op threads only
    contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the models
def _qknap(ns):
    return ns.G.quadratic_knapsack(8, 0.3, 3)


def _pool(ns):
    return ns.G.bilinear_pooling(2, 2)


def _mixed(ns):
    """tests/test_univariate.py's general-expression model (exp(x0) +
    x0*x1, log(x1 + 1) >= 0.5) with an integer x2, its square in the
    objective and a row coupling it to x0."""
    F, E, Op_ = ns.F, ns.E, Op
    p = ns.P.Problem("mixed")
    p.new_variable(0, 2)
    p.new_variable(0, 2)
    p.new_variable(0, 3, ns.T.VarType.INTEGER)
    g = E.ExprGraph()
    g.set_root(g.node(Op_.LOG, g.node(Op_.PLUS, g.var(1), g.num(1.0))))
    p.new_constraint(F.Function(nlf=g), 0.5, INF)
    p.new_constraint(F.Function(lf=F.LinearFunction({0: 1.0, 2: 1.0})),
                     -INF, 3.5)
    go = E.ExprGraph()
    go.set_root(go.node(Op_.PLUS, go.node(Op_.EXP, go.var(0)),
                        go.node(Op_.MULT, go.var(0), go.var(1))))
    qf = F.QuadraticFunction()
    qf.add_term(2, 2, -0.5)
    p.new_objective(F.Function(lf=F.LinearFunction({2: 0.3}), qf=qf,
                               nlf=go))
    return p


def _multi(ns):
    """A trilinear and a quadrilinear monomial (lambda hulls under
    multilinear_hull 8) on a mixed-sign box."""
    F, E = ns.F, ns.E
    p = ns.P.Problem("multi")
    for lo, hi in ((0, 1), (0, 1), (0, 1), (0, 1), (-1, 2), (0, 2),
                   (-1, 1)):
        p.new_variable(float(lo), float(hi))
    p.new_constraint(F.Function(lf=F.LinearFunction(
        {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0})), -INF, 3.0)
    p.new_constraint(F.Function(lf=F.LinearFunction(
        {4: 1.0, 5: 1.0, 6: 1.0})), -INF, 1.5)
    g = E.ExprGraph()
    q4 = g.node(Op.MULT, g.node(Op.MULT, g.var(0), g.var(1)),
                g.node(Op.MULT, g.var(2), g.var(3)))
    t3 = g.node(Op.MULT, g.node(Op.MULT, g.var(4), g.var(5)), g.var(6))
    g.set_root(g.node(Op.MINUS, g.node(Op.UMINUS, q4), t3))
    p.new_objective(F.Function(lf=F.LinearFunction({0: 0.25, 4: 0.2}),
                               nlf=g))
    return p


def _rltq(ns):
    """tests/test_rlt.py's dense QCQP: every pairwise product appears, so
    the equality row qualifies for RLT against every variable."""
    F = ns.F
    p = ns.P.Problem("rltq")
    for _ in range(3):
        p.new_variable(0.0, 2.0)
    p.new_constraint(F.Function(lf=F.LinearFunction(
        {0: 1.0, 1: 1.0, 2: 1.0})), 3.0, 3.0)
    qf = F.QuadraticFunction()
    for i, j in ((0, 1), (1, 2), (0, 2)):
        qf.add_term(i, j, 1.0)
    p.new_constraint(F.Function(qf=qf), -INF, 3.0)
    obj = F.QuadraticFunction()
    obj.add_term(0, 1, -1.0)
    obj.add_term(1, 2, -1.0)
    p.new_objective(F.Function(qf=obj))
    return p


# (opcode, payload, variable): every univariate opcode the transformer
# takes, integer/odd/negative/fractional powers and both CPOW bases;
# x0 straddles 0, x1 > 0, x2 >= 1, x3 inside (-1, 1), x4 spans the pole
# of 1/x and 1/x^2
UNI_TERMS = ((Op.EXP, 0, 0), (Op.POWK, 3.0, 0), (Op.POWK, 4.0, 0),
             (Op.SINH, 0, 0), (Op.TANH, 0, 0), (Op.ATAN, 0, 0),
             (Op.ASINH, 0, 0), (Op.ABS, 0, 0), (Op.SIN, 0, 0),
             (Op.COS, 0, 0), (Op.COSH, 0, 0), (Op.LOG, 0, 1),
             (Op.LOG10, 0, 1), (Op.SQRT, 0, 1), (Op.POWK, 2.5, 1),
             (Op.POWK, 0.5, 1), (Op.POWK, -0.5, 1), (Op.POWK, -1.0, 1),
             (Op.ACOSH, 0, 2), (Op.ASIN, 0, 3), (Op.ACOS, 0, 3),
             (Op.ATANH, 0, 3), (Op.TAN, 0, 3), (Op.CPOW, 2.0, 4),
             (Op.CPOW, 0.5, 4), (Op.POWK, -1.0, 4), (Op.POWK, -2.0, 4))


def _unimix(ns):
    F, E = ns.F, ns.E
    p = ns.P.Problem("unimix")
    for lo, hi in ((-1.0, 2.0), (0.5, 3.0), (1.0, 4.0), (-0.9, 0.9),
                   (-2.0, 2.0)):
        p.new_variable(lo, hi)
    g = E.ExprGraph()
    parts = [g.node(op, g.var(v), const=float(k)) for op, k, v in UNI_TERMS]
    g.set_root(g.sum_list(parts))
    p.new_objective(F.Function(lf=F.LinearFunction({0: 1.0}), nlf=g))
    return p


MODELS = {"qknap": (_qknap, {}), "pool": (_pool, {}), "mixed": (_mixed, {}),
          "multi": (_multi, {"multilinear_hull": 8}), "rltq": (_rltq, {}),
          "unimix": (_unimix, {})}
RLT = {"rltq": 16}


def _both(name):
    build, kw = MODELS[name]
    return jtransform(build(JAX), **kw), ttransform(build(PORT), **kw)


def _boxes(gs, B, seed, wild=True):
    """B random sub-boxes of the root box; with `wild`, about a tenth of
    the bounds are infinite and a tenth of the columns have zero width,
    else only the original columns narrow (as branching narrows them).
    Integer columns get integral bounds."""
    rng = np.random.default_rng(seed)
    lo0 = np.where(np.isfinite(gs.vlb), gs.vlb, -10.0)
    hi0 = np.where(np.isfinite(gs.vub), gs.vub, 10.0)
    a = rng.uniform(lo0, hi0, size=(B, gs.n))
    b = rng.uniform(lo0, hi0, size=(B, gs.n))
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo = np.where(rng.uniform(size=lo.shape) < 0.3, lo0, lo)
    hi = np.where(rng.uniform(size=hi.shape) < 0.3, hi0, hi)
    ints = gs.int_mask
    lo[:, ints] = np.floor(lo[:, ints])
    hi[:, ints] = np.ceil(hi[:, ints])
    if not wild:
        lo[:, gs.n_x:], hi[:, gs.n_x:] = gs.vlb[gs.n_x:], gs.vub[gs.n_x:]
    else:
        lo = np.where(rng.uniform(size=lo.shape) < 0.1, -INF, lo)
        hi = np.where(rng.uniform(size=hi.shape) < 0.1, INF, hi)
        flat = rng.uniform(size=lo.shape) < 0.1
        hi = np.where(flat & np.isfinite(lo), lo, hi)
    lo[0], hi[0] = gs.vlb, gs.vub                       # the root box
    return lo, hi


def _assert_same(a, b, rtol, what):
    """Equal NaN and infinity patterns, finite entries within rtol."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    assert np.array_equal(np.isnan(a), np.isnan(b)), what
    assert np.array_equal(np.isposinf(a), np.isposinf(b)), what
    assert np.array_equal(np.isneginf(a), np.isneginf(b)), what
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol, atol=rtol,
                               err_msg=what)


# ------------------------------------------------------------ 1 transform
@pytest.mark.parametrize("name", sorted(MODELS))
def test_transform_matches_jax(name):
    gsj, gst = _both(name)
    assert gsj.name == gst.name
    for f in GLOB_FIELDS:
        a, b = getattr(gsj, f), getattr(gst, f)
        assert np.array_equal(np.asarray(a), np.asarray(b),
                              equal_nan=np.asarray(a).dtype.kind == "f"), f
    carried = glob_staged_from_numpy(gsj)
    for f in GLOB_FIELDS:
        assert np.array_equal(np.asarray(getattr(carried, f)),
                              np.asarray(getattr(gst, f))), f


def test_transform_covers_every_term_kind():
    assert _both("qknap")[1].n_y > 0 and _both("qknap")[1].int_mask.any()
    assert _both("unimix")[1].n_u == len(UNI_TERMS)
    gs = _both("multi")[1]
    assert gs.n_t == 1 and gs.n_q == 1


# ------------------------------------------------------------ 2 envelopes
@pytest.mark.parametrize("name", sorted(MODELS))
def test_envelopes_match_jax(name):
    gsj, _ = _both(name)
    gst = glob_staged_from_numpy(gsj)
    rlt = RLT.get(name, 0)
    jenv = jstep.build_envelope_fn(gsj, jstep.GlobStepOptions(rlt_cuts=rlt))
    tenv = tstep.build_envelope_fn(
        gst, tstep.GlobStepOptions(rlt_cuts=rlt), device="cpu")
    lo, hi = _boxes(gsj, 32, seed=11)
    with np.errstate(all="ignore"):
        ja = [np.asarray(v) for v in jax.vmap(jenv)(lo, hi)]
    ta = [v.numpy() for v in tenv(lo, hi)]
    m_bil, m_uni = 4 * gst.n_y, 4 * gst.n_u
    blocks = (("algebraic", slice(0, m_bil), 1e-12),
              ("univariate", slice(m_bil, m_bil + m_uni), 1e-10),
              ("rlt and hull", slice(m_bil + m_uni, None), 1e-12))
    assert ja[0].shape == ta[0].shape
    for what, rows, rtol in blocks:
        for k, part in enumerate(("env_A", "env_lb", "env_ub")):
            _assert_same(ja[k][:, rows], ta[k][:, rows], rtol,
                         f"{name} {what} {part}")
    if name == "rltq":
        assert ja[0].shape[1] > m_bil + m_uni       # RLT rows present
    # some rows are active and some deactivated by the infinite bounds
    assert np.isfinite(ta[1]).any() and np.isinf(ta[1]).any()


# ------------------------------------------------------------ 3 uni fns
UNI_CODES = np.array([int(op) for op, _, _ in UNI_TERMS], dtype=np.int32)
UNI_KS = np.array([float(k) for _, k, _ in UNI_TERMS])


def _intervals(rng, B, n):
    """Intervals straddling 0, the poles of tan at +-pi/2 and the
    domain edges, some with infinite ends."""
    centres = rng.choice([0.0, math.pi / 2, -math.pi / 2, 1.0, -1.0, 3.0],
                         size=(B, n))
    a = centres + rng.normal(scale=1.5, size=(B, n))
    b = centres + rng.normal(scale=1.5, size=(B, n))
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo = np.where(rng.uniform(size=lo.shape) < 0.1, -INF, lo)
    hi = np.where(rng.uniform(size=hi.shape) < 0.1, INF, hi)
    return lo, hi


def test_uni_fns_match_jax():
    jf = jmake_uni_fns(UNI_CODES, UNI_KS)
    tf = make_uni_fns(UNI_CODES, UNI_KS, "cpu")
    rng = np.random.default_rng(5)
    B, n = 64, len(UNI_CODES)
    x = rng.normal(scale=2.0, size=(B, n))
    x[:8] = np.array([0.0, 1.0, -1.0, math.pi / 2, 1e-300, -700.5, 800.0,
                      1e9])[:, None]
    lo, hi = _intervals(rng, B, n)
    ylo, yhi = _intervals(rng, B, n)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    with np.errstate(all="ignore"):
        for k, (jfn, tfn) in enumerate(zip(jf[:2], tf[:2])):
            _assert_same(jax.jit(jax.vmap(jfn))(x), tfn(t(x)).numpy(), 1e-10,
                         ("fval", "fder")[k])
        for k, (jfn, tfn, a, b) in enumerate(((jf[2], tf[2], lo, hi),
                                              (jf[3], tf[3], ylo, yhi))):
            ja = [np.asarray(v) for v in jax.jit(jax.vmap(jfn))(a, b)]
            ta = tfn(t(a), t(b))
            if k == 0:
                # log and log10 ranges that start below 1e-300: the port's
                # ends at the smallest double's value, the JAX package's
                # at 1e-300's
                floor = np.array([LOG_FLOOR.get(Op(int(c)), np.nan)
                                  for c in UNI_CODES])
                low = np.isfinite(floor)[None, :] & (a < 1e-300)
                assert low.any()
                np.testing.assert_array_equal(
                    ta[0].numpy()[low], np.broadcast_to(floor, a.shape)[low])
                assert np.all(ja[0][low] > ta[0].numpy()[low])
                ja[0] = np.where(low, ta[0].numpy(), ja[0])
            for side in (0, 1):
                _assert_same(ja[side], ta[side].numpy(), 1e-10,
                             (("frange", "fback")[k], side))


@settings(max_examples=60, deadline=None)
@given(term=st.integers(0, len(UNI_TERMS) - 1),
       a=st.floats(-6.0, 6.0), w=st.floats(0.0, 6.0),
       u=st.lists(st.floats(0.0, 1.0), min_size=8, max_size=8))
def test_frange_encloses_samples(term, a, w, u):
    op, k, _ = UNI_TERMS[term]
    meta = term_meta(int(op), float(k))
    lo = max(a, meta["dom_lo"])
    hi = min(a + w, meta["dom_hi"])
    if lo > hi:
        return
    fns = make_uni_fns(np.array([int(op)]), np.array([float(k)]), "cpu")
    t = lambda v: torch.tensor([[v]], dtype=torch.float64)  # noqa: E731
    rlo, rhi = (float(v) for v in fns[2](t(lo), t(hi)))
    for s in u:
        xs = lo + s * (hi - lo)
        if op is Op.POWK and k < 0 and xs == 0.0:
            continue
        fx = uni_eval_np(int(op), xs, float(k))
        if not math.isfinite(fx):
            continue
        tol = 1e-9 * (1.0 + abs(fx))
        assert rlo - tol <= fx <= rhi + tol, (op, k, lo, hi, xs, fx,
                                              rlo, rhi)


# ----------------------------------------------------- 4, 5 FBBT and step
FBBT_MODELS = ("qknap", "mixed", "unimix")
STEP_MODELS = ("qknap", "mixed")


@pytest.fixture(scope="module")
def step_runs():
    """Both packages' steps (f64 factors) at B = 16 on each model: one
    batch of wild boxes (FBBT) and one of plain sub-boxes (the step)."""
    out = {}
    for name in FBBT_MODELS:
        gsj, _ = _both(name)
        gst = glob_staged_from_numpy(gsj)
        js = jstep.build_glob_step(gsj, jstep.GlobStepOptions(
            ipm=JIPMOptions(factor_f32=False)))
        ts = tstep.build_glob_step(gst, tstep.GlobStepOptions(
            ipm=IPMOptions(factor_f32=False)), device="cpu")
        runs = {}
        for kind, seed in (("wild", 3), ("plain", 4))[
                :2 if name in STEP_MODELS else 1]:
            lo, hi = _boxes(gsj, 16, seed=seed, wild=kind == "wild")
            x0 = np.zeros_like(lo)
            with np.errstate(all="ignore"):
                jr = js(lo, hi, x0, 0.0)
            runs[kind] = ({f: np.asarray(v) for f, v in
                           jr._asdict().items()},
                          ts(lo, hi, x0)._asdict())
        out[name] = runs
    return out


@pytest.mark.parametrize("name", FBBT_MODELS)
def test_fbbt_matches_jax(name, step_runs):
    jr, tr = step_runs[name]["wild"]
    assert np.array_equal(jr["fbbt_infeas"], tr["fbbt_infeas"])
    for f in ("new_vlb", "new_vub"):
        _assert_same(jr[f], tr[f], 1e-10, f)
    # the boxes tightened somewhere and some lanes were infeasible or not
    lo, hi = _boxes(_both(name)[0], 16, seed=3)
    assert (tr["new_vlb"] > lo).any() or (tr["new_vub"] < hi).any()


@pytest.mark.parametrize("name", STEP_MODELS)
def test_step_matches_jax_lane_by_lane(name, step_runs):
    jr, tr = step_runs[name]["plain"]
    for f in ("status", "branch_var", "is_spatial", "int_feasible",
              "term_feasible", "fbbt_infeas"):
        assert np.array_equal(jr[f], tr[f]), (f, jr[f], tr[f])
    for f in ("dual_bound", "obj", "branch_val"):
        tol = 1e-6 * (1.0 + np.abs(jr[f]))
        assert np.all(np.abs(jr[f] - tr[f]) <= tol), (f, jr[f], tr[f])
    assert (tr["status"] == 1).sum() >= 8


def test_step_mixed_policy_bounds_cross():
    """Default IPM options (f32 factors): each package's certified bound
    lies below the other's objective on every lane the other solved."""
    gsj, _ = _both("qknap")
    gst = glob_staged_from_numpy(gsj)
    lo, hi = _boxes(gsj, 16, seed=4, wild=False)
    x0 = np.zeros_like(lo)
    jr = jstep.build_glob_step(gsj, jstep.GlobStepOptions())(lo, hi, x0, 0.0)
    tr = tstep.build_glob_step(gst, tstep.GlobStepOptions(),
                               device="cpu")(lo, hi, x0)
    jr = {f: np.asarray(v) for f, v in jr._asdict().items()}
    tr = tr._asdict()
    for a, b in ((jr, tr), (tr, jr)):
        lim = b["obj"] + 1e-6 * (1.0 + np.abs(b["obj"]))
        bad = (b["status"] == 1) & (a["dual_bound"] > lim)
        assert not bad.any(), (a["dual_bound"], b["obj"])
    assert ((tr["status"] == 1) & (jr["status"] == 1)).sum() >= 8


# ------------------------------------------------ 7 the lane-batched IPM
def _lane_rows(name, B, seed):
    """The glob LP of each lane (base rows + envelopes at its box)."""
    gsj, _ = _both(name)
    gst = glob_staged_from_numpy(gsj)
    lo, hi = _boxes(gsj, B, seed=seed, wild=False)
    eA, elb, eub = (v.numpy() for v in tstep.build_envelope_fn(
        gst, device="cpu")(lo, hi))
    A = np.concatenate([np.broadcast_to(gst.A, (B,) + gst.A.shape), eA], 1)
    clb = np.concatenate([np.broadcast_to(gst.clb, (B, len(gst.clb))), elb],
                         1)
    cub = np.concatenate([np.broadcast_to(gst.cub, (B, len(gst.cub))), eub],
                         1)
    return gst, A, clb, cub, lo, hi


def _staged(cls, gs, A, clb, cub):
    return cls(name="lanes", n=gs.n, m=A.shape[-2], c=gs.c,
               obj_const=gs.obj_const, Qobj=None, obj_nl=None,
               A=A[0], clb=np.full(A.shape[-2], -INF),
               cub=np.full(A.shape[-2], INF), vlb=gs.vlb, vub=gs.vub,
               int_mask=gs.int_mask, nl_rows=np.zeros(0, np.int32),
               con_nl=None, nl_graphs=[])


@pytest.mark.parametrize("factor_f32", [True, False])
def test_ipm_lane_batched_a_equals_shared(factor_f32):
    gst, A, clb, cub, lo, hi = _lane_rows("qknap", 8, seed=6)
    sp = _staged(StagedProblem, gst, A, clb, cub)
    solve = build_single_solver(sp, IPMOptions(factor_f32=factor_f32),
                                device="cpu")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                  dtype=torch.float64)
    x0 = t(np.zeros_like(lo))
    shared = solve(t(A[0]), t(clb[0]), t(cub[0]), t(lo), t(hi), x0)
    lanes = solve(t(np.broadcast_to(A[0], A.shape)),
                  t(np.broadcast_to(clb[0], clb.shape)),
                  t(np.broadcast_to(cub[0], cub.shape)), t(lo), t(hi), x0)
    for f in shared._fields:
        a, b = getattr(shared, f).numpy(), getattr(lanes, f).numpy()
        if f in ("status", "iters"):
            assert np.array_equal(a, b), f
        else:
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12,
                                       err_msg=f)
    assert (shared.status == 1).all()


def test_ipm_per_lane_rows_match_jax_vmap():
    gst, A, clb, cub, lo, hi = _lane_rows("mixed", 8, seed=7)
    x0 = np.zeros_like(lo)
    jsolve = jbuild_single(_staged(JStaged, gst, A, clb, cub),
                           JIPMOptions(factor_f32=False))
    jr = jax.jit(jax.vmap(jsolve))(A, clb, cub, lo, hi, x0)
    tsolve = build_single_solver(_staged(StagedProblem, gst, A, clb, cub),
                                 IPMOptions(factor_f32=False), device="cpu")
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                  dtype=torch.float64)
    tr = tsolve(t(A), t(clb), t(cub), t(lo), t(hi), t(x0))
    assert np.array_equal(np.asarray(jr.status), tr.status.numpy())
    for f in ("obj", "dual_bound"):
        a, b = np.asarray(getattr(jr, f)), getattr(tr, f).numpy()
        assert np.all(np.abs(a - b) <= 1e-6 * (1.0 + np.abs(a))), f
    assert (tr.status == 1).sum() >= 4
