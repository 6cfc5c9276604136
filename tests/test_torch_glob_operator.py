"""The IPM's constraint operators (`engines/lane_rows.py`): the glob
step's per-lane operator against the dense (B, m, n) tensor that the
step's row builders add up, and the two dense kinds against
`torch.einsum` of their tensors.

- For every builder kind (McCormick and square rows, univariate rows, RLT
  rows, trilinear and quadrilinear hull rows) on random boxes, about a
  tenth of whose bounds are infinite: the operator's dense form is, bit
  for bit, the tensor that adding each block's values at its places into
  zeros gives (a place named twice adds in the block's order); A x and
  A' y in float64 within 1e-12 of |A| |x|, in float32 within 1e-6;
  `abs()`, the float32 copy and the selected rows exactly; the weighted
  Grams A' diag(w) A and A diag(h) A' within 1e-12 (float32: 1e-5) of
  their absolute sums, on the lanes whose values are finite.
- The products, Grams, abs(), f32 copies and selected rows of every
  kind: the structured one as above; the per-lane (B, m, n) and shared
  (m, n) dense kinds on that tensor rounded to integers in [-8, 8] (and
  lane 0's matrix for the shared one), with integer vectors and weights,
  equal to `torch.einsum` exactly: every sum is exact, so any order of
  summation gives the same value.  Their f64-class products (the hi/lo
  split) equal the float64 einsum too, and the structured operator's is
  itself.
- The same input gives the same bits twice.
- The IPM on the operator and on its dense form, on models whose lanes
  all converge or fail clearly: the same statuses and iteration counts,
  bounds and objectives within 1e-9, and the solve's `structured` count
  equal to its `iters`.
- On the card (`cuda`): one 64-lane superstep of the benchmark's QKP
  instance, structured against dense.  Under f64 factors: the same
  statuses, bounds and objectives within the IPM's tolerance (1e-8; the
  dense solve with its envelope rows reordered moves one lane's
  objective by 1.5e-9).  Under the glob step's f32 factors, where
  rounding alone moves lanes at the f32 limit (the dense solve with its
  rows reordered moves 6 of 64): the structured solve repeats bit for
  bit, statuses move only to or from the iteration limit, and lanes
  both call optimal agree within twice the tail's tolerance, each bound
  below the other's objective.

This file imports no jax: on the card, `python -m pytest --noconftest
tests/test_torch_glob_operator.py -m cuda`.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from minotaur_tpu_torch.engines.ipm import IPMOptions
from minotaur_tpu_torch.engines.lane_rows import (LaneRows, RowPattern,
                                                  as_operator)
from minotaur_tpu_torch.glob import glob_step as gstep
from minotaur_tpu_torch.glob.transformer import transform
from minotaur_tpu_torch.glob.univariate import make_uni_fns
from minotaur_tpu_torch.ir.expr import ExprGraph
from minotaur_tpu_torch.ir.functions import (Function, LinearFunction,
                                             QuadraticFunction)
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.models.generators import quadratic_knapsack
from minotaur_tpu_torch.ops.opcodes import Op
from minotaur_tpu_torch.utils import trace
from minotaur_tpu_torch.utils.types import VarType

F64, F32 = torch.float64, torch.float32
INF = float("inf")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- the models
def _squares():
    """x0 * x1, x0^2 and x2^2 (a square's row names x_i twice), an
    integer x2 and exp/log univariate terms."""
    p = Problem("squares")
    p.new_variable(-1.0, 2.0)
    p.new_variable(0.0, 2.0)
    p.new_variable(0, 3, VarType.INTEGER)
    g = ExprGraph()
    g.set_root(g.node(Op.LOG, g.node(Op.PLUS, g.var(1), g.num(1.0))))
    p.new_constraint(Function(nlf=g), 0.5, INF)
    p.new_constraint(Function(lf=LinearFunction({0: 1.0, 2: 1.0})),
                     -INF, 3.5)
    go = ExprGraph()
    go.set_root(go.node(Op.PLUS, go.node(Op.EXP, go.var(0)),
                        go.node(Op.MULT, go.var(0), go.var(1))))
    qf = QuadraticFunction()
    qf.add_term(2, 2, -0.5)
    qf.add_term(0, 0, 0.7)
    p.new_objective(Function(lf=LinearFunction({2: 0.3}), qf=qf, nlf=go))
    return p


def _multi():
    """A trilinear and a quadrilinear monomial (lambda hulls)."""
    p = Problem("multi")
    for lo, hi in ((0, 1), (0, 1), (0, 1), (0, 1), (-1, 2), (0, 2),
                   (-1, 1)):
        p.new_variable(float(lo), float(hi))
    p.new_constraint(Function(lf=LinearFunction(
        {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0})), -INF, 3.0)
    p.new_constraint(Function(lf=LinearFunction(
        {4: 1.0, 5: 1.0, 6: 1.0})), -INF, 1.5)
    g = ExprGraph()
    q4 = g.node(Op.MULT, g.node(Op.MULT, g.var(0), g.var(1)),
                g.node(Op.MULT, g.var(2), g.var(3)))
    t3 = g.node(Op.MULT, g.node(Op.MULT, g.var(4), g.var(5)), g.var(6))
    g.set_root(g.node(Op.MINUS, g.node(Op.UMINUS, q4), t3))
    p.new_objective(Function(lf=LinearFunction({0: 0.25, 4: 0.2}), nlf=g))
    return p


def _rltq():
    """Every pairwise product appears: the equality row qualifies for RLT
    against every variable."""
    p = Problem("rltq")
    for _ in range(3):
        p.new_variable(0.0, 2.0)
    p.new_constraint(Function(lf=LinearFunction({0: 1.0, 1: 1.0, 2: 1.0})),
                     3.0, 3.0)
    qf = QuadraticFunction()
    for i, j in ((0, 1), (1, 2), (0, 2)):
        qf.add_term(i, j, 1.0)
    p.new_constraint(Function(qf=qf), -INF, 3.0)
    obj = QuadraticFunction()
    obj.add_term(0, 1, -1.0)
    obj.add_term(1, 2, -1.0)
    p.new_objective(Function(qf=obj))
    return p


def _unimix():
    """Univariate terms of both curvatures over boxes that straddle 0."""
    p = Problem("unimix")
    for lo, hi in ((-1.0, 2.0), (0.5, 3.0), (-0.9, 0.9)):
        p.new_variable(lo, hi)
    g = ExprGraph()
    parts = [g.node(op, g.var(v), const=float(k)) for op, k, v in (
        (Op.EXP, 0, 0), (Op.POWK, 3.0, 0), (Op.SIN, 0, 0), (Op.LOG, 0, 1),
        (Op.SQRT, 0, 1), (Op.POWK, -1.0, 1), (Op.ATANH, 0, 2))]
    g.set_root(g.sum_list(parts))
    p.new_constraint(Function(lf=LinearFunction({0: 1.0, 1: 1.0})),
                     -INF, 3.0)
    p.new_objective(Function(lf=LinearFunction({0: 1.0}), nlf=g))
    return p


MODELS = {"qknap": (lambda: quadratic_knapsack(8, 0.3, 3), {}, 0),
          "squares": (_squares, {}, 0), "unimix": (_unimix, {}, 0),
          "rltq": (_rltq, {}, 16),
          "multi": (_multi, {"multilinear_hull": 8}, 0)}


def _gs(name):
    build, kw, rlt = MODELS[name]
    return transform(build(), **kw), gstep.GlobStepOptions(rlt_cuts=rlt)


def _boxes(gs, B, seed, wild=True):
    """B random sub-boxes of the root box (the first is the root); with
    `wild`, about a tenth of the bounds are infinite, else only the
    original columns narrow (as branching narrows them)."""
    rng = np.random.default_rng(seed)
    lo0 = np.where(np.isfinite(gs.vlb), gs.vlb, -10.0)
    hi0 = np.where(np.isfinite(gs.vub), gs.vub, 10.0)
    a = rng.uniform(lo0, hi0, size=(B, gs.n))
    b = rng.uniform(lo0, hi0, size=(B, gs.n))
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    if wild:
        lo = np.where(rng.uniform(size=lo.shape) < 0.1, -INF, lo)
        hi = np.where(rng.uniform(size=hi.shape) < 0.1, INF, hi)
    else:
        lo[:, gs.n_x:], hi[:, gs.n_x:] = gs.vlb[gs.n_x:], gs.vub[gs.n_x:]
    lo[0], hi[0] = gs.vlb, gs.vub
    t = lambda v: torch.as_tensor(v, dtype=F64)  # noqa: E731
    return t(lo), t(hi)


def _scattered(gs, opts, lo, hi):
    """The dense (B, m, n) operator as the step's blocks add up: base
    rows, then each block's values added at its places into zeros."""
    fns = make_uni_fns(gs.uni_f, gs.uni_k, "cpu") if gs.n_u else None
    builders = gstep._row_builders(gs, opts, torch.device("cpu"), fns)
    B, mb = lo.shape[0], gs.A.shape[0]
    m = mb + sum(b.m for b in builders)
    A = torch.zeros((B, m, gs.n), dtype=F64)
    A[:, :mb] = torch.as_tensor(gs.A, dtype=F64)
    lanes = torch.arange(B)[:, None]
    r0 = mb
    for b in builders:
        vals, _, _ = b.fn(lo, hi)
        A.index_put_((lanes, torch.as_tensor(r0 + b.rows),
                      torch.as_tensor(b.cols)), vals, accumulate=True)
        r0 += b.m
    return A


@pytest.fixture(scope="module", params=sorted(MODELS))
def lanes(request):
    """(name, gs, operator, dense tensor, eq rows) at 16 wild boxes."""
    gs, opts = _gs(request.param)
    step = gstep.build_glob_step(gs, opts, device="cpu")
    lo, hi = _boxes(gs, 16, seed=5)
    A, clb, cub = step.relaxation(lo, hi)
    D = _scattered(gs, opts, lo, hi)
    eq = torch.nonzero(torch.isfinite(clb[0]) & (clb[0] == cub[0])).flatten()
    return request.param, gs, A, D, eq


def _bits(t):
    return t.contiguous().view(torch.int64 if t.dtype == F64 else
                               torch.int32)


def _dense_kind(kind, D):
    """The dense operator of `kind` and its tensor: D rounded to integers
    in [-8, 8] (NaN as 0), per lane (B, m, n) or lane 0's (m, n) shared.
    With integer vectors and weights in [-8, 8] every product and sum of
    these tests is exact in float32 and float64."""
    T = torch.clamp(torch.round(torch.nan_to_num(D, nan=0.0)), -8.0, 8.0)
    T = T[0] if kind == "shared" else T
    return as_operator(T), T, ("" if kind == "shared" else "b")


def _ints(g, lo, hi, *shape):
    return torch.randint(lo, hi + 1, shape, generator=g).to(F64)


KINDS = ("structured", "lanes", "shared")


def _close(got, want, scale, rtol, what):
    """Equal NaN and infinity patterns; finite entries within rtol of
    `scale` (the same sum over absolute values)."""
    got, want, scale = (t.to(F64).numpy() for t in (got, want, scale))
    for f in (np.isnan, np.isposinf, np.isneginf):
        assert np.array_equal(f(got), f(want)), what
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin])
    assert np.all(err <= rtol * (scale[fin] + 1e-300)), (what, err.max())


# ---------------------------------------------------------------- the tests
def test_dense_form_is_the_blocks_added_up(lanes):
    name, gs, A, D, _ = lanes
    assert isinstance(A, LaneRows)
    assert A.pattern.m == D.shape[1] and A.pattern.n == gs.n
    assert torch.equal(_bits(A.dense()), _bits(D)), name
    assert torch.equal(_bits(A.abs().dense()), _bits(D.abs()))
    assert torch.equal(_bits(A.to(F32).dense()), _bits(D.to(F32)))
    # far fewer values than the dense form's entries
    assert A.vals.shape[1] < D.shape[1] * D.shape[2]


@pytest.mark.parametrize("kind", KINDS)
def test_products_match_the_dense_tensor(lanes, kind):
    name, gs, A, D, _ = lanes
    g = torch.Generator().manual_seed(3)
    B, m, n = D.shape
    if kind != "structured":
        op, T, b = _dense_kind(kind, D)
        x, y = _ints(g, -8, 8, B, n), _ints(g, -8, 8, B, m)
        mv, tv = f"{b}mn,bn->bm", f"{b}mn,bm->bn"
        for dt in (F64, F32):
            o, t, xd, yd = op.to(dt), T.to(dt), x.to(dt), y.to(dt)
            what = (name, kind, dt)
            assert torch.equal(o.mv(xd), torch.einsum(mv, t, xd)), what
            assert torch.equal(o.tv(yd), torch.einsum(tv, t, yd)), what
            assert torch.equal(o.abs().tv(yd.abs()),
                               torch.einsum(tv, t.abs(), yd.abs())), what
        assert torch.equal(op.split().mv(x), torch.einsum(mv, T, x))
        assert torch.equal(op.split().tv(y), torch.einsum(tv, T, y))
        assert torch.equal(op.expand(B), T.expand(B, m, n))
        return
    assert A.split() is A
    x = torch.randn(B, n, generator=g, dtype=F64)
    y = torch.randn(B, m, generator=g, dtype=F64)
    Dabs = D.abs()
    mv, tv = D @ x[:, :, None], (y[:, None, :] @ D)
    mv_s, tv_s = Dabs @ x.abs()[:, :, None], y.abs()[:, None, :] @ Dabs
    _close(A.mv(x), mv[..., 0], mv_s[..., 0], 1e-12, f"{name} A x")
    _close(A.tv(y), tv[:, 0], tv_s[:, 0], 1e-12, f"{name} A' y")
    A32 = A.to(F32)
    _close(A32.mv(x.to(F32)), mv[..., 0], mv_s[..., 0], 1e-6,
           f"{name} A x f32")
    _close(A32.tv(y.to(F32)), tv[:, 0], tv_s[:, 0], 1e-6,
           f"{name} A' y f32")
    _close(A.abs().tv(y.abs()), tv_s[:, 0], tv_s[:, 0], 1e-12,
           f"{name} |A|' |y|")


@pytest.mark.parametrize("kind", KINDS)
def test_selected_rows_are_the_dense_rows(lanes, kind):
    name, gs, A, D, eq = lanes
    m = D.shape[1]
    if kind != "structured":
        A, D, _ = _dense_kind(kind, D)
    picks = [eq, torch.tensor([0, m - 1]), torch.tensor([m - 1, 0, m // 2]),
             torch.arange(m)]
    for idx in picks:
        want = D[..., idx, :]
        assert torch.equal(_bits(A.rows(idx).data), _bits(want)), (name, idx)
        assert torch.equal(_bits(A.to(F32).rows(idx).data),
                           _bits(want.to(F32)))


@pytest.mark.parametrize("kind", KINDS)
def test_weighted_grams_match_the_dense_tensor(lanes, kind):
    name, gs, A, D, _ = lanes
    if kind != "structured":
        op, T, b = _dense_kind(kind, D)
        g = torch.Generator().manual_seed(4)
        B, m, n = D.shape
        w, h = _ints(g, 0, 8, B, m), _ints(g, 0, 8, B, n)
        gram, row_gram = f"{b}mi,bm,{b}mj->bij", f"{b}in,bn,{b}jn->bij"
        for dt in (F64, F32):
            o, t, wd, hd = op.to(dt), T.to(dt), w.to(dt), h.to(dt)
            G = o.gram(wd)
            assert torch.equal(G, torch.einsum(gram, t, wd, t)), (name, dt)
            assert torch.equal(G, G.transpose(1, 2))
            assert torch.equal(o.row_gram(hd),
                               torch.einsum(row_gram, t, hd, t)), (name, dt)
        return
    ok = torch.isfinite(A.vals).all(dim=1)
    assert ok.sum() >= 4, name
    A = LaneRows(A.pattern, A.vals[ok])
    D = D[ok]
    g = torch.Generator().manual_seed(4)
    B, m, n = D.shape
    w = torch.rand(B, m, generator=g, dtype=F64) * 10.0
    h = torch.rand(B, n, generator=g, dtype=F64) * 10.0
    Dt = D.transpose(1, 2)
    want = torch.matmul(Dt * w[:, None, :], D)
    scale = torch.matmul(Dt.abs() * w[:, None, :], D.abs())
    _close(A.gram(w), want, scale, 1e-12, f"{name} gram")
    _close(A.to(F32).gram(w.to(F32)), want, scale, 1e-5, f"{name} gram f32")
    want = torch.matmul(D * h[:, None, :], Dt)
    scale = torch.matmul(D.abs() * h[:, None, :], Dt.abs())
    _close(A.row_gram(h), want, scale, 1e-12, f"{name} row gram")
    _close(A.to(F32).row_gram(h.to(F32)), want, scale, 1e-5,
           f"{name} row gram f32")
    # the Gram is symmetric bit for bit
    G = A.to(F32).gram(w.to(F32))
    assert torch.equal(_bits(G), _bits(G.transpose(1, 2)))


def test_a_repeated_call_gives_the_same_bits(lanes):
    name, gs, A, D, eq = lanes
    gs, opts = _gs(name)
    step = gstep.build_glob_step(gs, opts, device="cpu")
    lo, hi = _boxes(gs, 16, seed=5)
    outs = []
    for _ in range(2):
        A, clb, cub = step.relaxation(lo, hi)
        g = torch.Generator().manual_seed(6)
        x = torch.randn(16, gs.n, generator=g, dtype=F64)
        y = torch.randn(16, A.pattern.m, generator=g, dtype=F64)
        w = torch.rand(16, A.pattern.m, generator=g, dtype=F64)
        h = torch.rand(16, gs.n, generator=g, dtype=F64)
        A32 = A.to(F32)
        outs.append([A.vals, clb, cub, A.mv(x), A.tv(y), A.gram(w),
                     A32.gram(w.to(F32)), A.row_gram(h), A.rows(eq).data,
                     A32.tv(y.to(F32))])
    for a, b in zip(*outs):
        assert torch.equal(_bits(a), _bits(b)), name


def test_repeated_places_add_as_the_blocks_add():
    """Places named up to three times, with values whose sum depends on
    the order: the slot's value is the sequential sum from 0, as adding
    the values in place gives."""
    n, m = 5, 4
    rows = np.array([0, 1, 0, 2, 0, 3, 1, 2])
    cols = np.array([1, 2, 1, 0, 1, 4, 2, 3])
    pattern = RowPattern(torch.zeros((0, n), dtype=F64), rows, cols, m)
    assert pattern.nnz == 5
    g = torch.Generator().manual_seed(7)
    vals = torch.randn(6, len(rows), generator=g, dtype=F64)
    vals[:, 0], vals[:, 2], vals[:, 4] = 1e16, 1.0, -1e16
    A = LaneRows(pattern, pattern.merge(vals))
    want = torch.zeros((6, m, n), dtype=F64)
    want.index_put_((torch.arange(6)[:, None], torch.as_tensor(rows),
                     torch.as_tensor(cols)), vals, accumulate=True)
    assert torch.equal(_bits(A.dense()), _bits(want))
    assert (A.dense()[:, 0, 1] == 0.0).all()        # (1e16 + 1) - 1e16


# ------------------------------------------------ the IPM on the operator
def _solve_both(name, opts):
    gs, sopts = _gs(name)
    step = gstep.build_glob_step(
        gs, gstep.GlobStepOptions(rlt_cuts=sopts.rlt_cuts, ipm=opts),
        device="cpu")
    lo, hi = _boxes(gs, 8, seed=9, wild=False)
    A, clb, cub = step.relaxation(lo, hi)
    x0 = torch.zeros_like(lo)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        s = step.solver(A, clb, cub, lo, hi, x0)
    spans = [r for r in trace.spans() if r.name == "ipm.solve"]
    d = step.solver(A.dense(), clb, cub, lo, hi, x0)
    trace.reset()
    return s, d, spans


# the mixed policy where every lane converges; the equality rows' Schur
# block (rltq's base row) under f64 factors.  The hull model's lanes are
# degenerate: rounding alone moves some between converged and stalled
@pytest.mark.parametrize("name,factor_f32", [
    ("qknap", True), ("qknap", False), ("unimix", True),
    ("squares", False), ("rltq", False)])
def test_ipm_on_the_operator_equals_the_dense_solve(name, factor_f32):
    s, d, spans = _solve_both(name, IPMOptions(factor_f32=factor_f32))
    assert torch.equal(s.status, d.status)
    assert torch.equal(s.iters, d.iters)
    for f in ("obj", "dual_bound"):
        a, b = getattr(s, f), getattr(d, f)
        assert torch.all((a - b).abs() <= 1e-9 * (1.0 + b.abs())), f
    assert (s.status == 1).sum() >= 4
    (rec,) = spans
    assert rec.counts["structured"] == rec.counts["iters"] > 0


# ------------------------------------------------------------ on the card
def _qkp_superstep(**ipm):
    """The benchmark's QKP instance (its configuration) under the glob
    step's options (the IPM's fields in `ipm` replaced), and 64 lanes as
    branching leaves them (a few items fixed at 0 or 1; lane 0 the
    root)."""
    import dataclasses
    import json
    from benchmark.generators import qkp_ghs
    from benchmark.harness.problem import to_problem
    from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
    from minotaur_tpu_torch.utils.environment import Environment
    with open("benchmark/configs/qkp-ghs-100-25.json") as f:
        cfg = json.load(f)
    inst = qkp_ghs.generate(cfg["sizes"], cfg["instance_seed"], 2**31 + 11,
                            0)
    env = Environment()
    for k, v in cfg["solver"].items():
        env.set_option(k, v)
    bab = GlobBranchAndBound(to_problem(inst), env, device="cuda")
    gs, opts = bab.gs, bab._step_opts
    step = bab._step if not ipm else gstep.build_glob_step(
        gs, dataclasses.replace(
            opts, ipm=dataclasses.replace(opts.ipm, **ipm)), "cuda")
    rng = np.random.default_rng(12)
    lo, hi = np.tile(gs.vlb, (64, 1)), np.tile(gs.vub, (64, 1))
    for b in range(1, 64):
        items = rng.choice(gs.n_x, size=rng.integers(1, 7), replace=False)
        lo[b, items] = hi[b, items] = rng.integers(0, 2, size=len(items))
    t = lambda a: torch.as_tensor(a, dtype=F64, device="cuda")  # noqa
    return step, t(lo), t(hi)


@pytest.mark.cuda
def test_qkp_superstep_structured_equals_dense_on_the_card():
    """The glob step's policy (f32 factors) on one 64-lane superstep:
    the structured solve repeats bit for bit; against the dense one, a
    lane's status moves only to or from the iteration limit (the dense
    solve itself moves such lanes when its rows are reordered: f32
    factors, lanes at the f32 limit); where both call a lane optimal the
    objectives agree within twice the tail's tolerance (1e-5) and each
    certified bound lies below the other's objective."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels)")
    step, lo, hi = _qkp_superstep()
    A, clb, cub = step.relaxation(lo, hi)
    x0 = torch.zeros_like(lo)
    s = step.solver(A, clb, cub, lo, hi, x0)
    s2 = step.solver(A, clb, cub, lo, hi, x0)
    for f in s._fields:
        assert torch.equal(getattr(s, f), getattr(s2, f)), f
    d = step.solver(A.dense(), clb, cub, lo, hi, x0)
    moved = s.status != d.status
    assert torch.all(~moved | (s.status == 4) | (d.status == 4))
    both = (s.status == 1) & (d.status == 1)
    assert both.sum() >= 40
    tol = 2e-5 * (1.0 + d.obj.abs())
    assert torch.all(((s.obj - d.obj).abs() <= tol)[both])
    for a, b in ((s, d), (d, s)):
        lim = b.obj + 1e-6 * (1.0 + b.obj.abs())
        assert not torch.any((b.status == 1) & (a.dual_bound > lim))


@pytest.mark.cuda
def test_qkp_superstep_f64_structured_equals_dense_on_the_card():
    """Under f64 factors the same superstep on the structured operator and
    on its dense form: the same statuses, bounds and objectives within
    the IPM's tolerance, relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels)")
    step, lo, hi = _qkp_superstep(factor_f32=False)
    A, clb, cub = step.relaxation(lo, hi)
    x0 = torch.zeros_like(lo)
    s = step.solver(A, clb, cub, lo, hi, x0)
    d = step.solver(A.dense(), clb, cub, lo, hi, x0)
    assert torch.equal(s.status, d.status)
    tol = IPMOptions().tol
    for f in ("obj", "dual_bound"):
        a, b = getattr(s, f), getattr(d, f)
        assert torch.all((a - b).abs() <= tol * (1.0 + b.abs())), \
            (f, ((a - b).abs() / (1.0 + b.abs())).max().item())
    assert (s.status == 1).sum() >= 32
