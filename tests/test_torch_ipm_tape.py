"""The IPM's tape (`engines/ipm.py`, `_Tape`): a shared-operator LP/QP
solve on a CUDA device replays its host-free stretches as CUDA graphs,
with every K1 and K2 call and every host read run eagerly between them.

- A sequence of solves through one solver gives, solve by solve, the
  bits of a fresh solver's eager solve: other boxes, two lane counts, with
  and without a dual start, and a box with a lane whose factorization
  fails, so that the retry island runs.  On the CPU the solver runs
  eagerly, and again with a stand-in for CUDA graphs (`_CpuGraph`: a
  capture records the aten ops it runs, a replay runs them again into
  the same tensors, a host read inside a capture raises), which takes the
  tape's own path: the static inputs refreshed each solve, the islands'
  outputs, the loops' state in place, a loop body recorded in a later
  solve.  The `replayed` count of `ipm.solve` counts the iterations run
  from a recorded body.
- The route, under that stand-in: of the three operator kinds only the
  shared one records a tape and replays it; a per-lane dense operator
  and a `LaneRows` stay eager, and only the `LaneRows` solves count
  `structured`, one for each iteration.
- On the card (`cuda` tests): the graphed path against the eager one on
  the main path's shape; a key seen once is not captured; per-lane
  operators and NL models stay eager; the cache drops its least recently
  used key past its size, and the memory of dropped tapes is freed.

This file imports no jax: on the card, `python -m pytest --noconftest
tests/test_torch_ipm_tape.py -m cuda`.
"""

import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from minotaur_tpu_torch.engines import ipm
from minotaur_tpu_torch.engines.ipm import IPMOptions, build_single_solver
from minotaur_tpu_torch.engines.lane_rows import LaneRows, RowPattern
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.ir.functions import (Function, LinearFunction,
                                             QuadraticFunction)
from minotaur_tpu_torch.ir.problem import Problem
from minotaur_tpu_torch.models.convex_suite import normcon
from minotaur_tpu_torch.models.convex_suite2 import intquad
from minotaur_tpu_torch.utils import trace
from minotaur_tpu_torch.utils.types import VarType

F64 = torch.float64

# the cells' policy (dtype f64 at the bench settings), the default mixed
# one (retry on, two loops), the bench settings' mixed one (one
# factorization, no retry read) and the f32 light phase with a corrector;
# all at 10 iterations (phase 1 at most 5), enough to take every path
POLICIES = {
    "f64": dict(factor_f32=False, tail_factor_f32=False, tail_kkt_rounds=4,
                refine_steps=0, chol_retry=False),
    "mixed": dict(),
    "bench": dict(tail_kkt_rounds=4, refine_steps=0, chol_retry=False),
    "f32": dict(light_phase1=True, tail_corr_f32=True,
                gondzio_correctors=1),
}
POLICIES = {k: dict(v, max_iters=10) for k, v in POLICIES.items()}


def ncqp(n=6, seed=0):
    """A box QP with one row whose first variable has negative curvature:
    on a wide box its condensed matrix is indefinite, so K1 fails there
    and the Gershgorin retry runs."""
    rng = np.random.default_rng(seed)
    p = Problem("ncqp")
    for j in range(n):
        p.new_variable(0.0, 4.0, VarType.INTEGER, f"x{j}")
    p.new_constraint(Function(lf=LinearFunction(
        {j: 1.0 for j in range(n)})), -np.inf, 2.0 * n, "budget")
    q = rng.uniform(0.5, 2.0, n)
    q[0] = -3.0
    t = rng.uniform(0.0, 4.0, n)
    p.new_objective(Function(
        lf=LinearFunction({j: float(-2.0 * q[j] * t[j]) for j in range(n)}),
        qf=QuadraticFunction({(j, j): float(q[j]) for j in range(n)})))
    return p


def _boxes(sp, B, seed, wide=False):
    rng = np.random.default_rng(seed)
    lo, hi = np.tile(sp.vlb, (B, 1)), np.tile(sp.vub, (B, 1))
    for b in range(1, B):
        pick = rng.choice(sp.n, size=int(rng.integers(1, sp.n // 2 + 1)),
                          replace=False)
        v = rng.integers(0, 5, size=len(pick)).astype(float)
        lo[b, pick] = v
        hi[b, pick] = v
    if wide:
        hi[1:, 0] = 40.0 * np.arange(1, B)
    return lo, hi


def _sequence(sp, B, dev):
    """(vlb, vub, x0, y0) of each solve: two keys (B lanes without a dual
    start, B // 2 lanes with one), each seen three or four times, the
    first key again after the second."""
    t = lambda a: torch.as_tensor(a, dtype=F64, device=dev)  # noqa: E731
    rng = np.random.default_rng(3)
    out = []
    for i, (lanes, dual) in enumerate([(B, False)] * 3 + [(B // 2, True)] * 3
                                      + [(B, False)]):
        lo, hi = _boxes(sp, lanes, i, wide=(i % 2 == 0))
        x0 = rng.uniform(0.0, 1.0, (lanes, sp.n))
        y0 = rng.uniform(-1.0, 0.0, (lanes, sp.m)) if dual else None
        out.append((t(lo), t(hi), t(x0), None if y0 is None else t(y0)))
    return out


def _packed(r):
    return torch.cat([r.x, r.y, r.obj[:, None], r.dual_bound[:, None],
                      r.status[:, None].to(F64), r.iters[:, None].to(F64),
                      r.kkt_err[:, None]], dim=1)


def _run(sp, opts, seq, dev, solve=None):
    """The packed result of each solve of `seq`, through `solve` (one
    solver for all) or a fresh solver each; with the `ipm.solve` counts."""
    t = lambda a: torch.as_tensor(a, dtype=F64, device=dev)  # noqa: E731
    A, clb, cub = t(sp.A).reshape(sp.m, sp.n), t(sp.clb), t(sp.cub)
    out, counts = [], []
    for lo, hi, x0, y0 in seq:
        if solve is None:
            s = build_single_solver(sp, opts, dev)
            out.append(_packed(s(A, clb, cub, lo, hi, x0, y0)))
            continue
        with profile(activities=[ProfilerActivity.CPU]):
            out.append(_packed(solve(A, clb, cub, lo, hi, x0, y0)))
        counts.append([r.counts for r in trace.spans()
                       if r.name == "ipm.solve"][-1])
    return out, counts


# ---------------------------------------------------------------- the CPU

class _CpuGraph:
    """A CUDA graph's stand-in on the CPU.  A capture runs and records the
    aten ops called in it; a replay runs them again, writing each fresh
    result into the tensor the capture made (a view or an in-place op
    writes through its input).  The replay that follows a capture is the
    capture's own run.  A host read inside a capture raises, as on the
    card, and so does a capture on the default stream."""
    READS = ("aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero",
             "aten.equal", "aten.item")
    captures = replays = 0

    def __init__(self):
        self.ops, self.mode, self.fresh = [], None, False

    def capture_begin(self, pool=None, capture_error_mode="global"):
        assert _Streams.cur is not _Streams.default, \
            "a capture needs a stream of its own"
        assert not gc.isenabled(), \
            "a collection inside a capture could free another tape's graphs"
        self.mode = _Record(self.ops)
        self.mode.__enter__()

    def capture_end(self):
        self.mode.__exit__(None, None, None)
        self.mode, self.fresh = None, True
        _CpuGraph.captures += 1

    def replay(self):
        _CpuGraph.replays += 1
        if self.fresh:
            self.fresh = False
            return
        for func, args, kwargs, outs in self.ops:
            new = tree_leaves(func(*args, **kwargs))
            for (o, alias), x in zip(outs, new):
                if not alias:
                    o.copy_(x)


class _Record(TorchDispatchMode):
    def __init__(self, ops):
        super().__init__()
        self.ops = ops

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = str(func.overloadpacket)
        if any(name == r or name.startswith(r + ".") for r in
               _CpuGraph.READS):
            raise RuntimeError(f"host read inside a capture: {name}")
        out = func(*args, **kwargs)
        ins = {t.untyped_storage().data_ptr() for t in
               tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)}
        outs = [(o, o.untyped_storage().data_ptr() in ins)
                for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        self.ops.append((func, args, kwargs, outs))
        return out


class _Stream:
    def __init__(self, device=None):
        self.device = device

    def wait_stream(self, other):
        pass


class _Streams:
    default = _Stream()
    cur = default

    @staticmethod
    def current_stream(device=None):
        return _Streams.cur

    @staticmethod
    @contextlib.contextmanager
    def stream(s):
        prev, _Streams.cur = _Streams.cur, s
        try:
            yield
        finally:
            _Streams.cur = prev


@pytest.fixture
def cpu_graphs(monkeypatch):
    """Tapes on the CPU, through `_CpuGraph`."""
    monkeypatch.setattr(ipm, "_graphs_on", lambda dev: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _CpuGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: object())
    monkeypatch.setattr(ipm, "_capture_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", _Streams.current_stream)
    monkeypatch.setattr(torch.cuda, "stream", _Streams.stream)
    _CpuGraph.captures = _CpuGraph.replays = 0
    yield
    assert _Streams.cur is _Streams.default


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROBLEMS = {"ncqp": lambda: ncqp(6, 0), "intquad": lambda: intquad(12, 4, 1)}


def _retries(sp, opts, seq):
    """K1 calls on fewer lanes than the batch: the retry island's."""
    calls = []
    inv = ipm.spd_inverse

    def spy(ms):
        calls.append(ms.shape[0])
        return inv(ms)
    ipm.spd_inverse = spy
    try:
        _run(sp, opts, seq, "cpu")
    finally:
        ipm.spd_inverse = inv
    return sum(b not in (len(s[0]) for s in seq) for b in calls)


CASES = [("eager", "ncqp", "f64"), ("eager", "intquad", "mixed")] + \
    [("cpu_graphs", name, policy) for name in sorted(PROBLEMS)
     for policy in sorted(POLICIES)]


@pytest.mark.parametrize("tape,name,policy", CASES)
def test_one_solver_matches_a_fresh_one_solve_by_solve(request, tape, name,
                                                       policy):
    if tape == "cpu_graphs":
        request.getfixturevalue("cpu_graphs")
    sp = stage_problem(PROBLEMS[name]())
    opts = IPMOptions(**POLICIES[policy])
    seq = _sequence(sp, 6, "cpu")
    solve = build_single_solver(sp, opts, "cpu")
    got, counts = _run(sp, opts, seq, "cpu", solve)
    if tape == "cpu_graphs":
        # fresh solvers solve once each: eager
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ipm, "_graphs_on", lambda dev: False)
            want, _ = _run(sp, opts, seq, "cpu")
    else:
        want, _ = _run(sp, opts, seq, "cpu")
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (i, (g - w).abs().max())
    iters = [c["iters"] for c in counts]
    rep = [c.get("replayed") for c in counts]
    if tape == "eager":
        assert rep == [0] * len(seq) and len(solve.tapes) == 0
    else:
        # solves 1 and 4 eager, 2 and 5 record (the iterations after a
        # loop's first replay), 3, 6 and 7 replay every iteration
        assert len(solve.tapes) == 2 and _CpuGraph.captures > 0
        assert rep[0] == rep[3] == 0
        assert [rep[i] for i in (2, 5, 6)] == [iters[i] for i in (2, 5, 6)]
        loops = 2 if policy != "f64" else 1
        assert iters[1] - loops <= rep[1] < iters[1]
        assert iters[4] - loops <= rep[4] < iters[4]
    if name == "ncqp" and policy != "bench":
        assert _retries(sp, opts, seq) > 0


def test_a_tape_goes_with_its_solver(cpu_graphs):
    """Nothing holds a tape in a cycle: dropping the solver frees its
    tapes (graphs and memory) without a collection."""
    sp = stage_problem(intquad(12, 4, 1))
    opts = IPMOptions(**POLICIES["mixed"])
    solve = build_single_solver(sp, opts, "cpu")
    A, clb, cub, lo, hi, x0 = _args(sp, "cpu", 4)
    on = gc.isenabled()
    gc.disable()
    try:
        for _ in range(3):
            solve(A, clb, cub, lo, hi, x0)
        (tape,) = solve.tapes._tapes.values()
        ref = weakref.ref(tape)
        del tape, solve
        assert ref() is None
    finally:
        if on:
            gc.enable()


def test_a_loop_body_recorded_in_a_later_solve(cpu_graphs):
    """A key whose recording solve ran no iteration of a loop records that
    body when a later solve first iterates it.  Under the mixed policy at
    tol 1e-4 phase 1 stops at the tail's own target, so the tail runs only
    for lanes that phase 1 (4 iterations at max_iters 8) left short: none
    on a box of fixed variables, all on the root box."""
    sp = stage_problem(intquad(12, 4, 1))
    opts = IPMOptions(tol=1e-4, max_iters=8)
    t = lambda a: torch.as_tensor(a, dtype=F64)  # noqa: E731
    args = (t(sp.A).reshape(sp.m, sp.n), t(sp.clb), t(sp.cub))
    fixed = np.ones((4, sp.n))
    root = (np.tile(sp.vlb, (4, 1)), np.tile(sp.vub, (4, 1)))
    boxes = [(fixed, fixed + (np.arange(sp.n) == 0)), ] * 2 + [root] * 2
    x0 = torch.zeros(4, sp.n, dtype=F64)
    solve = build_single_solver(sp, opts, "cpu")
    bodies = []
    for i, (lo, hi) in enumerate(boxes):
        got = _packed(solve(*args, t(lo), t(hi), x0))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(ipm, "_graphs_on", lambda dev: False)
            want = _packed(build_single_solver(sp, opts, "cpu")(
                *args, t(lo), t(hi), x0))
        assert torch.equal(got, want), i
        if i:
            (tape,) = solve.tapes._tapes.values()
            bodies.append([op.__self__.body is not None for op in tape.ops
                           if isinstance(getattr(op, "__self__", None),
                                         ipm._Loop)])
    # recorded with phase 1's body only; the tail's comes with the root box
    assert bodies == [[True, False], [True, True], [True, True]]


def test_only_a_shared_operator_replays(cpu_graphs):
    """Three solves on each operator kind, each kind through a solver of
    its own: the shared one replays its tape at the third solve; the
    per-lane dense one and a `LaneRows` (the model's one row as an
    envelope row of every lane) stay eager, and only the `LaneRows`
    solves count `structured`."""
    sp = stage_problem(intquad(12, 4, 1))
    opts = IPMOptions(**POLICIES["mixed"])
    B = 4
    A, clb, cub, lo, hi, x0 = _args(sp, "cpu", B)
    cols = np.nonzero(sp.A.reshape(sp.m, sp.n)[0])[0]
    pattern = RowPattern(A[:0], np.zeros(len(cols), np.int64), cols, 1)
    kinds = {"shared": A, "lanes": A.expand(B, sp.m, sp.n).contiguous(),
             "structured": LaneRows(pattern, A[0, cols].expand(B, -1))}
    for kind, op in kinds.items():
        solve = build_single_solver(sp, opts, "cpu")
        counts = []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU]):
                solve(op, clb, cub, lo, hi, x0)
            counts.append([r.counts for r in trace.spans()
                           if r.name == "ipm.solve"][-1])
        iters = [c["iters"] for c in counts]
        replayed = [c["replayed"] for c in counts]
        if kind == "shared":
            assert len(solve.tapes) == 1 and replayed[2] == iters[2] > 0
        else:
            assert len(solve.tapes) == 0 and replayed == [0, 0, 0], kind
        assert [c.get("structured") for c in counts] == \
            (iters if kind == "structured" else [None] * 3), kind


# --------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA graphs, the kernels)")
    return torch.device("cuda")


CELL = dict(factor_f32=False, tail_factor_f32=False, max_iters=28,
            tail_kkt_rounds=4, refine_steps=0, chol_retry=False)


@pytest.mark.cuda
@pytest.mark.parametrize("name,lanes,opts", [
    ("intquad300", 64, CELL),                # the cells' shape and policy
    ("intquad300", 64, POLICIES["mixed"]),
    ("ncqp", 6, POLICIES["f64"]), ("ncqp", 6, POLICIES["mixed"]),
    ("ncqp", 6, POLICIES["f32"])], ids=["cell", "mixed", "ncqp-f64",
                                        "ncqp-mixed", "ncqp-f32"])
def test_graphed_solves_match_eager_ones_on_the_card(cuda, name, lanes,
                                                     opts):
    p = intquad(300, 4, 0) if name == "intquad300" else ncqp(6, 0)
    sp = stage_problem(p)
    opts = IPMOptions(**opts)
    seq = _sequence(sp, lanes, cuda)
    solve = build_single_solver(sp, opts, cuda)
    got, counts = _run(sp, opts, seq, cuda, solve)
    want, _ = _run(sp, opts, seq, cuda)
    assert len(solve.tapes) == 2
    assert [c["replayed"] for c in counts][2] == counts[2]["iters"] > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (i, (g - w).abs().max().item())


def _args(sp, dev, lanes):
    t = lambda a: torch.as_tensor(a, dtype=F64, device=dev)  # noqa: E731
    lo, hi = _boxes(sp, lanes, 0)
    return (t(sp.A).reshape(sp.m, sp.n), t(sp.clb), t(sp.cub), t(lo), t(hi),
            torch.zeros(lanes, sp.n, dtype=F64, device=dev))


@pytest.mark.cuda
def test_a_key_is_captured_at_its_second_solve(cuda):
    sp = stage_problem(intquad(40, 4, 0))
    solve = build_single_solver(sp, IPMOptions(**CELL), cuda)
    solve(*_args(sp, cuda, 8))
    assert len(solve.tapes) == 0
    solve(*_args(sp, cuda, 4))
    assert len(solve.tapes) == 0
    solve(*_args(sp, cuda, 8))
    assert len(solve.tapes) == 1


@pytest.mark.cuda
def test_per_lane_operators_and_nl_models_stay_eager(cuda):
    sp = stage_problem(intquad(40, 4, 0))
    solve = build_single_solver(sp, IPMOptions(**CELL), cuda)
    A, clb, cub, lo, hi, x0 = _args(sp, cuda, 8)
    for _ in range(3):
        solve(A.expand(8, sp.m, sp.n).contiguous(), clb.expand(8, sp.m),
              cub.expand(8, sp.m), lo, hi, x0)
    assert len(solve.tapes) == 0
    spn = stage_problem(normcon(8, 7))
    solve = build_single_solver(spn, IPMOptions(max_iters=10), cuda)
    for _ in range(3):
        solve(*_args(spn, cuda, 4))
    assert len(solve.tapes) == 0


@pytest.mark.cuda
def test_the_cache_drops_its_oldest_key_and_frees_its_memory(cuda):
    sp = stage_problem(intquad(300, 4, 0))
    solve = build_single_solver(sp, IPMOptions(**CELL), cuda)

    def reserved():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    # what a process keeps once it has captured (the capture stream and
    # its cuBLAS workspace) is in the base
    for _ in range(2):
        solve(*_args(sp, cuda, 4))
    solve.tapes.clear()
    base = reserved()
    size = ipm._Tapes.SIZE
    for lanes in range(8, 8 + 2 * size):
        for _ in range(2):
            solve(*_args(sp, cuda, lanes))
        if lanes == 8 + size - 1:
            full = reserved() - base
    assert len(solve.tapes) == size
    assert [k[3][0][0] for k in solve.tapes._tapes] == \
        list(range(8 + size, 8 + 2 * size))
    # as many tapes of slightly wider keys: the dropped ones' memory went
    assert reserved() - base < 1.5 * full
    solve.tapes.clear()
    assert reserved() - base < 0.1 * full
