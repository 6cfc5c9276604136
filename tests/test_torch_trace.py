"""The port's tracer (`minotaur_tpu_torch/utils/trace.py`) and its spans.

- The tracer's own rules: off it records nothing and `count` goes nowhere;
  it is on exactly while a `torch.profiler` session runs, and each
  session starts anew; `count` adds to the innermost open span, and once
  the profiler stops it adds nothing to the spans still open; it keeps
  the newest records and counts the rest; `self_ns` subtracts the union
  of a span's children.
- Off means off: with no profiler, a host-tree search, a device-pool
  search and a global search record nothing.
- Tracing changes no result: the three searches end with the same
  status, bounds and node counts under `torch.profiler`.
- Spans nest: every child lies inside its parent, and the layers nest in
  their order.
- Under `torch.profiler` every span is also a host event of the same
  name, within 50 us of the recorder's start and end but for the few
  spans a shared host delays (the recorder stamps `time.time_ns()`, the
  profiler's clock), and every blocking read
  inside an `ipm.solve` (`aten::_local_scalar_dense`, `aten::nonzero`)
  lies inside an `ipm.sync` span, so `ipm.host_reads_per_iter` counts
  them all.
- On one batch the summed `lane_iters` equals the lanes' returned
  iterations (a QP batch's closing ratcheted step adds one to each lane
  that ended on no sentinel; an NL batch has none).
- A `k2` span counts `refining` as refine_steps asks and, on the CPU, no
  `cluster`; the benchmark's `k2.cluster_share` reads `cluster` over
  `refining` from such spans, and nothing from spans without the counts
  or a slice with no refining call.
"""

import collections
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.engines.ipm import IPMOptions, build_batch_solver
from minotaur_tpu_torch.engines.staging import stage_problem
from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
from minotaur_tpu_torch.models import generators as G
from minotaur_tpu_torch.models.convex_suite import SUITE
from minotaur_tpu_torch.ops.spd_solve import spd_solve
from minotaur_tpu_torch.utils import trace
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.trace import Tracer, self_ns


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _tracer_reset():
    trace.reset()
    yield
    trace.reset()


def _profile():
    return profile(activities=[ProfilerActivity.CPU])


def _env(**opts):
    env = Environment()
    for k, v in dict(log_level=1, **opts).items():
        env.set_option(k, v)
    return env


SEARCHES = {
    "tree": lambda: BranchAndBound(
        G.correlated_knapsack(n=20, seed=3),
        _env(node_batch=8, dtype="f64", bnb_node_limit=120), device="cpu"),
    "pool": lambda: BranchAndBound(
        G.correlated_knapsack(n=20, seed=3),
        _env(node_batch=8, dtype="f64", device_tree=1, device_pool_cap=32,
             device_rounds=6, device_warm_batches=2), device="cpu"),
    "glob": lambda: GlobBranchAndBound(
        G.quadratic_knapsack(8, seed=3), _env(node_batch=16), device="cpu"),
}


def _search(name):
    bab = SEARCHES[name]()
    status = bab.solve()
    nodes = bab.nodes_processed if name == "glob" else \
        bab.stats.nodes_processed
    return (status, bab.lb, bab.ub, nodes), bab


@pytest.fixture(scope="module")
def untraced():
    """Each search with tracing off, and what the tracer kept meanwhile."""
    out = {}
    for name in SEARCHES:
        trace.reset()
        out[name] = (_search(name)[0], trace.spans())
    return out


@pytest.fixture(scope="module")
def traced():
    """Each search under torch.profiler: its result, runner, records and
    the profiler's host events."""
    out = {}
    for name in SEARCHES:
        trace.reset()
        with _profile() as prof:
            res, bab = _search(name)
        out[name] = (res, bab, trace.spans(), _kineto(prof))
    return out


# ---- the tracer's own rules ----------------------------------------------
def test_off_returns_the_shared_noop_and_count_goes_nowhere():
    t = Tracer()
    a, b = t.span("x", n=1), t.span("y")
    assert a is b is trace.NOOP
    with a:
        t.count("n", 5)
    assert t.spans() == [] and t.dropped() == 0


def test_sessions_counts_and_the_bound_on_records():
    t = Tracer(keep=4)
    with _profile():
        with t.span("outer", lanes=3):
            with t.span("inner"):
                t.count("iters")
                t.count("iters", 2)
            t.count("lane_iters", 7)
    assert [(r.name, r.parent, r.counts) for r in t.spans()] == [
        ("outer", -1, {"lanes": 3, "lane_iters": 7}),
        ("inner", 0, {"iters": 3})]
    assert t.span("off") is trace.NOOP
    with _profile():
        for i in range(6):
            with t.span(f"s{i}"):
                pass
    recs = t.spans()
    # a new session: the two old records are gone; the newest 4 of 6 kept
    assert [r.name for r in recs] == ["s2", "s3", "s4", "s5"]
    assert t.dropped() == 2
    assert [r.index for r in recs] == [2, 3, 4, 5]
    t.reset()
    assert t.spans() == [] and t.dropped() == 0


def test_counts_after_the_profiler_stops_go_nowhere():
    t = Tracer()
    prof = _profile()
    prof.start()
    with t.span("ipm.solve", lanes=2):
        t.count("iters")
        prof.stop()
        t.count("iters")
        with t.span("ipm.iter"):
            t.count("lane_iters", 2)
        t.count("iters")
    assert [(r.name, r.counts) for r in t.spans()] == [
        ("ipm.solve", {"lanes": 2, "iters": 1})]
    assert t.spans()[0].t1 >= t.spans()[0].t0 > 0


def test_self_ns_subtracts_the_union_of_children():
    class R:
        def __init__(self, index, parent, t0, t1):
            self.index, self.parent, self.t0, self.t1 = index, parent, t0, t1
    recs = [R(5, -1, 0, 100), R(6, 5, 10, 40), R(7, 6, 20, 30),
            R(8, 5, 30, 50), R(9, 5, 90, 120)]
    # the first record's children cover [10, 50) and [90, 100): 50
    assert self_ns(recs) == [50, 20, 10, 20, 30]


# ---- the program's spans -------------------------------------------------
@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_off_records_nothing(name, untraced):
    assert untraced[name][1] == []


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_tracing_changes_no_result(name, untraced, traced):
    assert traced[name][0] == untraced[name][0]
    assert traced[name][2], "the profiled search recorded nothing"


EXPECT = {
    "tree": {"bnb.prepare", "bnb.handle", "step", "step.fbbt", "step.fetch",
             "ipm.solve", "ipm.iter", "ipm.sync", "k1", "k2"},
    "pool": {"bnb.prepare", "bnb.handle", "step", "step.fbbt", "step.fetch",
             "ipm.solve", "ipm.iter", "ipm.sync", "k1", "k2", "pool.call",
             "pool.round", "pool.sync", "pool.summary", "pool.spill"},
    "glob": {"glob.prepare", "glob.handle", "glob.polish", "step",
             "step.fbbt", "step.rows", "step.fetch", "ipm.solve", "ipm.iter",
             "ipm.sync", "k1", "k2"},
}
# each span's possible parents (None: a span outside any other)
PARENTS = {
    "bnb.prepare": {None}, "bnb.handle": {None}, "glob.prepare": {None},
    "glob.handle": {None}, "glob.polish": {None}, "pool.call": {None},
    "pool.summary": {None}, "pool.spill": {None},
    "pool.round": {"pool.call"}, "pool.sync": {"pool.call"},
    "step": {None, "pool.round", "bnb.handle"},
    "step.fbbt": {"step"}, "step.rows": {"step"},
    "step.fetch": {None, "bnb.handle", "glob.polish"},
    "ipm.solve": {"step", "glob.polish"},
    "ipm.iter": {"ipm.solve"}, "ipm.sync": {"ipm.solve", "ipm.iter"},
    # the closing ratcheted step of a QP solve runs outside `ipm.iter`
    "k1": {"ipm.iter", "ipm.solve"}, "k2": {"ipm.iter", "ipm.solve"},
}


@pytest.mark.parametrize("name", sorted(SEARCHES))
def test_spans_nest(name, traced):
    res, bab, recs, _ = traced[name]
    assert {r.name for r in recs} == EXPECT[name]
    first = recs[0].index
    for r in recs:
        assert 0 < r.t0 <= r.t1
        par = recs[r.parent - first] if r.parent >= 0 else None
        assert (par.name if par else None) in PARENTS[r.name], r
        if par is not None:
            assert par.t0 <= r.t0 and r.t1 <= par.t1
    sn = self_ns(recs)
    assert all(0 <= s <= r.t1 - r.t0 for r, s in zip(recs, sn))


def test_counts_agree_with_the_runners(traced):
    _, bab, recs, _ = traced["pool"]
    by = collections.defaultdict(float)
    for r in recs:
        for k, v in r.counts.items():
            by[r.name, k] += v
    pool = bab._dev_pool
    assert by["pool.summary", "processed"] == pool.processed
    assert sum(r.name == "pool.round" for r in recs) == pool.rounds
    assert sum(r.name == "pool.call" for r in recs) == pool.calls
    assert sum(r.name == "pool.spill" for r in recs) == bab.stats.rebalances
    assert by["pool.spill", "spilled"] > 0


def _kineto(prof):
    return [(e.name(), e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU]


@pytest.fixture(scope="module")
def profiled(traced):
    """The host tree under torch.profiler: the result, the records and
    the profiler's host events."""
    res, _, recs, events = traced["tree"]
    return res, recs, events


def test_profiler_turns_tracing_on_and_changes_no_result(profiled,
                                                          untraced):
    res, recs, _ = profiled
    assert res == untraced["tree"][0]
    assert {r.name for r in recs} == EXPECT["tree"]


def test_spans_are_profiler_events_on_its_clock(profiled):
    _, recs, events = profiled
    by_name = collections.defaultdict(list)
    for name, a, b in events:
        by_name[name].append((a, b))
    gaps = []
    for r in recs:
        near = min((max(abs(a - r.t0), abs(b - r.t1))
                    for a, b in by_name[r.name]), default=None)
        assert near is not None, f"{r.name} is no profiler event"
        gaps.append(near)
    # within 50 us; a shared host's scheduler delays one span in a few
    # hundred by more between the profiler's stamp and the recorder's
    # (another clock would be off by years)
    gaps.sort()
    assert gaps[len(gaps) // 2] <= 10_000
    assert gaps[int(0.99 * len(gaps))] <= 50_000, gaps[-20:]
    assert gaps[-1] <= 10_000_000


def test_every_read_in_the_ipm_is_an_ipm_sync(profiled):
    _, recs, events = profiled
    solves = [(r.t0, r.t1) for r in recs if r.name == "ipm.solve"]
    syncs = [(r.t0, r.t1) for r in recs if r.name == "ipm.sync"]
    reads = [(a, b) for name, a, b in events
             if name in ("aten::_local_scalar_dense", "aten::nonzero")
             and any(s0 <= a and b <= s1 for s0, s1 in solves)]
    assert reads
    for a, b in reads:
        assert any(s0 <= a and b <= s1 for s0, s1 in syncs), (a, b)
    iters = sum(r.counts.get("iters", 0) for r in recs
                if r.name == "ipm.solve")
    assert len(syncs) >= iters > 0


# ---- lane iterations on one batch -----------------------------------------
def _one_batch(problem, opts, lanes, seed):
    """One batch of `lanes` lanes on the root box, each from its own start
    inside the box; (the solve's record, the lanes' returned iters)."""
    sp = stage_problem(problem)
    solve = build_batch_solver(sp, opts, "cpu")
    rng = np.random.default_rng(seed)
    lo = np.where(np.isfinite(sp.vlb), sp.vlb, -10.0)
    hi = np.where(np.isfinite(sp.vub), sp.vub, 10.0)
    x0 = lo + rng.random((lanes, sp.n)) * (hi - lo)
    trace.reset()
    with _profile():
        res = solve(sp.A, sp.clb, sp.cub, np.tile(sp.vlb, (lanes, 1)),
                    np.tile(sp.vub, (lanes, 1)), x0)
    (rec,) = [r for r in trace.spans() if r.name == "ipm.solve"]
    iters = sum(r.name == "ipm.iter" for r in trace.spans())
    assert rec.counts["lanes"] == lanes and rec.counts["iters"] == iters
    return rec, np.asarray(res.iters), np.asarray(res.status)


@pytest.mark.parametrize("factor_f32", [True, False])
def test_lane_iters_on_a_qp_batch(factor_f32):
    rec, iters, status = _one_batch(
        G.convex_miqp(n_cont=5, n_int=6, seed=1),
        IPMOptions(factor_f32=factor_f32), lanes=6, seed=0)
    assert (status == 1).all()
    # the closing ratcheted step counts one more on every lane
    assert rec.counts["lane_iters"] + 6 == iters.sum()
    assert rec.counts["lane_iters"] < rec.counts["iters"] * 6


def test_lane_iters_on_an_nl_batch():
    gen = SUITE["expbudget_8a"][0]
    rec, iters, _ = _one_batch(gen(), IPMOptions(max_iters=40), lanes=4,
                               seed=1)
    assert rec.counts["lane_iters"] == iters.sum() > 0


# ---- K2's design counts ----------------------------------------------------


@pytest.mark.parametrize("steps", [0, 2])
def test_k2_span_counts_refining_and_no_cluster_on_the_cpu(steps):
    g = torch.Generator().manual_seed(steps)
    B, k = 3, 5
    A = torch.randn(B, k, k, generator=g, dtype=torch.float64)
    M = A @ A.transpose(1, 2) + k * torch.eye(k, dtype=torch.float64)
    ones = torch.ones(B, k, dtype=torch.float64)
    r = torch.randn(B, k, generator=g, dtype=torch.float64)
    with _profile():
        spd_solve(torch.linalg.inv(M), M, ones, 1e-3 * ones, r, steps)
    (rec,) = [x for x in trace.spans() if x.name == "k2"]
    assert rec.counts == {"refining": int(steps > 0), "cluster": 0}


def _cluster_share(monkeypatch, spans, traced=True):
    from benchmark.harness.registry import metric
    recs = [SimpleNamespace(name=name, t1=t1, counts=counts)
            for name, t1, counts in spans]
    monkeypatch.setattr(trace, "spans", lambda: recs)
    return metric("k2.cluster_share").read(
        {"trace": {"kernel_s": {}} if traced else None, "calls": []})


def test_cluster_share_reads_cluster_over_refining(monkeypatch):
    on = {"refining": 1, "cluster": 1}
    spans = [("k2", 5, on), ("k2", 6, {"refining": 1, "cluster": 0}),
             ("k2", 7, {"refining": 0, "cluster": 0}), ("k2", 8, dict(on)),
             ("ipm.solve", 9, {"refining": 4, "cluster": 0}),
             ("k2", 0, {"refining": 1, "cluster": 0})]     # still open
    assert _cluster_share(monkeypatch, spans) == pytest.approx(200.0 / 3)
    assert _cluster_share(monkeypatch, spans, traced=False) is None


@pytest.mark.parametrize("counts", [{}, {"refining": 0, "cluster": 0}])
def test_cluster_share_reads_nothing_without_refining_calls(monkeypatch,
                                                            counts):
    """Spans without the counts (a program that does not report its
    design) or with no refining call read nothing."""
    spans = [("k2", 5, dict(counts)), ("k2", 6, dict(counts))]
    assert _cluster_share(monkeypatch, spans) is None
