"""The port's multi-device layer (parallel/pool.py, parallel/dist_bnb.py,
solvers/mqgdist.py) against the JAX package's, on the CPU.

The JAX side runs on conftest.py's 8-device virtual CPU mesh; the port
runs the same partitions as `["cpu"] * 8` (a device list may repeat).
Inputs are made from seeds with numpy and fed to both packages.

- `deal_round_robin` on seeded bounds with ties, P in {1, 3, 8}: exact.
- The sharded step (B = 16 lanes, 8 partitions of 2) against the JAX
  package's `build_sharded_step` on correlated_knapsack(12, 2) and
  convex_miqp(4, 4, 1): the FBBT columns bit for bit under both dtype
  policies; under f64 factors statuses, iterations and branching
  variables equal, objectives and bounds within 1e-6 * (1 + |obj|), the
  fused bound within 1e-9.  (Under the mixed policy the two packages'
  f32 factors round differently, tests/test_torch_step.py.)
- The sharded step against the port's unsharded step, lane by lane: a
  lane's IPM does not depend on its batch-mates.
- `_rebalance` on the stuffed pools of tests/test_dist_qg.py::
  test_rebalance_is_bounded_at_scale (seed 0, 10^4 lopsided nodes, cap
  50 * P): pool sizes, pool contents and the migrated count equal to the
  JAX package's.
- `DistBranchAndBound` on correlated_knapsack(30, 1) (8 partitions,
  node_batch 16, lb_frequency 2): both packages SOLVED_OPTIMAL at the DP
  optimum with lb = ub, the same 275 nodes, rebalances, migrations and
  per-partition counts.  `DistQGBranchAndBound` on the same model (slow:
  the port's QG master takes about 2 min here) reaches the optimum in
  both packages; the node counts (JAX 265, port 263) part at the first
  superstep, where the root's master LP stops at the iteration cap in
  the JAX package under the mixed policy and converges in the port
  (under f64 factors both converge alike).
- The distributed step honours `dtype`: under `dtype f64` the JAX
  package's distributed step runs the mixed policy (its `_init_dist`
  builds `StepOptions` from three options), the port's runs f64, equal
  to its serial f64 step.
- The `mqgdist` CLI with `device="cpu"`, and the entry points' refusal
  of a CUDA device where there is none.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from minotaur_tpu.bnb.node import Node as JNode
from minotaur_tpu.bnb.step import StepOptions as JStepOptions
from minotaur_tpu.bnb.step import build_node_step as jax_step
from minotaur_tpu.engines.ipm import IPMOptions as JOpts
from minotaur_tpu.engines.staging import stage_problem as jax_stage
from minotaur_tpu.models import generators as JG
from minotaur_tpu.parallel import dist_bnb as jdist
from minotaur_tpu.parallel.pool import build_sharded_step as jax_sharded
from minotaur_tpu.parallel.pool import deal_round_robin as jax_deal
from minotaur_tpu.utils.environment import Environment as JEnv
from minotaur_tpu_torch.bnb.node import Node
from minotaur_tpu_torch.bnb.step import StepOptions, build_node_step
from minotaur_tpu_torch.convert import staged_fields, staged_from_numpy
from minotaur_tpu_torch.engines.ipm import IPMOptions
from minotaur_tpu_torch.io.nl_writer import write_nl
from minotaur_tpu_torch.models import generators as G
from minotaur_tpu_torch.models.convex_suite import SUITE
from minotaur_tpu_torch.parallel.dist_bnb import (DistBranchAndBound,
                                                  DistQGBranchAndBound)
from minotaur_tpu_torch.parallel.pool import (build_sharded_step,
                                              deal_round_robin)
from minotaur_tpu_torch.solvers import mqgdist
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import SolveStatus

P = 8
B = 16
F64 = dict(factor_f32=False, tail_factor_f32=False)
DIST_OPTS = dict(node_batch=16, lb_frequency=2, log_level=1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These problems have at most a few dozen variables: intra-op threads
    only contend with the other test workers, so the port runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(k=P):
    return Mesh(np.array(jax.devices()[:k]), ("nodes",))


def _env(cls=Environment, **opts):
    env = cls()
    for k, v in {**DIST_OPTS, **opts}.items():
        env.set_option(k, v)
    return env


@pytest.mark.parametrize("parts", [1, 3, 8])
def test_deal_round_robin_matches_jax(parts):
    rng = np.random.default_rng(parts)
    lbs = rng.integers(0, 12, size=101).astype(float)   # many ties
    lbs[::17] = np.inf
    mine = deal_round_robin(lbs, parts)
    assert mine.dtype == np.int32
    np.testing.assert_array_equal(mine, jax_deal(lbs, parts))
    assert np.bincount(mine, minlength=parts).max() - \
        np.bincount(mine, minlength=parts).min() <= 1


def _model(name, pkg):
    return pkg.correlated_knapsack(12, 2) if name == "cknap" \
        else pkg.convex_miqp(4, 4, 1)


def _inputs(sp, seed):
    """B seeded boxes (the root, sub-boxes with integers fixed, and one
    box with everything at its upper bound), starts and dual starts."""
    rng = np.random.default_rng(seed)
    lo = np.tile(sp.vlb, (B, 1))
    hi = np.tile(sp.vub, (B, 1))
    ints = np.where(sp.int_mask)[0]
    for b in range(1, B):
        pick = rng.choice(ints, size=min(len(ints), 1 + b % 5),
                          replace=False)
        v = np.clip(np.floor(rng.uniform(sp.vlb[pick], sp.vub[pick] + 1)),
                    sp.vlb[pick], sp.vub[pick])
        if b % 2:
            lo[b, pick] = np.maximum(v, lo[b, pick])
        else:
            hi[b, pick] = np.minimum(v, hi[b, pick])
    lo[B - 1] = hi[B - 1]                    # every variable at its max
    x0 = rng.uniform(0, 1, size=(B, sp.n))
    y0 = np.zeros((B, sp.m))
    y0[3] = -rng.uniform(0, 1, size=sp.m)
    return lo, hi, x0, y0


def _fbbt_equal(pr, jr):
    np.testing.assert_array_equal(pr.new_vlb, jr.new_vlb)
    np.testing.assert_array_equal(pr.new_vub, jr.new_vub)
    np.testing.assert_array_equal(pr.fbbt_infeas, jr.fbbt_infeas)


@pytest.mark.parametrize("name,policy", [("cknap", "mixed"), ("cknap", "f64"),
                                         ("cmiqp", "mixed"), ("cmiqp", "f64")])
def test_sharded_step_matches_jax(name, policy):
    jsp = jax_stage(_model(name, JG))
    sp = staged_from_numpy(staged_fields(jsp))
    kw = F64 if policy == "f64" else {}
    lo, hi, x0, y0 = _inputs(sp, 5)
    ub_in = 1e6
    jfn = jax_sharded(jsp, JStepOptions(ipm=JOpts(**kw)), _mesh())
    jr, jgub = jfn(jnp.asarray(jsp.A), jnp.asarray(jsp.clb),
                   jnp.asarray(jsp.cub), lo, hi, x0, y0, ub_in)
    fn = build_sharded_step(sp, StepOptions(ipm=IPMOptions(**kw)),
                            ["cpu"] * P)
    pr, gub = fn(torch.tensor(sp.A), torch.tensor(sp.clb),
                 torch.tensor(sp.cub), lo, hi, x0, y0, ub_in)
    assert pr._fields == jr._fields
    assert pr.status.shape == (B,) and pr.x.shape == (B, sp.n)
    _fbbt_equal(pr, jr)
    assert pr.fbbt_infeas[B - 1]
    ok = pr.int_feasible & (pr.status == 1)
    assert gub == min(ub_in, np.min(pr.obj[ok], initial=np.inf))
    if policy == "f64":
        assert pr.status.tolist() == jr.status.tolist()
        assert pr.iters.tolist() == jr.iters.tolist()
        assert pr.branch_var.tolist() == jr.branch_var.tolist()
        assert pr.int_feasible.tolist() == jr.int_feasible.tolist()
        live = pr.status != 2
        scale = 1 + np.abs(pr.obj[live])
        np.testing.assert_array_less(np.abs(pr.obj - jr.obj)[live],
                                     1e-6 * scale)
        np.testing.assert_array_less(
            np.abs(pr.dual_bound - jr.dual_bound)[live], 1e-6 * scale)
        assert abs(gub - jgub) <= 1e-9 * (1 + abs(jgub))


@pytest.mark.parametrize("parts", [2, 8])
def test_sharded_step_matches_unsharded(parts):
    """Each partition's slice through `step_b` gives what the whole batch
    through one `step_b` gives, lane by lane, under the default mixed
    policy: the IPM freezes a lane once it stops, so no lane depends on
    its batch-mates."""
    sp = staged_from_numpy(staged_fields(jax_stage(G.correlated_knapsack(
        12, 2))))
    lo, hi, x0, y0 = _inputs(sp, 6)
    fn = build_sharded_step(sp, StepOptions(), ["cpu"] * parts)
    consts = (torch.tensor(sp.A), torch.tensor(sp.clb), torch.tensor(sp.cub))
    pr, gub = fn(*consts, lo, hi, x0, y0)
    ur = build_node_step(sp, StepOptions(), device="cpu")(*consts, lo, hi,
                                                          x0, y0)
    assert pr.status.tolist() == ur.status.tolist()
    assert pr.iters.tolist() == ur.iters.tolist()
    assert pr.branch_var.tolist() == ur.branch_var.tolist()
    np.testing.assert_allclose(pr.obj, ur.obj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pr.dual_bound, ur.dual_bound, rtol=1e-12,
                               atol=1e-12)
    ok = ur.int_feasible & (ur.status == 1)
    assert gub == np.min(ur.obj[ok], initial=np.inf)
    # the replicas are cached while the caller passes the same tensors
    again, _ = fn(*consts, lo, hi, x0, y0)
    np.testing.assert_array_equal(again.x, pr.x)


def test_sharded_step_follows_new_consts():
    """New (A, clb, cub) tensors reach the next call (QG's cut epoch makes
    new device copies): a row that cuts every box off makes every lane
    infeasible."""
    sp = staged_from_numpy(staged_fields(jax_stage(G.correlated_knapsack(
        12, 2))))
    lo, hi, x0, y0 = _inputs(sp, 7)
    fn = build_sharded_step(sp, StepOptions(), ["cpu"] * 4)
    A, clb, cub = (torch.tensor(a) for a in (sp.A, sp.clb, sp.cub))
    first, _ = fn(A, clb, cub, lo, hi, x0, y0)
    assert (first.status == 1).any()
    clb2 = clb.clone()
    clb2[0] = cub[0] + 1e3                    # row 0 now has lb > ub
    second, _ = fn(A, clb2, cub, lo, hi, x0, y0)
    assert (second.status == 2).all()


def _stuff(bab, node_cls, p):
    """The pools of tests/test_dist_qg.py::test_rebalance_is_bounded_at_scale:
    10^4 open nodes, half in pool 0, bounds from seed 0."""
    n_total = 10_000
    rng = np.random.default_rng(0)
    counts = [n_total // 2] + [n_total // (2 * (p - 1))] * (p - 1)
    nid = 1
    for k, cnt in enumerate(counts):
        for _ in range(cnt):
            bab.pools[k].insert_candidate(node_cls(
                nid=nid, depth=1, lb=float(rng.uniform(0, 100)),
                vlb=bab.sp.vlb.copy(), vub=bab.sp.vub.copy()))
            nid += 1


def test_rebalance_matches_jax():
    jb = jdist.DistBranchAndBound(JG.correlated_knapsack(12, 2), _mesh(),
                                  env=_env(JEnv, lb_pop_cap=50))
    tb = DistBranchAndBound(G.correlated_knapsack(12, 2), ["cpu"] * P,
                            env=_env(lb_pop_cap=50))
    assert type(tb.pools[0]).__name__ == type(jb.pools[0]).__name__
    _stuff(jb, JNode, P)
    _stuff(tb, Node, P)
    sizes0 = [len(pool) for pool in tb.pools]
    jb._rebalance()
    tb._rebalance()
    sizes1 = [len(pool) for pool in tb.pools]
    assert sizes1 == [len(pool) for pool in jb.pools]
    assert sizes0 == [5000] + [714] * (P - 1)
    assert sum(sizes1) == sum(sizes0)
    assert tb.stats.nodes_migrated == jb.stats.nodes_migrated > 0
    assert tb.stats.rebalances == jb.stats.rebalances == 1
    cap = 50 * P
    for before, after in zip(sizes0, sizes1):
        assert before - after <= cap
    for tp, jp in zip(tb.pools, jb.pools):
        assert sorted(nd.nid for nd in tp.iter_nodes()) == \
            sorted(nd.nid for nd in jp.iter_nodes())


def _check_dist(bab, dp):
    assert bab.status == SolveStatus.SOLVED_OPTIMAL
    assert bab.ub == pytest.approx(dp, rel=1e-9)
    assert bab.lb == bab.ub
    assert bab.stats.rebalances >= 1
    assert bab.stats.nodes_migrated > 0
    assert sum(p.nodes_processed for p in bab.pools) == \
        bab.stats.nodes_processed


def test_dist_bnb_matches_jax():
    dp = G.knapsack_dp_optimum(30, 1)
    jb = jdist.DistBranchAndBound(JG.correlated_knapsack(30, 1), _mesh(),
                                  env=_env(JEnv))
    jb.solve()
    tb = DistBranchAndBound(G.correlated_knapsack(30, 1), ["cpu"] * P,
                            env=_env())
    tb.solve()
    _check_dist(jb, dp)
    _check_dist(tb, dp)
    assert tb.n_parts == jb.n_parts == P
    assert tb.stats.nodes_processed == jb.stats.nodes_processed == 275
    assert [p.nodes_processed for p in tb.pools] == \
        [p.nodes_processed for p in jb.pools]
    assert tb.stats.rebalances == jb.stats.rebalances
    assert tb.stats.nodes_migrated == jb.stats.nodes_migrated


def test_dist_qg_capped_is_sound():
    """DistQG on the same model, capped: the QG batch handler runs per
    partition, the balance rounds run, the bound stays sound."""
    dp = G.knapsack_dp_optimum(30, 1)
    tb = DistQGBranchAndBound(G.correlated_knapsack(30, 1), ["cpu"] * P,
                              env=_env(bnb_node_limit=40))
    st = tb.solve()
    assert st in (SolveStatus.SOLVED_NODE_LIMIT, SolveStatus.SOLVED_OPTIMAL)
    assert tb.lb <= dp + 1e-9 * abs(dp) and dp <= tb.ub + 1e-9 * abs(dp)
    assert tb.stats.rebalances >= 1
    assert sum(p.nodes_processed for p in tb.pools) == \
        tb.stats.nodes_processed >= 40


@pytest.mark.slow
def test_dist_qg_matches_jax():
    dp = G.knapsack_dp_optimum(30, 1)
    jb = jdist.DistQGBranchAndBound(JG.correlated_knapsack(30, 1), _mesh(),
                                    env=_env(JEnv))
    jb.solve()
    tb = DistQGBranchAndBound(G.correlated_knapsack(30, 1), ["cpu"] * P,
                              env=_env())
    tb.solve()
    _check_dist(jb, dp)
    _check_dist(tb, dp)
    # JAX 265 nodes, the port 263: the root master LP parts under the
    # mixed policy (f32 factors round differently in the two packages)
    assert abs(tb.stats.nodes_processed - jb.stats.nodes_processed) <= \
        0.1 * jb.stats.nodes_processed


def test_dist_step_honours_dtype():
    """Under `dtype f64` the JAX package's distributed step runs the
    default mixed policy (iterations equal to its serial mixed step, and
    not to its serial f64 step); the port's runs f64, equal to its own
    serial step under the same options.  On convex_miqp(4, 4, 1) the
    mixed policy runs most lanes to its 136-iteration cap, f64 factors
    converge them in 5-12."""
    opts = dict(dtype="f64", node_batch=B)
    jb = jdist.DistBranchAndBound(JG.convex_miqp(4, 4, 1), _mesh(),
                                  env=_env(JEnv, **opts))
    tb = DistBranchAndBound(G.convex_miqp(4, 4, 1), ["cpu"] * P,
                            env=_env(**opts))
    jsp = jb.sp
    lo, hi, x0, y0 = _inputs(tb.sp, 8)
    jA = (jnp.asarray(jsp.A), jnp.asarray(jsp.clb), jnp.asarray(jsp.cub))
    jd, _ = jb._sharded(*jA, lo, hi, x0, y0, np.inf)
    jmixed = jax_step(jsp, JStepOptions())(*jA, lo, hi, x0, y0)
    jf64 = jax_step(jsp, JStepOptions(ipm=JOpts(**F64)))(*jA, lo, hi, x0, y0)
    assert np.asarray(jd.iters).tolist() == np.asarray(jmixed.iters).tolist()
    assert np.asarray(jd.iters).tolist() != np.asarray(jf64.iters).tolist()

    assert not tb._step_opts.ipm.factor_f32
    consts = tb._device_consts()
    td, _ = tb._sharded(*consts, lo, hi, x0, y0, np.inf)
    tserial = tb._step(*consts, lo, hi, x0, y0)
    assert td.iters.tolist() == tserial.iters.tolist()
    assert td.status.tolist() == tserial.status.tolist()
    np.testing.assert_allclose(td.obj, tserial.obj, rtol=1e-12, atol=1e-12)
    # and the f64 iteration counts are the JAX package's serial f64 ones
    assert td.iters.tolist() == np.asarray(jf64.iters).tolist()


def test_mqgdist_cli(tmp_path, monkeypatch, capsys):
    gen, oracle, _ = SUITE["st_e14a"]
    path = str(tmp_path / "st_e14a.nl")
    write_nl(gen(), path)
    monkeypatch.chdir(tmp_path)
    rc = mqgdist.main([path, "--mesh_hosts", "4", "--node_batch", "16",
                       "--write_sol_file", "1"], device="cpu")
    out = capsys.readouterr()
    log = out.out + out.err
    assert rc == 0
    objs = [float(line.rsplit(" ", 1)[1]) for line in log.splitlines()
            if "best objective:" in line]
    opt = oracle()
    assert len(objs) == 1 and abs(objs[0] - opt) <= 1e-6 * (1 + abs(opt))
    assert "partitions: 4" in log
    assert os.path.exists(tmp_path / "st_e14a.sol")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without CUDA")
def test_cuda_without_a_card_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        DistBranchAndBound(G.correlated_knapsack(12, 2), ["cuda"] * 2)
    sp = staged_from_numpy(staged_fields(jax_stage(G.correlated_knapsack(
        12, 2))))
    with pytest.raises(RuntimeError, match="cuda"):
        build_sharded_step(sp, StepOptions(), ["cpu", "cuda"])
    path = str(tmp_path / "c.nl")
    write_nl(G.correlated_knapsack(12, 2), path)
    with pytest.raises(RuntimeError, match="cuda"):
        mqgdist.main([path, "--log_level", "1"])
