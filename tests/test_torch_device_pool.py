"""The device-resident node pool (`device_tree`) against the JAX package.

- One `multiround` call of the port's runner and of the JAX package's,
  from the same hand-built nodes (a root box plus branched boxes) under
  the same cutoff with `dtype f64`: the packed pools (C, 3n+m+7) and the
  summaries (12+6n) agree, exactly on occupancy, depth, branching
  variable and direction and the summary's counts, within
  1e-6 * (1 + |v|) on every float64 field (tests/test_torch_step.py's
  tolerance).
- The same call under the default mixed policy (f32 factors, which the
  two packages round differently): the same kinds of outcome per slot
  (occupancy, depth, branching variable and direction) and the same
  counts of processed, created and pruned nodes, and certified bounds
  that are sound against the enumerated optimum of each slot's box (the
  knapsack's 2^12 points; the best of them is the DP optimum), as
  chip_smoke phase 10a holds the glob step under that policy.
- Slot selection breaks ties by the lower slot, as approx_max_k does in
  the JAX package on the CPU.
- A round that starts with exactly 2B free slots routes its children
  into free slots only, with the JAX package's occupancy.
- The port's versions of tests/test_device_pool.py: the DP optimum (and
  the JAX driver's status and ub), the MIQP optimum equal to the host
  loop's, a pool too small for the search that spills to the host tree
  and still closes, and the eligibility gate.
"""

import numpy as np
import pytest
import torch

from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
from minotaur_tpu.bnb.device_pool import DevicePoolRunner as JaxRunner
from minotaur_tpu.bnb.node import Node as JaxNode
from minotaur_tpu.models import generators as JG
from minotaur_tpu.utils.environment import Environment as JaxEnv
from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.bnb.device_pool import DevicePoolRunner, select_slots
from minotaur_tpu_torch.bnb.node import Node
from minotaur_tpu_torch.models import generators as G
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import SolveStatus

B, C, T = 8, 64, 3
MODELS = {"cknap": ("correlated_knapsack", (12, 0)),
          "cmiqp": ("convex_miqp", (5, 6, 1))}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small problems: intra-op threads only contend with the other test
    workers, so the port runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _set(env, **opts):
    for k, v in opts.items():
        env.set_option(k, v)
    return env


def _runners(name, dtype="f64"):
    """The JAX and the port runner (B, C, T) on the same model, under
    `dtype` (f64, or "mixed": the default policy)."""
    gen, args = MODELS[name]
    opts = dict(node_batch=B, log_level=1, device_tree=1)
    if dtype != "mixed":
        opts["dtype"] = dtype
    jb = JaxBnB(getattr(JG, gen)(*args), _set(JaxEnv(), **opts))
    pb = BranchAndBound(getattr(G, gen)(*args), _set(Environment(), **opts),
                        device="cpu")
    assert jb._dev_pool_ok and pb._dev_pool_ok
    return (JaxRunner(jb, cap=C, batch=B, rounds=T),
            DevicePoolRunner(pb, cap=C, batch=B, rounds=T))


def _nodes(sp, count, seed, node_cls):
    """The root box, then `count - 1` boxes each with one to six
    integer variables branched (half of them with a finite inherited
    bound, so the pseudocost update runs); in the last box every integer
    variable sits at its lower bound (an integral relaxation)."""
    rng = np.random.default_rng(seed)
    ints = np.where(sp.int_mask)[0]
    out = [node_cls(nid=0, depth=0, lb=-np.inf, vlb=sp.vlb.copy(),
                    vub=sp.vub.copy())]
    for i in range(1, count):
        lo, hi = sp.vlb.copy(), sp.vub.copy()
        picks = rng.choice(ints, size=1 + i % 6, replace=False)
        for j in picks:
            mid = 0.5 * (lo[j] + hi[j])
            if rng.uniform() < 0.5:
                hi[j] = np.floor(mid)
            else:
                lo[j] = np.ceil(mid)
        out.append(node_cls(
            nid=i, depth=1 + i % 3,
            lb=-np.inf if i % 2 else float(rng.uniform(-1e3, -1e2)),
            vlb=lo, vub=hi, branch_var=int(picks[0]), branch_dir=i % 2,
            branch_frac=float(rng.uniform(0.1, 0.9))))
    out[-1].vub[ints] = out[-1].vlb[ints]
    return out


def _one_call(name, count, cutoff, seed=0, dtype="f64"):
    """One multiround call of both runners from the same nodes; returns
    (JAX pool, port pool, JAX summary, port summary, n, m)."""
    jr, pr = _runners(name, dtype)
    sp = pr.sp
    jst = jr._init_state(_nodes(jr.sp, count, seed, JaxNode))
    pst = pr._init_state(_nodes(sp, count, seed, Node))
    jst, jsum = jr._multiround(*jr.bab._device_consts(), jst,
                               np.float64(cutoff))
    pst, psum = pr._multiround(*pr.bab._device_consts(), pst, cutoff)
    # the scratch row of every pool field is outside the packed pool
    assert all(t.shape[0] == C + 1 for t in pst[:11])
    return (np.asarray(jr._pack_pool(jst)), pr._pack_pool(pst).numpy(),
            np.asarray(jsum), psum.numpy(), sp.n, sp.m)


def _close(a, b):
    """Equal non-finite entries, finite ones within 1e-6 * (1 + |v|)."""
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b))
    assert np.array_equal(a[~fin], b[~fin])
    assert np.all(np.abs(a[fin] - b[fin]) <= 1e-6 * (1 + np.abs(a[fin])))


@pytest.mark.parametrize("name,cutoff", [("cknap", np.inf),
                                         ("cmiqp", 10.0)])
def test_multiround_matches_jax(name, cutoff):
    jp, pp, js, ps, n, m = _one_call(name, 12, cutoff)
    assert jp.shape == pp.shape == (C, 3 * n + m + 7)
    assert js.shape == ps.shape == (12 + 6 * n,)
    o = 3 * n + m
    # occupancy, depth, branching variable and direction: exact
    for col in (o + 6, o + 1, o + 2, o + 3):
        assert np.array_equal(jp[:, col], pp[:, col]), col
    used = pp[:, o + 6] > 0.5
    _close(jp[used], pp[used])
    # rounds, pool size, unresolved/processed/created/pruned counts and
    # IPM iterations: exact
    counts = [0, 1, 6, 7, 8, 9, 10, 11]
    assert np.array_equal(js[counts], ps[counts])
    assert ps[0] == T and B < ps[7] <= B * T
    _close(js, ps)


def test_multiround_mixed_policy_is_sound():
    jp, pp, js, ps, n, m = _one_call("cknap", 12, np.inf, dtype="mixed")
    o = 3 * n + m
    # occupancy, depth, branching variable and direction: exact
    for col in (o + 6, o + 1, o + 2, o + 3):
        assert np.array_equal(jp[:, col], pp[:, col]), col
    # rounds, pool size, processed/created/pruned counts: exact (the
    # IPM iteration sum follows each package's rounding)
    counts = [0, 1, 6, 7, 8, 9, 10]
    assert np.array_equal(js[counts], ps[counts])
    assert ps[0] == T and ps[7] > B
    # every integer point of the knapsack, its objective and feasibility
    p = G.correlated_knapsack(*MODELS["cknap"][1])
    pts = ((np.arange(2 ** n)[:, None] >> np.arange(n)) & 1).astype(float)
    feas = np.array([p.is_feasible(x) for x in pts])
    objs = np.array([p.eval_objective(x) for x in pts])
    opt = G.knapsack_dp_optimum(*MODELS["cknap"][1])
    assert abs(objs[feas].min() - opt) <= 1e-9 * abs(opt)
    tol = 1e-6 * (1 + abs(opt))
    used = np.where(pp[:, o + 6] > 0.5)[0]
    assert used.size == ps[1]
    # the hand-built nodes carry made-up bounds: hold only the slots the
    # call wrote (a hand-built node never processed keeps its own box and
    # bound)
    sp = _runners("cknap", "mixed")[1].sp
    made = {(tuple(nd.vlb), tuple(nd.vub), nd.lb)
            for nd in _nodes(sp, 12, 0, Node)}
    written = [s for s in used if (tuple(pp[s, :n]), tuple(pp[s, n:2 * n]),
                                   pp[s, o]) not in made]
    assert len(written) >= B
    for pool in (pp, jp):
        for s in written:
            inside = feas & np.all((pts >= pool[s, :n] - 1e-9) &
                                   (pts <= pool[s, n:2 * n] + 1e-9), axis=1)
            if inside.any():
                assert pool[s, o] <= objs[inside].min() + tol, s
    # the device incumbent is a feasible point's value: not below the
    # optimum; the pool's bound with it covers the optimum
    for summ in (js, ps):
        assert summ[3] >= opt - tol
        assert min(summ[2], summ[3]) <= opt + tol


def test_selection_ties_pick_lower_slot():
    """approx_max_k of the JAX package on the CPU takes the lower index
    among equal values ([1, 2, 4, 0, 3] on [1, 3, 3, 0, 3]); so does
    select_slots (torch.topk gives [1, 4, 2, 0, 3])."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    cases = [np.array([1.0, 3.0, 3.0, 0.0, 3.0, -1.0, 0.0, 3.0]),
             np.repeat(rng.integers(0, 3, 16).astype(float), 4),
             np.concatenate([np.full(8, np.inf), [2.0, np.nan, 2.0]])]
    for prio in cases:
        k = 5
        _, jidx = jax.lax.approx_max_k(
            jnp.nan_to_num(jnp.asarray(prio, dtype=jnp.float32),
                           neginf=-3e38, posinf=3e38), k,
            recall_target=0.95)
        pidx = select_slots(-torch.as_tensor(prio), k)
        assert pidx.tolist() == np.asarray(jidx).tolist()
    assert select_slots(-torch.as_tensor(cases[0]), 5).tolist()[:3] == \
        [1, 2, 4]


def test_child_routing_at_exactly_two_b_free():
    """48 of 64 slots used (above half: the dive key), so the first
    round starts with exactly 2B free slots; the cutoff prunes lanes, so
    fewer valid children than free slots are routed.  No write goes out
    of range and the occupancy is the JAX package's."""
    jp, pp, js, ps, n, m = _one_call("cknap", C - 2 * B, -276.0, seed=5)
    o = 3 * n + m
    for col in (o + 6, o + 1, o + 2, o + 3):
        assert np.array_equal(jp[:, col], pp[:, col]), col
    assert ps[9] > 0                             # lanes were pruned
    assert js[8] == ps[8] and ps[8] < 2 * B * ps[0]
    assert ps[1] == (pp[:, o + 6] > 0.5).sum() <= C


def _env(dev, batch=8, cap=256, rounds=6, warm=2):
    return _set(Environment(), node_batch=batch, bnb_node_limit=20000,
                bnb_time_limit=300, log_level=1, device_tree=dev,
                device_rounds=rounds, device_pool_cap=cap,
                device_warm_batches=warm)


def test_device_pool_knapsack_matches_dp():
    p = G.correlated_knapsack(n=20, seed=3)
    opt = G.knapsack_dp_optimum(n=20, seed=3)
    bab = BranchAndBound(p, _env(1), device="cpu")
    assert bab._dev_pool_ok
    st = bab.solve()
    assert st == SolveStatus.SOLVED_OPTIMAL
    assert bab._dev_pool is not None and bab._dev_pool.processed > 0
    assert bab.ub == pytest.approx(opt, abs=1e-6)
    assert bab.lb == pytest.approx(opt, abs=1e-5)
    jenv = _set(JaxEnv(), node_batch=8, bnb_node_limit=20000,
                bnb_time_limit=300, log_level=1, device_tree=1,
                device_rounds=6, device_pool_cap=256, device_warm_batches=2)
    jb = JaxBnB(JG.correlated_knapsack(n=20, seed=3), jenv)
    assert jb.solve() == st and jb._dev_pool is not None
    assert abs(bab.ub - jb.ub) <= 1e-9 * (1 + abs(opt))


def test_device_pool_miqp_matches_host_loop():
    p = G.convex_miqp(n_cont=5, n_int=6, seed=1)
    vals = {}
    for dev in (0, 1):
        bab = BranchAndBound(p, _env(dev), device="cpu")
        assert bab.solve() == SolveStatus.SOLVED_OPTIMAL
        assert (bab._dev_pool is not None) == bool(dev)
        vals[dev] = bab.ub
    assert vals[0] == pytest.approx(vals[1], abs=1e-6)


def test_device_pool_congestion_spills_and_closes():
    # a pool cap far below the open-list peak forces drain/refill
    # cycles through the host tree; the optimum must be unaffected
    p = G.correlated_knapsack(n=30, seed=1)
    opt = G.knapsack_dp_optimum(n=30, seed=1)
    bab = BranchAndBound(p, _env(1, cap=32, rounds=8), device="cpu")
    st = bab.solve()
    assert st == SolveStatus.SOLVED_OPTIMAL
    assert bab.stats.rebalances >= 1
    assert bab.ub == pytest.approx(opt, abs=1e-6)
    assert len(bab.tm) == 0


def test_device_pool_gating():
    # nonlinear rows / aux columns / SOS make the in-device incumbent
    # test invalid; the runner must decline
    p = G.bilinear_pooling(n_pairs=3, seed=0)
    assert not BranchAndBound(p, _env(1), device="cpu")._dev_pool_ok
    p2 = G.correlated_knapsack(n=10, seed=0)
    assert not BranchAndBound(p2, _env(0), device="cpu")._dev_pool_ok
    bab = BranchAndBound(p2, _env(1), device="cpu")
    assert bab._dev_pool_ok
    # a pool that cannot hold C // 2 nodes plus one round's children
    with pytest.raises(ValueError, match="device_pool_cap"):
        DevicePoolRunner(bab, cap=4 * B - 1, batch=B, rounds=1)


def test_mbnb_cli_device_tree(tmp_path, capsys, monkeypatch):
    """`mbnb --device_tree 1` runs the pool from the command line."""
    from minotaur_tpu_torch.io.nl_writer import write_nl
    from minotaur_tpu_torch.solvers import mbnb
    runs = []
    run = DevicePoolRunner.run
    monkeypatch.setattr(DevicePoolRunner, "run",
                        lambda self, t0: runs.append(self) or run(self, t0))
    path = str(tmp_path / "cknap30.nl")
    write_nl(G.correlated_knapsack(30, 1), path)
    rc = mbnb.main([path, "--device_tree", "1", "--node_batch", "16",
                    "--device_pool_cap", "64", "--log_level", "3"],
                   device="cpu")
    text = capsys.readouterr().out
    assert rc == 0 and "status: SOLVED_OPTIMAL" in text
    best = [float(line.split()[2]) for line in text.splitlines()
            if line.startswith("best objective:")]
    dp = G.knapsack_dp_optimum(30, 1)
    assert best == [pytest.approx(dp, rel=1e-9)]
    assert runs and runs[0].processed > 0 and runs[0].C == 64
