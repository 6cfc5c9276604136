"""The port's C++ node store (native/, bnb/tree.py::NativeTreeManager) and
checkpoint/resume (bnb/checkpoint.py) against the JAX package, on the CPU.

- The store: slab round trip and batch push (as
  tests/test_native_checkpoint.py runs them on the JAX package's store);
  the native tree pops the same node ids in the same order as the Python
  heap; a source that does not compile raises with g++'s message.
- The driver: `native_tree` is the default and gives the native store;
  the solve under it equals the Python heap's (same ub, same nodes), and
  equals the JAX driver's (same ub within 1e-9 relative, same node count:
  cknap_30a under `dtype f64`, where both packages run the same float64
  arithmetic).
- Checkpoints: a save/load round trip restores the open nodes, the
  incumbent and the bounds exactly; a run checkpointed at a node cap and
  resumed ends at the same ub and status as an uninterrupted run; a
  checkpoint written by the JAX driver is resumed by the port to the same
  optimum; QG's cut pool round-trips.
"""

import os

import numpy as np
import pytest
import torch

from minotaur_tpu_torch import native
from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.bnb.checkpoint import load_checkpoint, save_checkpoint
from minotaur_tpu_torch.bnb.node import Node
from minotaur_tpu_torch.bnb.tree import NativeTreeManager, TreeManager
from minotaur_tpu_torch.models.generators import (correlated_knapsack,
                                                  knapsack_dp_optimum)
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import SolveStatus, TreeSearchOrder


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env(cls=Environment, **opts):
    env = cls()
    env.set_option("log_level", 1)
    for k, v in opts.items():
        env.set_option(k, v)
    return env


def _scal(nid, depth, lb, bvar=-1, has_x=0, has_y=0):
    s = np.zeros(native.N_SCALARS)
    s[native.SCAL_NID] = nid
    s[native.SCAL_DEPTH] = depth
    s[native.SCAL_LB] = lb
    s[native.SCAL_BVAR] = bvar
    s[native.SCAL_HAS_X] = has_x
    s[native.SCAL_HAS_Y] = has_y
    return s


def test_native_store_roundtrip():
    ts = native.NativeTreeStore(3, m=2, order=2)
    for k in range(10):
        ts.push(_scal(k, k % 3, float(10 - k), bvar=k % 2, has_x=1, has_y=1),
                np.full(3, -k), np.full(3, k), np.arange(3.0) * k,
                np.full(2, 0.5 * k))
    assert len(ts) == 10
    assert ts.best_lb() == pytest.approx(1.0)
    got, pruned, scal, vlb, vub, wx, wy = ts.pop_batch(4)
    assert got == 4
    np.testing.assert_allclose(scal[:, native.SCAL_LB], [1.0, 2.0, 3.0, 4.0])
    np.testing.assert_allclose(vub[0], 9.0)
    np.testing.assert_allclose(wy[0], 4.5)
    assert ts.prune(8.5) == 2
    got, pruned, *_ = ts.pop_batch(10, cutoff=7.5)
    assert got == 3 and pruned == 1
    # batch push
    n, k = 5, 7
    ts = native.NativeTreeStore(n, m=1)
    ts.push_batch(np.stack([_scal(i, 0, float(k - 1 - i)) for i in range(k)]),
                  np.tile(np.arange(n, dtype=float), (k, 1)),
                  np.full((k, n), 9.0), np.zeros((k, n)), np.zeros((k, 1)))
    got, _, _, vlb, *_rest = ts.pop_batch(k)
    assert got == k
    np.testing.assert_allclose(vlb[0], np.arange(n))


@pytest.mark.parametrize("order", list(TreeSearchOrder))
def test_native_tree_pops_like_the_heap(order):
    """Same seeded nodes into both stores (ties in lb and depth included),
    interleaved pops, branches and prunes: the same node ids come out in
    the same order."""
    rng = np.random.default_rng(5)
    n, m = 4, 2
    py = TreeManager(order)
    nt = NativeTreeManager(order, n=n, m=m)
    seq = [[], []]
    nid = 0
    for tm, out in ((py, seq[0]), (nt, seq[1])):
        rng = np.random.default_rng(5)
        nid = 0
        tm.insert_root(Node(nid=0, depth=0, lb=-np.inf, vlb=np.zeros(n),
                            vub=np.ones(n)))
        nid = 1
        for step in range(12):
            if step == 8:
                tm.set_cutoff(2.5)
                tm.prune_by_cutoff()
            batch = tm.pop_batch(3)
            out.append([nd.nid for nd in batch])
            for nd in batch:
                lbs = np.round(rng.uniform(0, 4, size=2), 1)
                kids = [Node(nid=nid + i, depth=nd.depth + 1, lb=float(lbs[i]),
                             vlb=np.zeros(n), vub=np.ones(n),
                             warm_x=rng.normal(size=n),
                             warm_y=rng.normal(size=m)) for i in range(2)]
                nid += 2
                tm.branch(kids, nd)
        out.append(sorted(nd.nid for nd in tm.iter_nodes()))
        out.append(round(tm.best_lb(), 12))
    assert seq[0] == seq[1]
    assert py.nodes_processed == nt.nodes_processed
    assert py.nodes_pruned == nt.nodes_pruned


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "treestore.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.NativeTreeStore(3)


def test_default_store_is_native_and_matches_heap():
    prob = lambda: correlated_knapsack(30, 1)  # noqa: E731
    bab = BranchAndBound(prob(), _env(), device="cpu")
    assert isinstance(bab.tm, NativeTreeManager)
    bab.solve()
    heap = BranchAndBound(prob(), _env(native_tree=0), device="cpu")
    assert type(heap.tm) is TreeManager
    heap.solve()
    assert bab.status == heap.status == SolveStatus.SOLVED_OPTIMAL
    assert bab.ub == heap.ub
    assert bab.stats.nodes_processed == heap.stats.nodes_processed
    assert abs(bab.ub - knapsack_dp_optimum(30, 1)) <= 1e-9 * 753


def test_native_solve_matches_jax():
    from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
    from minotaur_tpu.bnb.tree import NativeTreeManager as JaxNative
    from minotaur_tpu.models.generators import correlated_knapsack as jck
    from minotaur_tpu.utils.environment import Environment as JEnv
    jb = JaxBnB(jck(30, 1), _env(JEnv, dtype="f64", native_tree=1))
    assert isinstance(jb.tm, JaxNative)
    jb.solve()
    pb = BranchAndBound(correlated_knapsack(30, 1),
                        _env(dtype="f64", native_tree=1), device="cpu")
    pb.solve()
    assert pb.status == jb.status == SolveStatus.SOLVED_OPTIMAL
    assert abs(pb.ub - jb.ub) <= 1e-9 * (1 + abs(jb.ub))
    assert pb.stats.nodes_processed == jb.stats.nodes_processed


def _capped(path, cap, **opts):
    return BranchAndBound(correlated_knapsack(30, 1), _env(
        checkpoint_file=str(path), checkpoint_interval=0.0,
        bnb_node_limit=cap, **opts), device="cpu")


def test_checkpoint_roundtrip(tmp_path):
    ck = tmp_path / "state.npz"
    bab = _capped(ck, 64)
    assert bab.solve() == SolveStatus.SOLVED_NODE_LIMIT
    want = sorted((nd.nid, nd.lb, tuple(nd.vlb), tuple(nd.vub))
                  for nd in bab.tm.iter_nodes())
    assert want
    save_checkpoint(str(ck), bab)
    fresh = BranchAndBound(correlated_knapsack(30, 1), _env(), device="cpu")
    load_checkpoint(str(ck), fresh)
    got = sorted((nd.nid, nd.lb, tuple(nd.vlb), tuple(nd.vub))
                 for nd in fresh.tm.iter_nodes())
    assert got == want
    assert (fresh.ub, fresh.lb, fresh.unresolved_lb) == \
        (bab.ub, bab.lb, bab.unresolved_lb)
    np.testing.assert_array_equal(fresh.best_x, bab.best_x)


def test_resume_equals_uninterrupted(tmp_path):
    full = BranchAndBound(correlated_knapsack(30, 1), _env(), device="cpu")
    full.solve()
    ck = tmp_path / "state.npz"
    first = _capped(ck, 64)
    first.solve()
    assert os.path.exists(ck) and first.ub > full.ub - 1e-9
    resumed = BranchAndBound(correlated_knapsack(30, 1), _env(
        checkpoint_file=str(ck), resume=1), device="cpu")
    assert resumed.solve() == full.status == SolveStatus.SOLVED_OPTIMAL
    assert resumed.ub == pytest.approx(full.ub, rel=1e-12)
    assert resumed.lb >= first.lb - 1e-9


def test_port_resumes_a_jax_checkpoint(tmp_path):
    from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
    from minotaur_tpu.models.generators import correlated_knapsack as jck
    from minotaur_tpu.utils.environment import Environment as JEnv
    ck = tmp_path / "jax.npz"
    jb = JaxBnB(jck(30, 1), _env(JEnv, checkpoint_file=str(ck),
                                 checkpoint_interval=0.0, bnb_node_limit=64))
    jb.solve()
    with np.load(ck) as data:
        n_open = data["vlb"].shape[0]
    assert n_open > 0
    pb = BranchAndBound(correlated_knapsack(30, 1), _env(
        checkpoint_file=str(ck), resume=1), device="cpu")
    assert pb.solve() == SolveStatus.SOLVED_OPTIMAL
    opt = knapsack_dp_optimum(30, 1)
    assert abs(pb.ub - opt) <= 1e-6 * (1 + abs(opt))
    assert pb.lb >= jb.lb - 1e-9


def test_checkpoint_qg_cut_pool(tmp_path):
    from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
    from minotaur_tpu_torch.models.convex_suite import SUITE
    gen = SUITE["st_e14a"][0]
    opts = dict(node_batch=4, qg_max_cuts=64)
    bab = QGBranchAndBound(gen(), _env(bnb_node_limit=2, **opts),
                           device="cpu")
    bab.solve()
    assert bab.n_cuts > 0
    ck = str(tmp_path / "qg.npz")
    save_checkpoint(ck, bab)
    bab2 = QGBranchAndBound(gen(), _env(**opts), device="cpu")
    load_checkpoint(ck, bab2)
    assert bab2.n_cuts == bab.n_cuts
    np.testing.assert_array_equal(
        bab2.mA[bab2._cut_base:bab2._cut_base + bab2.n_cuts],
        bab.mA[bab._cut_base:bab._cut_base + bab.n_cuts])
