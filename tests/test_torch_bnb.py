"""The port's branch-and-bound main path on the CPU.

`BranchAndBound(device="cpu")` must reach the exact oracle optimum of
cknap_30a (knapsack DP) and intquad(24) (greedy exchange) within 1e-6
relative, and on intquad(24) its incumbent must equal the JAX package's
within 1e-9 relative (both solve to the same optimum; only rounding in
the last digits may differ).  intquad(24) runs at the bench's IPM
settings (bench.py:78-95), which keep the CPU run short.
"""

import numpy as np
import pytest

from minotaur_tpu_torch.bnb.bnb import BranchAndBound
from minotaur_tpu_torch.models.convex_suite2 import intquad, intquad_optimum
from minotaur_tpu_torch.models.generators import (correlated_knapsack,
                                                  knapsack_dp_optimum)
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import SolveStatus

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small problems: intra-op threads only contend with the other test
    workers, so the port runs on one."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BENCH_IPM = dict(ipm_max_iters=28, ipm_tail_kkt_rounds=4,
                 ipm_refine_steps=0, ipm_chol_retry=0, node_batch=64)


def _env(**opts):
    env = Environment()
    env.set_option("log_level", 1)
    for k, v in opts.items():
        env.set_option(k, v)
    return env


@pytest.mark.parametrize("name", ["cknap_30a", "intquad_24"])
def test_bnb_hits_oracle(name):
    if name == "cknap_30a":
        prob, opt, env = correlated_knapsack(30, 1), \
            knapsack_dp_optimum(30, 1), _env()
    else:
        prob, opt, env = intquad(24, 4, 0), intquad_optimum(24, 4, 0), \
            _env(**BENCH_IPM)
    bab = BranchAndBound(prob, env, device="cpu")
    assert bab.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(bab.ub - opt) <= 1e-6 * (1 + abs(opt))
    assert bab.lb == bab.ub
    assert bab.stats.nodes_processed > 1 and bab.stats.ipm_iters > 0
    x = bab.best_x
    assert prob.is_feasible(x, atol=1e-6)
    assert abs(prob.eval_objective(x) - bab.ub) <= 1e-9 * (1 + abs(opt))


def test_bnb_ub_matches_jax():
    from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
    from minotaur_tpu.models.convex_suite2 import intquad as jax_intquad
    from minotaur_tpu.utils.environment import Environment as JaxEnv
    jenv = JaxEnv()
    jenv.set_option("log_level", 1)
    for k, v in BENCH_IPM.items():
        jenv.set_option(k, v)
    jb = JaxBnB(jax_intquad(24, 4, 0), jenv)
    jb.solve()
    pb = BranchAndBound(intquad(24, 4, 0), _env(**BENCH_IPM), device="cpu")
    pb.solve()
    assert abs(pb.ub - jb.ub) <= 1e-9 * (1 + abs(jb.ub))
    assert pb.status == jb.status


def test_bound_counts_the_batch_in_flight():
    """The pipelined loop's global bound counts the nodes of the batch
    dispatched but not yet finished.  Without them (the JAX loop) the
    sweep row clay2_3a, a convex MIQP, stops SOLVED_OPTIMAL at 7.5048
    with 18 open nodes whose bound is 0 (oracle 0.6337, SLSQP over every
    disjunct); with them it reaches the oracle within 1e-6 relative with
    an empty tree."""
    from minotaur_tpu_torch.models.convex_suite import SUITE
    gen, oracle, _ = SUITE["clay2_3a"]
    opt = oracle()
    bab = BranchAndBound(gen(), _env(node_batch=16, pad_full=1),
                         device="cpu")
    assert bab.solve() == SolveStatus.SOLVED_OPTIMAL
    tol = 1e-6 * (1 + abs(opt))
    assert abs(bab.ub - opt) <= tol and bab.lb <= opt + tol
    assert len(bab.tm) == 0


@pytest.mark.parametrize("opt,val", [("divheur", 1), ("obbt", 1),
                                     ("brancher", "weak"), ("nodeproc", "qpd"),
                                     ("dtype", "f32"), ("persp_ref", 1),
                                     ("msheur", 1),
                                     ("checkpoint_file", "ckpt.bin"),
                                     ("device_tree", 1)])
def test_ported_option_matches_jax(opt, val, tmp_path):
    """The options that raised before they were ported: each is accepted
    and gives the JAX driver's status and ub (1e-9 relative) and node
    count on correlated_knapsack(6, 0) at node_batch 4, pad_full 1.
    `device_tree` hands the search to the device pool after one host
    superstep (pool of 64 slots, 3 rounds a call).
    (tests/test_torch_bnb_options.py, test_torch_native.py,
    test_torch_qpd.py and test_torch_device_pool.py hold each one on a
    model where it acts.)"""
    from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
    from minotaur_tpu.models.generators import correlated_knapsack as jck
    from minotaur_tpu.utils.environment import Environment as JaxEnv
    if opt == "checkpoint_file":
        val = str(tmp_path / val)
    # one padded bucket of 4 lanes: the JAX driver compiles its step once
    opts = dict(node_batch=4, pad_full=1)
    if opt == "device_tree":
        opts.update(device_warm_batches=1, device_pool_cap=64,
                    device_rounds=3)
    pb = BranchAndBound(correlated_knapsack(6, 0),
                        _env(**opts, **{opt: val}), device="cpu")
    jenv = JaxEnv()
    for k, v in dict(log_level=1, **opts).items():
        jenv.set_option(k, v)
    jenv.set_option(opt, val if opt != "checkpoint_file"
                    else str(tmp_path / "jax.bin"))
    jb = JaxBnB(jck(6, 0), jenv)
    assert pb.solve() == jb.solve() == SolveStatus.SOLVED_OPTIMAL
    opt_v = knapsack_dp_optimum(6, 0)
    assert abs(pb.ub - opt_v) <= 1e-6 * (1 + abs(opt_v))
    assert abs(pb.ub - jb.ub) <= 1e-9 * (1 + abs(opt_v))
    assert pb.stats.nodes_processed == jb.stats.nodes_processed
    if opt == "device_tree":
        assert pb._dev_pool is not None and jb._dev_pool is not None


def test_nonlinear_rows_raise():
    """Nonlinear rows are ported (tests/test_torch_bnb_nl.py), and so are
    the QPD node processor and the perspective reformulation on them:
    both are accepted and reach the default run's optimum (the JAX parity
    of each is in tests/test_torch_qpd.py and tests/test_torch_persp.py).
    `device_tree` declines them (the in-device incumbent test covers
    linear rows only): the host loop solves to the same optimum."""
    from minotaur_tpu_torch.ir.functions import Function, QuadraticFunction
    p = correlated_knapsack(4, 0)
    p.new_constraint(Function(qf=QuadraticFunction({(0, 0): 1.0})),
                     -np.inf, 1.0, "quad")
    base = BranchAndBound(p, _env(), device="cpu")
    assert len(base.sp.nl_rows) == 1
    assert base.solve() == SolveStatus.SOLVED_OPTIMAL
    for opt, val in (("nodeproc", "qpd"), ("persp_ref", 1)):
        bab = BranchAndBound(p, _env(**{opt: val}), device="cpu")
        assert (bab._qpd_step is not None) == (opt == "nodeproc")
        assert bab.solve() == SolveStatus.SOLVED_OPTIMAL
        assert abs(bab.ub - base.ub) <= 1e-6 * (1 + abs(base.ub))
    bab = BranchAndBound(p, _env(device_tree=1), device="cpu")
    assert not bab._dev_pool_ok
    assert bab.solve() == SolveStatus.SOLVED_OPTIMAL
    assert bab._dev_pool is None
    assert abs(bab.ub - base.ub) <= 1e-6 * (1 + abs(base.ub))


