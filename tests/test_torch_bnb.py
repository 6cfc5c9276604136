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


@pytest.mark.parametrize("opt,val", [("divheur", 1), ("obbt", 1),
                                     ("device_tree", 1), ("brancher", "weak"),
                                     ("nodeproc", "qpd"), ("dtype", "f32"),
                                     ("persp_ref", 1), ("msheur", 1),
                                     ("checkpoint_file", "ckpt.bin")])
def test_out_of_slice_options_raise(opt, val):
    with pytest.raises(NotImplementedError, match="not yet ported"):
        BranchAndBound(correlated_knapsack(6, 0), _env(**{opt: val}),
                       device="cpu")


def test_nonlinear_rows_raise():
    """Nonlinear rows are ported (tests/test_torch_bnb_nl.py); what still
    raises on them is the QPD node processor and the perspective
    reformulation."""
    from minotaur_tpu_torch.ir.functions import Function, QuadraticFunction
    p = correlated_knapsack(4, 0)
    p.new_constraint(Function(qf=QuadraticFunction({(0, 0): 1.0})),
                     -np.inf, 1.0, "quad")
    assert len(BranchAndBound(p, _env(), device="cpu").sp.nl_rows) == 1
    for opt, val in (("nodeproc", "qpd"), ("persp_ref", 1)):
        with pytest.raises(NotImplementedError, match="not yet ported"):
            BranchAndBound(p, _env(**{opt: val}), device="cpu")
