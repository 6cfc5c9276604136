"""The port's QG/OA solver entry points and the OA driver, on the CPU.

- The CLIs `mqg`, `moa`, `mlstoa`, `mqgpar`, `msbnb` and `mmultistart`,
  each run as `main([file, "--write_sol_file", "1"], device="cpu")` on
  st_e14a written by the port's nl_writer: exit 0, print one
  "best objective:" line at the suite oracle (within
  1e-6 * (1 + |opt|)) and write `<name>.sol` with the JAX driver's
  status (SOLVED_OPTIMAL; SOLVED_GAP_LIMIT for moa, see STATUS).
- The convex MIQP of tests/test_oa.py (min x^2 + y^2, x + y >= 3.7, y
  integer; optimum 6.89): `QGBranchAndBound` and `OABranchAndBound`
  reach the optimum and the JAX drivers' ubs within 1e-6 * (1 + |opt|).
- OA's major iterations equal the JAX driver's under `dtype f64` at
  tests/test_oa.py's settings (node_batch 8, no padding).  The first
  master MILP is degenerate (every y in 0..3 gives eta = 6.845 at the
  first cut), so which tie it returns, and with it the number of major
  iterations, follows the rounding of the master LP's IPM.  Under the
  default mixed policy the f32 factors round differently in the two
  packages (tests/test_torch_ipm.py) and the counts differ (port 4, JAX
  5).  Under f64 factors the two IPMs agree on the first master LP to
  1e-9 for five iterations, then stall at a KKT error of 2.7e-7 and
  wander apart along the optimal face; at node_batch 16 with padding
  the counts differ too (4 and 5).
"""

import numpy as np
import pytest
import torch

import minotaur_tpu.ir.functions as jfun
import minotaur_tpu.ir.problem as jprob
import minotaur_tpu.utils.types as jtypes
import minotaur_tpu_torch.ir.functions as tfun
import minotaur_tpu_torch.ir.problem as tprob
import minotaur_tpu_torch.utils.types as ttypes
from minotaur_tpu.bnb.oa import OABranchAndBound as JaxOA
from minotaur_tpu.bnb.qg import QGBranchAndBound as JaxQG
from minotaur_tpu.utils.environment import Environment as JEnv
from minotaur_tpu_torch.bnb.oa import OABranchAndBound
from minotaur_tpu_torch.bnb.qg import QGBranchAndBound
from minotaur_tpu_torch.io.nl_writer import write_nl
from minotaur_tpu_torch.models.convex_suite import SUITE
from minotaur_tpu_torch.solvers import (mlstoa, mmultistart, moa, mqg,
                                        mqgpar, msbnb)
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import SolveStatus


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These problems have at most a few dozen variables: intra-op threads
    only contend with the other test workers, so the port runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CLIS = {"mqg": mqg, "moa": moa, "mlstoa": mlstoa, "mqgpar": mqgpar,
        "msbnb": msbnb, "mmultistart": mmultistart}

# OA on st_e14a stops after two major iterations when the second fix-int
# NLP adds no new cut, with lb 5e-11 below ub: SOLVED_GAP_LIMIT, in the
# JAX package's driver as in the port (same OAStats in both)
STATUS = {"moa": "SOLVED_GAP_LIMIT"}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_solves_st_e14a(name, tmp_path, monkeypatch, capsys):
    gen, oracle, _ = SUITE["st_e14a"]
    path = tmp_path / "st_e14a.nl"
    write_nl(gen(), str(path))
    monkeypatch.chdir(tmp_path)
    argv = [str(path), "--write_sol_file", "1", "--node_batch", "16"]
    if name == "mqgpar":
        argv += ["--threads", "4"]
    assert CLIS[name].main(argv, device="cpu") == 0
    opt = oracle()
    out = capsys.readouterr().out
    objs = [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
            if "best objective:" in line]
    assert len(objs) == 1 and abs(objs[0] - opt) <= 1e-6 * (1 + abs(opt)), out
    head = (tmp_path / "st_e14a.sol").read_text().splitlines()[0]
    assert head.startswith(f"{name}: {STATUS.get(name, 'SOLVED_OPTIMAL')}, "
                           f"objective ")


def _miqp(pkg):
    P, F, T = pkg
    p = P.Problem("convminlp")
    p.new_variable(0, 10)
    p.new_variable(0, 10, T.VarType.INTEGER)
    p.new_constraint(F.Function(lf=F.LinearFunction({0: 1.0, 1: 1.0})),
                     3.7, np.inf)
    qo = F.QuadraticFunction()
    qo.add_term(0, 0, 1.0)
    qo.add_term(1, 1, 1.0)
    p.new_objective(F.Function(qf=qo))
    return p


JAX = (jprob, jfun, jtypes)
PORT = (tprob, tfun, ttypes)


def _env(cls, **opts):
    env = cls()
    for k, v in {**dict(log_level=1, node_batch=16, pad_full=1),
                 **opts}.items():
        env.set_option(k, v)
    return env


@pytest.mark.parametrize("cls,jcls,opts", [
    (QGBranchAndBound, JaxQG, {}),
    (OABranchAndBound, None, {}),
    # tests/test_oa.py's settings (node_batch 8, no padding), f64 factors
    (OABranchAndBound, JaxOA, {"dtype": "f64", "node_batch": 8,
                               "pad_full": 0}),
])
def test_convex_miqp_matches_jax(cls, jcls, opts):
    """QG at the default options and OA under dtype f64 against the JAX
    drivers; OA at the default options against the optimum only (its JAX
    run would take another 15 s here)."""
    tb = cls(_miqp(PORT), _env(Environment, **opts), device="cpu")
    assert tb.solve() == SolveStatus.SOLVED_OPTIMAL
    tol = 1e-6 * (1 + 6.89)
    assert abs(tb.ub - 6.89) <= tol
    assert tb.best_x[1] == pytest.approx(2.0)
    if cls is OABranchAndBound:
        assert 1 <= tb.oa_stats.major_iters <= 10
    if jcls is None:
        return
    jb = jcls(_miqp(JAX), _env(JEnv, **opts))
    assert jb.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(tb.ub - jb.ub) <= tol
    if cls is OABranchAndBound:
        assert tb.oa_stats.major_iters == jb.oa_stats.major_iters
