"""The port's global solver (`GlobBranchAndBound`, `mglob`) on the CPU.

- Full solves reach their oracles: the bilinear and concave-square
  models of tests/test_glob.py (-4 both), `bilinear_pooling(2, 2)`
  (the sum over pairs of -c (cap/2)^2), `quadratic_knapsack(8, seed=3)`
  (2^8 enumeration) and the Haverly pool of examples/water_network.py
  rebuilt in the port's IR (profit 400).  The port's ub equals the JAX
  driver's within 1e-6 (1 + |opt|) and its lb lies below the oracle;
  both end SOLVED_OPTIMAL.  The glob driver always runs the IPM's mixed
  policy (f32 factors: its IPMOptions take only max_iters and tol from
  the options; the JAX package's take use_pallas too), and the two
  packages' f32 factors round differently (tests/test_torch_ipm.py), so
  the lanes' relaxation values differ in the last digits and the node
  counts may differ by a few nodes (pool: 175 against 177); they are
  not compared.  The JAX runs of qknap(8) and the pooling model take
  about 30 s each here, mostly compilation, and are marked slow; the
  port's runs of those two are held to the oracle in the fast set.
- Root OBBT (`obbt 1`) on the Haverly pool stays sound and tightens.
- `mglob` on files written by the port's nl_writer: a nonconvex model is
  solved to its oracle and writes its .sol; a convex quadratic model is
  forwarded to QG; a model the transformer rejects (FLOOR) goes to
  `mbnb`.
"""

import itertools

import numpy as np
import pytest
import torch

import minotaur_tpu.ir.functions as jfun
import minotaur_tpu.ir.problem as jprob
import minotaur_tpu.models.generators as jgen
import minotaur_tpu.utils.types as jtypes
import minotaur_tpu_torch.ir.functions as tfun
import minotaur_tpu_torch.ir.problem as tprob
import minotaur_tpu_torch.models.generators as tgen
import minotaur_tpu_torch.utils.types as ttypes
from minotaur_tpu.glob.glob_bnb import GlobBranchAndBound as JaxGlob
from minotaur_tpu.utils.environment import Environment as JEnv
from minotaur_tpu_torch.glob.glob_bnb import GlobBranchAndBound
from minotaur_tpu_torch.io.nl_writer import write_nl
from minotaur_tpu_torch.ir.expr import ExprGraph
from minotaur_tpu_torch.ops.opcodes import Op
from minotaur_tpu_torch.solvers import mglob
from minotaur_tpu_torch.utils.environment import Environment
from minotaur_tpu_torch.utils.types import SolveStatus, VarType

INF = float("inf")
JAX = (jprob, jfun, jtypes, jgen)
PORT = (tprob, tfun, ttypes, tgen)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bilin(pkg):
    """min -x*y s.t. x + y <= 4, x, y in [0, 4]: -4 at (2, 2)."""
    P, F, _, _ = pkg
    p = P.Problem("bilin")
    p.new_variable(0, 4)
    p.new_variable(0, 4)
    p.new_constraint(F.Function(lf=F.LinearFunction({0: 1.0, 1: 1.0})),
                     -INF, 4.0)
    qf = F.QuadraticFunction()
    qf.add_term(0, 1, -1.0)
    p.new_objective(F.Function(qf=qf))
    return p


def _concave(pkg):
    """min -(x-1)^2 over [0, 3]: -4 at x = 3."""
    P, F, _, _ = pkg
    p = P.Problem("concave")
    p.new_variable(0, 3)
    qf = F.QuadraticFunction()
    qf.add_term(0, 0, -1.0)
    p.new_objective(F.Function(lf=F.LinearFunction({0: 2.0}), qf=qf),
                    const=-1.0)
    return p


def _haverly(pkg):
    """examples/water_network.py's Haverly pooling problem (profit 400)."""
    P, F, _, _ = pkg
    p = P.Problem("haverly")
    for _ in range(4):
        p.new_variable(0.0, 300.0)      # a, b, px, py
    p.new_variable(0.0, 100.0)          # zx
    p.new_variable(0.0, 200.0)          # zy
    p.new_variable(1.0, 3.0)            # q, pool sulfur %
    p.new_objective(F.Function(lf=F.LinearFunction(
        {0: 6.0, 1: 16.0, 2: -9.0, 3: -15.0, 4: 1.0, 5: -5.0})))
    p.new_constraint(F.Function(lf=F.LinearFunction(
        {0: 1.0, 1: 1.0, 2: -1.0, 3: -1.0})), 0.0, 0.0)
    qf = F.QuadraticFunction()
    qf.add_term(6, 2, -1.0)
    qf.add_term(6, 3, -1.0)
    p.new_constraint(F.Function(lf=F.LinearFunction({0: 3.0, 1: 1.0}),
                                qf=qf), 0.0, 0.0)
    qf = F.QuadraticFunction()
    qf.add_term(6, 2, 1.0)
    p.new_constraint(F.Function(lf=F.LinearFunction({2: -2.5, 4: -0.5}),
                                qf=qf), -INF, 0.0)
    qf = F.QuadraticFunction()
    qf.add_term(6, 3, 1.0)
    p.new_constraint(F.Function(lf=F.LinearFunction({3: -1.5, 5: 0.5}),
                                qf=qf), -INF, 0.0)
    p.new_constraint(F.Function(lf=F.LinearFunction({2: 1.0, 4: 1.0})),
                     -INF, 100.0)
    p.new_constraint(F.Function(lf=F.LinearFunction({3: 1.0, 5: 1.0})),
                     -INF, 200.0)
    return p


def _pool(pkg):
    return pkg[3].bilinear_pooling(2, 2)


def _qknap(pkg):
    return pkg[3].quadratic_knapsack(8, seed=3)


def _pool_oracle():
    """max x*y on x + y <= cap in [0, 4]^2 is (cap/2)^2 (cap <= 5)."""
    p = _pool(PORT)
    c = [-v for v in p.obj.fun.qf.terms.values()]
    caps = [con.ub for con in p.cons]
    return -sum(ci * (cap / 2) ** 2 for ci, cap in zip(c, caps))


def _enum_oracle(p):
    best = INF
    for bits in itertools.product((0.0, 1.0), repeat=p.n_vars):
        x = np.array(bits)
        if p.is_feasible(x, atol=1e-9, int_tol=1e-9):
            best = min(best, float(p.eval_objective(x)))
    return best


CASES = {"bilin": (_bilin, lambda: -4.0), "concave": (_concave, lambda: -4.0),
         "pool": (_pool, _pool_oracle),
         "qknap": (_qknap, lambda: _enum_oracle(_qknap(PORT))),
         "haverly": (_haverly, lambda: -400.0)}


def _env(cls, **opts):
    env = cls()
    for k, v in {**dict(node_batch=16, bnb_node_limit=3000,
                        bnb_time_limit=120, log_level=1), **opts}.items():
        env.set_option(k, v)
    return env


@pytest.fixture(scope="module")
def port_runs():
    out = {}
    for name, (build, _) in CASES.items():
        bab = GlobBranchAndBound(build(PORT), _env(Environment), device="cpu")
        out[name] = (bab.solve(), bab)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_reaches_oracle(name, port_runs):
    st, bab = port_runs[name]
    opt = CASES[name][1]()
    tol = 1e-6 * (1 + abs(opt))
    assert st == SolveStatus.SOLVED_OPTIMAL
    assert abs(bab.ub - opt) <= tol and bab.lb <= opt + tol
    assert bab.problem.is_feasible(bab.best_x, atol=1e-5, int_tol=1e-6)


@pytest.mark.parametrize("name", [
    "bilin", "concave", "haverly",
    pytest.param("pool", marks=pytest.mark.slow),
    pytest.param("qknap", marks=pytest.mark.slow)])
def test_port_matches_jax_driver(name, port_runs):
    st, bab = port_runs[name]
    jb = JaxGlob(CASES[name][0](JAX), _env(JEnv))
    assert jb.solve() == st
    opt = CASES[name][1]()
    assert abs(bab.ub - jb.ub) <= 1e-6 * (1 + abs(opt))


def test_root_obbt_sound_and_tightens(port_runs):
    """`obbt 1` tightens the Haverly root box, keeps the optimum found
    without it inside, and the search still reaches profit 400."""
    bab = GlobBranchAndBound(_haverly(PORT), _env(Environment, obbt=1),
                             device="cpu")
    lo, hi = bab._root_obbt(bab.gs.vlb.copy(), bab.gs.vub.copy())
    assert np.all(lo >= bab.gs.vlb) and np.all(hi <= bab.gs.vub)
    assert np.sum(lo > bab.gs.vlb + 1e-7) + np.sum(hi < bab.gs.vub - 1e-7) > 0
    x = port_runs["haverly"][1].best_x
    n = len(x)
    assert np.all(lo[:n] <= x + 1e-6) and np.all(x <= hi[:n] + 1e-6)
    assert bab.solve() == SolveStatus.SOLVED_OPTIMAL
    assert abs(bab.ub + 400.0) <= 1e-6 * 401


# ------------------------------------------------------------------- CLI
def _convex_miqp():
    """min x^2 + y^2 s.t. x + y >= 3.7, y integer: 6.89."""
    p = tprob.Problem("convminlp")
    p.new_variable(0, 10)
    p.new_variable(0, 10, VarType.INTEGER)
    p.new_constraint(tfun.Function(lf=tfun.LinearFunction({0: 1.0, 1: 1.0})),
                     3.7, INF)
    qo = tfun.QuadraticFunction()
    qo.add_term(0, 0, 1.0)
    qo.add_term(1, 1, 1.0)
    p.new_objective(tfun.Function(qf=qo))
    return p


def _floor_model():
    """min (x0 - 1.2)^2 + floor(2.5) x1 - 3 x1, x1 integer in [0, 2]:
    -2; FLOOR is outside the factorable transformer."""
    p = tprob.Problem("kink")
    p.new_variable(0, 3)
    p.new_variable(0, 2, VarType.INTEGER)
    g = ExprGraph()
    g.set_root(g.node(Op.PLUS, g.node(Op.SQR, g.node(
        Op.MINUS, g.var(0), g.num(1.2))), g.node(
        Op.MULT, g.node(Op.FLOOR, g.num(2.5)), g.var(1))))
    p.new_objective(tfun.Function(lf=tfun.LinearFunction({1: -3.0}), nlf=g))
    return p


@pytest.mark.parametrize("name,build,opt,says", [
    ("qknap8", lambda: _qknap(PORT), None, "nodes:"),
    ("convminlp", _convex_miqp, 6.89, "forwarding to QG"),
    ("kink", _floor_model, -2.0, "forwarding to mbnb")])
def test_mglob_cli(name, build, opt, says, tmp_path, monkeypatch, capsys):
    path = tmp_path / f"{name}.nl"
    write_nl(build(), str(path))
    monkeypatch.chdir(tmp_path)
    argv = [str(path), "--write_sol_file", "1", "--node_batch", "16"]
    assert mglob.main(argv, device="cpu") == 0
    if opt is None:
        opt = _enum_oracle(build())
    out = capsys.readouterr().out
    objs = [float(line.rsplit(" ", 1)[1]) for line in out.splitlines()
            if "best objective:" in line]
    assert len(objs) == 1 and abs(objs[0] - opt) <= 1e-6 * (1 + abs(opt)), out
    assert says in out
    head = (tmp_path / f"{name}.sol").read_text().splitlines()[0]
    assert head.startswith("mglob: SOLVED_OPTIMAL, objective ")
