"""The port's `mbnb` entry point and its readers, on the CPU.

- The readers: `.nl` files written by the JAX package's `nl_writer` from
  suite rows, and the inline MPS text of tests/test_io_solvers.py, parse
  into `Problem`s equal field by field in both packages (variables,
  constraint bodies — linear terms, quadratic terms, expression tables —
  bounds, names, objective).
- The CLI: `mbnb.main([file, "--write_sol_file", "1"], device="cpu")`
  exits 0, writes `<name>.sol` into the working directory, and reaches
  the suite oracle; on batchdes_a (.nl) and the MPS sample the JAX
  package's `mbnb` runs on the same file and both .sol files hold the
  same point (1e-6) and status line.
"""

import os

import numpy as np
import pytest

from minotaur_tpu.io.mps_reader import read_mps as jax_read_mps
from minotaur_tpu.io.nl_reader import read_nl as jax_read_nl
from minotaur_tpu.io.nl_writer import write_nl as jax_write_nl
from minotaur_tpu.models.convex_suite import SUITE as JSUITE
from minotaur_tpu_torch.io.mps_reader import read_mps
from minotaur_tpu_torch.io.nl_reader import read_nl
from minotaur_tpu_torch.models.convex_suite import SUITE
from minotaur_tpu_torch.solvers import mbnb
from test_io_solvers import MPS_SAMPLE


def _fun_equal(a, b):
    for part in ("lf", "qf"):
        ta = getattr(a, part).terms if getattr(a, part) is not None else {}
        tb = getattr(b, part).terms if getattr(b, part) is not None else {}
        assert ta == tb, part
    ga, gb = a.nlf, b.nlf
    assert (ga is None or ga.root < 0) == (gb is None or gb.root < 0)
    if ga is not None and ga.root >= 0:
        assert ga.root == gb.root
        for ta, tb in zip(ga.tables, gb.tables):
            np.testing.assert_array_equal(ta, tb)


def _problems_equal(p, j):
    assert (p.name, p.n_vars, p.n_cons) == (j.name, j.n_vars, j.n_cons)
    for vp, vj in zip(p.vars, j.vars):
        assert (vp.lb, vp.ub, int(vp.vtype), vp.name) == \
            (vj.lb, vj.ub, int(vj.vtype), vj.name)
    for cp, cj in zip(p.cons, j.cons):
        assert (cp.lb, cp.ub, cp.name) == (cj.lb, cj.ub, cj.name)
        _fun_equal(cp.fun, cj.fun)
    assert (p.obj is None) == (j.obj is None)
    if p.obj is not None:
        assert (p.obj.const, int(p.obj.sense), p.obj.name) == \
            (j.obj.const, int(j.obj.sense), j.obj.name)
        _fun_equal(p.obj.fun, j.obj.fun)


def _write(tmp_path, name):
    if name == "mps_sample":
        path = tmp_path / "test1.mps"
        path.write_text(MPS_SAMPLE)
    else:
        path = tmp_path / f"{name}.nl"
        jax_write_nl(JSUITE[name][0](), str(path))
    return str(path)


@pytest.mark.parametrize("name", ["batchdes_a", "ex1223_a", "normcon_20a",
                                  "mps_sample"])
def test_readers_parse_equal(name, tmp_path):
    path = _write(tmp_path, name)
    if name == "mps_sample":
        _problems_equal(read_mps(path), jax_read_mps(path))
    else:
        p = read_nl(path)
        _problems_equal(p, jax_read_nl(path))
        # and the file is the suite row
        x = np.random.default_rng(0).uniform(0, 1, p.n_vars)
        q = SUITE[name][0]()
        assert p.eval_objective(x) == pytest.approx(q.eval_objective(x),
                                                    rel=1e-12)


def _read_sol(path):
    lines = open(path).read().splitlines()
    nx = int(lines[lines.index("Options") + 6].split()[0])
    return lines[0], np.array([float(v) for v in lines[-1 - nx:-1]])


@pytest.fixture
def jax_mbnb(monkeypatch, tmp_path):
    """The JAX package's mbnb main, with its compile cache kept inside
    the test's directory and the jax config restored afterwards."""
    import jax
    from minotaur_tpu.solvers import mbnb as jmbnb
    monkeypatch.setenv("MINOTAUR_TPU_CACHE", str(tmp_path / "jax_cache"))
    saved = jax.config.jax_compilation_cache_dir
    yield jmbnb.main
    jax.config.update("jax_compilation_cache_dir", saved)


@pytest.mark.parametrize("name", ["batchdes_a", "ex1223_a", "mps_sample"])
def test_mbnb_cli_solves(name, tmp_path, monkeypatch, jax_mbnb):
    path = _write(tmp_path, name)
    base = os.path.basename(path).rsplit(".", 1)[0]
    run = tmp_path / "port"
    run.mkdir()
    monkeypatch.chdir(run)
    assert mbnb.main([path, "--write_sol_file", "1", "--log_level", "1"],
                     device="cpu") == 0
    msg, x = _read_sol(run / f"{base}.sol")
    assert msg.startswith("mbnb: SOLVED_OPTIMAL, objective ")
    obj = float(msg.rsplit(" ", 1)[1])
    if name == "mps_sample":
        assert obj == pytest.approx(-7.0, abs=1e-6)
        assert len(x) == 3
    else:
        opt = SUITE[name][1]()
        assert abs(obj - opt) <= 1e-6 * (1 + abs(opt))
        assert len(x) == SUITE[name][0]().n_vars
    if name == "ex1223_a":
        return              # the JAX run of this row adds 10 s; the
        # oracle is checked above
    jrun = tmp_path / "jax"
    jrun.mkdir()
    monkeypatch.chdir(jrun)
    assert jax_mbnb([path, "--write_sol_file", "1", "--log_level", "1"]) == 0
    jmsg, jx = _read_sol(jrun / f"{base}.sol")
    assert jmsg.split(",")[0] == msg.split(",")[0]
    assert float(jmsg.rsplit(" ", 1)[1]) == pytest.approx(obj, rel=1e-9,
                                                           abs=1e-9)
    np.testing.assert_allclose(x, jx, atol=1e-6)
