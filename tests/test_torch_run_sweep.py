"""The port's .nl sweep (`minotaur_tpu_torch/tools/run_sweep.py`) against
the JAX script `scripts/run_sweep.py`, on the CPU.

Two suite rows with exact oracles, st_e14a (5 variables, convex MINLP)
and gbd_a (6 variables, convex MIQP), are written by the port's
nl_writer, each into a directory of its own.  Each solver's sweep runs through the
port's `main` and through the JAX script's `main` on the same files and
the same solutions CSV (`mbnb` on both files; `mqg` and `moa` on
st_e14a, whose JAX runs take the least compile time).  Per file the two
CSVs agree on status and nodes, and on ub within 1e-6 relative (the same
search; f32 factors may round the last digits differently); the port's
CSV has the JAX script's columns, and dev_from_known is within 1e-5 of
the oracle.  A solver that raises gives an `ERROR:<type>` row and exit
code 1; a glob with no match exits 1.
"""

import csv
import importlib.util
import os
import sys

import pytest
import torch

from minotaur_tpu_torch.io.nl_writer import write_nl
from minotaur_tpu_torch.models.convex_suite import SUITE
from minotaur_tpu_torch.tools import run_sweep

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = ("st_e14a", "gbd_a")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small problems: intra-op threads only contend with the other test
    workers, so the port runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def instances(tmp_path_factory):
    """A directory per file set, and the solutions CSV."""
    base = tmp_path_factory.mktemp("nl")
    for name in ROWS:
        d = base / name
        d.mkdir()
        write_nl(SUITE[name][0](), str(d / f"{name}.nl"))
    sol = base / "known.csv"
    sol.write_text("name,objective\n" + "".join(
        f"{name},{SUITE[name][1]()!r}\n" for name in ROWS))
    return base, str(sol)


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_run_sweep", os.path.join(ROOT, "scripts", "run_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(path):
    with open(path) as fh:
        rows = list(csv.reader(fh))
    return rows[0], {r[0]: r for r in rows[1:]}


@pytest.mark.parametrize("solver,rows", [("mbnb", ROWS),
                                         ("mqg", ("st_e14a",)),
                                         ("moa", ("st_e14a",))])
def test_sweep_matches_jax_script(instances, tmp_path, monkeypatch, solver,
                                  rows):
    base, sol = instances
    spec = (str(base / rows[0] / "*.nl") if len(rows) == 1
            else str(base / "*" / "*.nl"))
    mine, theirs = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    assert run_sweep.main([spec, "--solver", solver, "--time", "60",
                           "--out", mine, "--solutions", sol,
                           "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", [
        "run_sweep.py", spec, "--solver", solver, "--time", "60", "--out",
        theirs, "--solutions", sol])
    assert _jax_script().main() == 0
    hdr, got = _read(mine)
    jhdr, want = _read(theirs)
    assert tuple(hdr) == tuple(jhdr) == run_sweep.COLUMNS
    assert sorted(got) == sorted(want) == sorted(rows)
    for name in rows:
        p, j = got[name], want[name]
        assert p[1] == j[1], (name, p, j)                   # status
        assert p[5] == j[5], (name, p, j)                   # nodes
        ub, jub = float(p[2]), float(j[2])
        assert abs(ub - jub) <= 1e-6 * max(1.0, abs(jub)), (name, p, j)
        opt = SUITE[name][1]()
        assert abs(float(p[7])) <= 1e-5 * max(1.0, abs(opt)), (name, p)


def test_error_row_exits_one(instances, tmp_path, monkeypatch):
    base, _ = instances

    class Raising:
        def __init__(self, *a, **k):
            raise ValueError("boom")

    monkeypatch.setattr("minotaur_tpu_torch.bnb.bnb.BranchAndBound",
                        Raising)
    out = str(tmp_path / "err.csv")
    assert run_sweep.main([str(base / "gbd_a"), "--out", out,
                           "--device", "cpu"]) == 1
    _, rows = _read(out)
    assert rows["gbd_a"][1] == "ERROR:ValueError"
    assert rows["gbd_a"][2] == "inf" and rows["gbd_a"][3] == "-inf"


def test_no_match_and_missing_card(tmp_path):
    assert run_sweep.main([str(tmp_path / "*.nl"), "--device", "cpu",
                           "--out", str(tmp_path / "x.csv")]) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            run_sweep.main([str(tmp_path), "--out",
                            str(tmp_path / "x.csv")])
