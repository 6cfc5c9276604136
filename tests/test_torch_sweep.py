"""The port's sweep harness (tools/sweep.py), on the CPU.

- Three tiny rows (gbd_a and batchdes_a under `mbnb`, st_e14a under
  `mqg`) through `main`: exit 0, every row SOLVED_OPTIMAL, sound and equal
  to its oracle, the JSON lines and the markdown table written.
- Rows are keyed on (name, solver): `--resume` reuses a finished row and
  runs no solve for it.
- A row whose solve raises is written as `ERROR:<type>`, counts as
  unsound, and the sweep exits 1.
- The oracle check: a bound above the optimum or an incumbent below it
  is unsound.
- Slow: the n >= 1000 rows cknap_1200a (`mbnb`) and intquad_2048a
  (`mbnb`), capped, end sound against their oracles (the JAX package's
  fast suite skips these oracles, tests/test_convex_suite.py:20).
"""

import json

import pytest
import torch

from minotaur_tpu_torch.tools import sweep


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(tmp_path, *extra):
    return ["--device", "cpu", "--cap", "120", "--out",
            str(tmp_path / "rows.jsonl"), "--md", str(tmp_path / "s.md"),
            *extra]


def test_tiny_rows_sound_and_optimal(tmp_path, capsys):
    assert sweep.main(_args(tmp_path, "--only",
                            "gbd_a,batchdes_a,st_e14a")) == 0
    rows = [json.loads(line) for line in
            (tmp_path / "rows.jsonl").read_text().splitlines()]
    assert [(r["name"], r["solver"]) for r in rows] == \
        [("gbd_a", "mbnb"), ("batchdes_a", "mbnb"), ("st_e14a", "mqg")]
    for r in rows:
        assert r["status"] == "SOLVED_OPTIMAL", r
        assert r["sound"] and r["verified"], r
    md = (tmp_path / "s.md").read_text()
    assert "| st_e14a | mqg |" in md
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["rows"] == 3


def test_resume_keys_on_name_and_solver(tmp_path, monkeypatch):
    row = dict(name="gbd_a", solver="mbnb", n=6, status="SOLVED_OPTIMAL",
               wall=1.0, nodes=1, lb=-3.7, ub=-3.7, gap=0.0, truth=-3.7,
               sound=True, verified=True, note="gbd")
    (tmp_path / "rows.jsonl").write_text(json.dumps(row) + "\n")
    monkeypatch.setattr(sweep, "run_one", lambda *a, **k: pytest.fail(
        "a resumed row was solved again"))
    assert sweep.main(_args(tmp_path, "--only", "gbd_a", "--resume")) == 0
    # the same name under another solver is another row
    row["solver"] = "mqg"
    (tmp_path / "rows.jsonl").write_text(json.dumps(row) + "\n")
    with pytest.raises(pytest.fail.Exception):
        sweep.main(_args(tmp_path, "--only", "gbd_a", "--resume"))


def test_error_row_is_marked_and_fails(tmp_path, monkeypatch):
    from minotaur_tpu_torch.bnb.bnb import BranchAndBound

    def boom(self):
        raise FloatingPointError("injected")
    monkeypatch.setattr(BranchAndBound, "solve", boom)
    assert sweep.main(_args(tmp_path, "--only", "gbd_a")) == 1
    r = json.loads((tmp_path / "rows.jsonl").read_text())
    assert r["status"] == "ERROR:FloatingPointError" and not r["sound"]


def test_oracle_check():
    assert sweep.check_row(-1.0, 1.0, 0.0) == dict(sound=True,
                                                  verified=False)
    assert sweep.check_row(0.0, 0.0, 0.0) == dict(sound=True, verified=True)
    assert not sweep.check_row(0.1, 1.0, 0.0)["sound"]      # lb above opt
    assert not sweep.check_row(-1.0, -0.1, 0.0)["sound"]    # ub below opt
    assert sweep.check_row(-1.0, float("inf"), 0.0)["sound"]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["cknap_1200a", "intquad_2048a"])
def test_big_row_sound_against_oracle(name):
    plan = {r[0]: r for r in sweep.PLAN}
    _, solver, nlim, _, _ = plan[name]
    r = sweep.run_one(name, solver, nlim, 300.0, "cpu")
    assert not r["status"].startswith("ERROR"), r
    assert r["sound"], r
