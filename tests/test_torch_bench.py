"""The port's bench entry (`python -m minotaur_tpu_torch.bench`) on the CPU.

`bench.run` at the bench's settings on intquad(24, 4, 0) (the stand-in
family of the bench's intquad(300, 4, 0)) must return the one-line dict
with `bench.py`'s four keys, be sound against `intquad_optimum`, and end
with the JAX `BranchAndBound`'s status and incumbent (within 1e-9
relative: both reach the same optimum, only the last digits may round
differently); under `dtype f64` the node counts are equal.  The command
line prints exactly one stdout line, and exits non-zero on a missing
.nl path, an unsound result and a missing card.
"""

import json
import os
import subprocess
import sys

import pytest

from minotaur_tpu_torch import bench
from minotaur_tpu_torch.io.nl_writer import write_nl
from minotaur_tpu_torch.models.convex_suite2 import intquad, intquad_optimum

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small problems: intra-op threads only contend with the other test
    workers, so the port runs on one."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_bab(options):
    from minotaur_tpu.bnb.bnb import BranchAndBound as JaxBnB
    from minotaur_tpu.models.convex_suite2 import intquad as jax_intquad
    from minotaur_tpu.utils.environment import Environment as JaxEnv
    env = JaxEnv()
    for k, v in bench.OPTIONS + (("bnb_node_limit", bench.NODE_LIMIT),
                                 ("bnb_time_limit", bench.TIME_LIMIT)) + \
            options:
        env.set_option(k, v)
    bab = JaxBnB(jax_intquad(24, 4, 0), env)
    bab.solve()
    return bab


@pytest.mark.parametrize("options", [(), (("dtype", "f64"),)],
                         ids=["mixed", "f64"])
def test_run_matches_jax(options):
    opt = intquad_optimum(24, 4, 0)
    res = bench.run(intquad(24, 4, 0), optimum=opt, device="cpu",
                    options=options)
    line = res["line"]
    assert tuple(line) == bench.LINE_KEYS
    assert line["metric"] == "bnb_nodes_per_sec" and \
        line["unit"] == "nodes/s"
    assert line["value"] > 0
    assert line["vs_baseline"] == round(
        res["nodes"] / res["seconds"] / bench.BASELINE_NODES_PER_SEC, 3)
    tol = bench.SOUND_RTOL * (1 + abs(opt))
    assert res["lb"] <= opt + tol and opt <= res["ub"] + tol
    assert res["ipm_iters"] > 0
    # on the CPU the wrappers run their plain versions: no launch counted
    assert res["launches"] == {"spd_inverse": 0, "spd_solve": 0}
    jb = _jax_bab(options)
    assert res["status"] == jb.status
    assert abs(res["ub"] - jb.ub) <= 1e-9 * (1 + abs(jb.ub))
    if options:
        assert res["nodes"] == jb.stats.nodes_processed


@pytest.fixture(scope="module")
def small_nl(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench") / "intquad_12.nl")
    write_nl(intquad(12, 4, 0), path)
    return path, intquad_optimum(12, 4, 0)


def test_cli_prints_one_line(small_nl, capsys):
    path, opt = small_nl
    assert bench.main([path, "--optimum", repr(opt)], device="cpu") == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1
    assert tuple(json.loads(out[0])) == bench.LINE_KEYS


def test_cli_refuses_unsound_result(small_nl, capsys):
    path, opt = small_nl
    # an oracle below the certified lower bound: lb <= opt fails
    assert bench.main([path, "--optimum", repr(opt - 1.0)],
                      device="cpu") == 1
    cap = capsys.readouterr()
    assert cap.out == "" and "unsound" in cap.err


def test_cli_refuses_missing_file(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main([str(tmp_path / "absent.nl")], device="cpu")
    assert exc.value.code != 0
    assert capsys.readouterr().out == ""


def test_cli_without_card_exits_nonzero():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run the bench")
    out = subprocess.run([sys.executable, "-m", "minotaur_tpu_torch.bench"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "torch.cuda.is_available() is False" in out.stderr
