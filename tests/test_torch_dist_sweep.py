"""The port's partition-count sweep (`minotaur_tpu_torch/tools/
dist_sweep.py`) against the JAX package's `DistQGBranchAndBound`, on the
CPU.

correlated_knapsack(12, 0), written by the port's nl_writer, runs at
P = 1 and 2 partitions: the port's sweep on `cpu` partitions, the JAX
package's on conftest.py's virtual CPU mesh, both under the JAX script's
settings (node_batch 8 here, tree_search bfs) with `dtype f64`.  Both
reach SOLVED_OPTIMAL at the DP optimum (ub and lb within 1e-9
relative), and each row's per-partition counts sum to its node count.
At P = 1 the two searches process the same 83 nodes.  At P = 2 the
counts part (JAX 71, port 69): the JAX package's distributed step
ignores `dtype` (ROADMAP Queue 3) and runs the mixed policy, whose f32
factors the two packages round differently, so no policy makes the two
step the same; the counts are not compared there.  The command line
writes the JAX script's 11 columns.
"""

import csv

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from minotaur_tpu_torch.io.nl_writer import write_nl
from minotaur_tpu_torch.models.generators import (correlated_knapsack,
                                                  knapsack_dp_optimum)
from minotaur_tpu_torch.tools import dist_sweep

KNAP = (12, 0)
BATCH = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small problems: intra-op threads only contend with the other test
    workers, so the port runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_row(path, parts):
    from minotaur_tpu.io.nl_reader import read_nl
    from minotaur_tpu.parallel.dist_bnb import DistQGBranchAndBound
    from minotaur_tpu.utils.environment import Environment
    env = Environment()
    for k, v in (("node_batch", BATCH), ("tree_search", "bfs"),
                 ("bnb_time_limit", 120.0), ("log_level", 1),
                 ("dtype", "f64")):
        env.set_option(k, v)
    mesh = Mesh(np.array(jax.devices()[:parts]), ("nodes",))
    bab = DistQGBranchAndBound(read_nl(path), mesh, env=env)
    st = bab.solve()
    return dict(status=st.name, nodes=bab.stats.nodes_processed, ub=bab.ub,
                lb=bab.lb, per=[p.nodes_processed for p in bab.pools])


def test_sweep_matches_jax(tmp_path):
    path = str(tmp_path / "cknap12.nl")
    write_nl(correlated_knapsack(*KNAP), path)
    dp = knapsack_dp_optimum(*KNAP)
    rows = dist_sweep.sweep([path], ["cpu"], 2, node_batch=BATCH,
                            options=(("dtype", "f64"),))
    assert [r["parts"] for r in rows] == [1, 2]
    for r in rows:
        j = _jax_row(path, r["parts"])
        assert r["status"] == j["status"] == "SOLVED_OPTIMAL"
        for key in ("ub", "lb"):
            assert abs(r[key] - dp) <= 1e-9 * abs(dp)
            assert abs(j[key] - dp) <= 1e-9 * abs(dp)
        per = [int(c) for c in r["per_part_nodes"].split("|")]
        assert len(per) == r["parts"] == len(j["per"])
        assert sum(per) == r["nodes"] and sum(j["per"]) == j["nodes"]
        assert r["devices"] == ["cpu"] * r["parts"]
        assert r["nodes_per_s"] > 0 and r["supersteps"] > 0
        if r["parts"] == 1:
            assert r["nodes"] == j["nodes"] == 83


def test_cli_writes_the_jax_columns(tmp_path, capsys):
    path = str(tmp_path / "cknap8.nl")
    write_nl(correlated_knapsack(8, 1), path)
    out = str(tmp_path / "sweep.csv")
    assert dist_sweep.main([path, "--device", "cpu", "--max-parts", "1",
                            "--node-batch", str(BATCH), "--out", out]) == 0
    with open(out) as fh:
        rows = list(csv.reader(fh))
    assert tuple(rows[0]) == dist_sweep.HEADER and len(rows[0]) == 11
    assert len(rows) == 2 and rows[1][1] == "1"
    assert rows[1][2] == "SOLVED_OPTIMAL"
    dp = knapsack_dp_optimum(8, 1)
    assert abs(float(rows[1][6]) - dp) <= 1e-6 * abs(dp)
    assert capsys.readouterr().out.startswith(",".join(dist_sweep.HEADER))


def test_part_counts_and_devices():
    assert dist_sweep.part_counts(1) == [1]
    assert dist_sweep.part_counts(4) == [1, 2, 4]
    assert dist_sweep.part_counts(6) == [1, 2, 4]
    assert dist_sweep.default_devices("cpu") == ["cpu"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            dist_sweep.default_devices()
