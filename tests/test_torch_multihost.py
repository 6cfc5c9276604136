"""The port's multi-controller QG (parallel/multihost.py, solvers/mqgmpi.py)
on the CPU, beside the JAX package's.

- The host comm layer, copied from the JAX package as it is: the null
  comm, a three-rank TCP star allgather over several rounds, a dead peer
  surfacing as RankFailureError within the collective timeout, and the
  driver's emergency checkpoint and clean abort on a rank failure (ports
  of tests/test_multihost.py's tests of the same names).
- Two ranks of `MpiQGBranchAndBound` in threads over an in-test
  allgather, in each package, on correlated_knapsack(16, 2) at
  node_batch 16, lb_frequency 3: both ranks SOLVED_OPTIMAL at the DP
  optimum, with the same global accounting and at least one node
  migrated.
- `spawn_local` with two ranks as OS processes on the CPU, the `mqgmpi`
  CLI (`--spawn 2` and one rank), and `rank_device`: rank r on
  cuda:{r % cards}, the CPU only when named, and a raise where CUDA is
  asked for and absent.
"""

import os
import socket
import threading

import numpy as np
import pytest
import torch

from minotaur_tpu.models import generators as JG
from minotaur_tpu.parallel import multihost as jmh
from minotaur_tpu.utils.environment import Environment as JEnv
from minotaur_tpu_torch.io.nl_writer import write_nl
from minotaur_tpu_torch.models import generators as G
from minotaur_tpu_torch.parallel import multihost as mh
from minotaur_tpu_torch.parallel.multihost import (HostComm,
                                                   MpiQGBranchAndBound,
                                                   NullComm, RankFailureError,
                                                   TcpHostComm, rank_device)
from minotaur_tpu_torch.solvers import mqgmpi
from minotaur_tpu_torch.utils.environment import Environment

KNAP = (16, 2)
MH_OPTS = {"log_level": 0, "node_batch": 16, "lb_frequency": 3}


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    """Tiny problems: intra-op threads only contend with the other test
    workers, so the port (and each rank process it spawns) runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    yield
    torch.set_num_threads(n)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_null_comm():
    c = NullComm()
    assert c.allgather({"a": 1}) == [{"a": 1}]


def test_tcp_allgather_three_ranks():
    """Star allgather delivers every payload to every rank, in rank
    order, repeatedly (the driver reuses the sockets every round)."""
    coord = f"127.0.0.1:{_free_port()}"
    results = {}

    def run(rank):
        comm = TcpHostComm(rank, 3, coord)
        try:
            for rnd in range(3):
                out = comm.allgather((rank, rnd, np.arange(rank + 1)))
                results[(rank, rnd)] = out
        finally:
            comm.close()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for rank in range(3):
        for rnd in range(3):
            out = results[(rank, rnd)]
            assert [o[0] for o in out] == [0, 1, 2]
            assert all(o[1] == rnd for o in out)
            assert np.array_equal(out[2][2], np.arange(3))


def test_collective_timeout_raises_rank_failure():
    """A dead peer must surface as RankFailureError within the
    collective timeout, not hang (defined rank-death behavior)."""
    coord = f"127.0.0.1:{_free_port()}"
    out = {}

    def rank0():
        comm = TcpHostComm(0, 2, coord, collective_timeout=2.0)
        try:
            comm.allgather("r0-round0")          # round 0 works
            with pytest.raises(RankFailureError):
                comm.allgather("r0-round1")      # peer died
            out["ok"] = True
        finally:
            comm.close()

    def rank1():
        comm = TcpHostComm(1, 2, coord, collective_timeout=2.0)
        comm.allgather("r1-round0")
        comm.close()                             # dies before round 1

    t0 = threading.Thread(target=rank0)
    t1 = threading.Thread(target=rank1)
    t0.start()
    t1.start()
    t0.join(timeout=30)
    t1.join(timeout=30)
    assert out.get("ok")


def test_driver_rank_failure_checkpoints_and_aborts(tmp_path):
    """Driver-level rank death: solve() must checkpoint the local state,
    mark rank_failed, and return a clean non-optimal status (never an
    optimality claim: peer pools are unknowable)."""

    class DyingComm(HostComm):
        rank, world = 0, 2

        def __init__(self):
            self.calls = 0

        def allgather(self, payload):
            self.calls += 1
            if self.calls >= 2:
                raise RankFailureError("peer rank 1 died (test)")
            return [payload, dict(payload, rank=1)]

    ckpt = str(tmp_path / "mh_rankfail.ckpt")
    env = Environment()
    env.set_option("node_batch", 8)
    env.set_option("lb_frequency", 1)
    env.set_option("log_level", 1)
    env.set_option("checkpoint_file", ckpt)
    bab = MpiQGBranchAndBound(G.correlated_knapsack(24, 4), DyingComm(),
                              env=env, device="cpu")
    st = bab.solve()
    assert getattr(bab, "rank_failed", False)
    assert st.name in ("SOLVED_GAP_LIMIT", "FINISHED")
    assert os.path.exists(ckpt)
    assert bab.lb <= bab.ub


class ThreadComm(HostComm):
    """In-process allgather for ranks run as threads: each rank writes
    its slot, all meet at a barrier, read the slots, meet again."""

    def __init__(self, rank, world, slots, barrier):
        self.rank, self.world = rank, world
        self.slots, self.barrier = slots, barrier

    def allgather(self, payload):
        self.slots[self.rank] = payload
        self.barrier.wait(timeout=300)
        out = list(self.slots)
        self.barrier.wait(timeout=300)
        return out


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_two_thread_ranks_reach_the_optimum(pkg):
    if pkg == "jax":
        drv, env_cls, gen, kw = jmh.MpiQGBranchAndBound, JEnv, JG, {}
    else:
        drv, env_cls, gen, kw = MpiQGBranchAndBound, Environment, G, \
            dict(device="cpu")
    world = 2
    slots, barrier = [None] * world, threading.Barrier(world)
    out, errors = {}, []

    def run(rank):
        try:
            env = env_cls()
            for k, v in MH_OPTS.items():
                env.set_option(k, v)
            bab = drv(gen.correlated_knapsack(*KNAP),
                      ThreadComm(rank, world, slots, barrier), env=env, **kw)
            st = bab.solve()
            out[rank] = (st.name, bab.ub, bab.lb, bab.per_rank_processed,
                         bab.sync_stats.nodes_in, bab.stats.nodes_processed)
        except Exception as e:              # surfaces in the main thread
            errors.append(e)
            barrier.abort()

    threads = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    dp = G.knapsack_dp_optimum(*KNAP)
    for r in range(world):
        st, ub, lb, per_rank, _, processed = out[r]
        assert st == "SOLVED_OPTIMAL"
        assert ub == pytest.approx(dp, rel=1e-9)
        assert lb == pytest.approx(dp, rel=1e-9)
        assert per_rank[r] == processed
    assert out[0][3] == out[1][3]
    assert sum(o[4] for o in out.values()) > 0


def _knap_nl(tmp_path):
    path = str(tmp_path / "cknap16.nl")
    write_nl(G.correlated_knapsack(*KNAP), path)
    return path


def test_spawn_local_two_cpu_ranks(tmp_path):
    """Two OS processes, process-local pools, TCP-coordinated balance
    rounds (MpiBranchAndBound.cpp:78-195,388-449)."""
    results = mh.spawn_local(_knap_nl(tmp_path), 2, MH_OPTS, device="cpu",
                             timeout=300)
    dp = G.knapsack_dp_optimum(*KNAP)
    assert [r["rank"] for r in results] == [0, 1]
    assert [r["device"] for r in results] == ["cpu", "cpu"]
    for r in results:
        assert r["status"] == "SOLVED_OPTIMAL"
        assert r["ub"] == pytest.approx(dp, rel=1e-9)
        assert r["lb"] == pytest.approx(dp, rel=1e-9)
        assert r["rounds"] >= 1
    assert results[0]["per_rank"] == results[1]["per_rank"]
    assert sum(results[0]["per_rank"]) == results[0]["global_processed"]
    assert sum(r["migrated_in"] for r in results) > 0


def test_spawn_local_reports_a_failed_rank(tmp_path):
    """A rank that dies (here: a missing instance file) stops the launch
    with its stderr instead of leaving the peers waiting on it.  Both
    ranks die on the file; the launch reports whichever exit it sees
    first."""
    with pytest.raises(RuntimeError, match="rank [01] exited") as err:
        mh.spawn_local(str(tmp_path / "missing.nl"), 2, MH_OPTS,
                       device="cpu", timeout=120)
    assert "missing.nl" in str(err.value)


def test_mqgmpi_cli(tmp_path, capsys):
    path = _knap_nl(tmp_path)
    dp = G.knapsack_dp_optimum(*KNAP)
    rc = mqgmpi.main([path, "--spawn", "2", "--node_batch", "16",
                      "--lb_frequency", "3", "--log_level", "0"],
                     device="cpu")
    text = capsys.readouterr().out
    assert rc == 0
    assert "status: SOLVED_OPTIMAL" in text
    best = [float(line.split()[2]) for line in text.splitlines()
            if line.startswith("best objective:")]
    assert best == [pytest.approx(dp, rel=1e-9)]
    assert "devices: ['cpu', 'cpu']" in text
    # one rank, in this process: the --device flag over main's default
    rc = mqgmpi.main([path, "--node_batch", "16", "--log_level", "0",
                      "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0 and "'status': 'SOLVED_OPTIMAL'" in text


def test_rank_device():
    assert rank_device(3, "cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        cards = torch.cuda.device_count()
        assert rank_device(5, "cuda") == torch.device("cuda", 5 % cards)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            rank_device(0, "cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            rank_device(1)
