"""The port's entry points (`minotaur_tpu_torch/graft_entry.py`)
against the JAX package, on the CPU.

- `entry(device="cpu")`: `fn(*args)` on the eight branch boxes of the
  stand-in model (stockcycle(24, 8, 0)) against the JAX package's
  `build_node_step_unjitted` vmapped over the same lanes of the same
  model (the root `__graft_entry__.py`'s `fn`): statuses equal, every
  lane OPTIMAL, objectives within 1e-6 relative (the two packages' f32
  factors round differently under the default mixed policy; the IPM's
  tolerance is 1e-7).
- The sharded-step part of `dryrun_multichip(4, device="cpu")` against
  the JAX `build_sharded_step` on a 4-device virtual mesh (conftest.py)
  on the same B = 8 boxes: statuses equal, objectives within 1e-6
  relative, the fused bound within 1e-6 relative.
- The whole dry run at 4 partitions (DistQG and two processes, about
  3 min here) is slow-marked.
- The entry points raise where CUDA is asked for and absent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from minotaur_tpu_torch import graft_entry

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small problems: intra-op threads only contend with the other test
    workers, so the port runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_staged():
    from minotaur_tpu.engines.staging import stage_problem
    from minotaur_tpu.models.convex_suite2 import stockcycle
    return stage_problem(stockcycle(*graft_entry.STAND_IN))


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.all(np.abs(a - b) <= RTOL * np.maximum(1.0, np.abs(b))), (a, b)


def test_entry_matches_jax_vmapped_step():
    from minotaur_tpu.bnb.step import StepOptions, build_node_step_unjitted
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    assert args[3].shape == (8, 24) and args[3][:, 2].tolist() == list(
        range(8))
    out = fn(*args)
    jsp = _jax_staged()
    step_one = build_node_step_unjitted(jsp, StepOptions())
    vlb_b, vub_b = graft_entry.branch_boxes(jsp, 8)
    jout = jax.vmap(step_one, in_axes=(None, None, None, 0, 0, 0))(
        jnp.asarray(jsp.A), jnp.asarray(jsp.clb), jnp.asarray(jsp.cub),
        vlb_b, vub_b, np.zeros((8, jsp.n)))
    status = out.status.numpy()
    assert status.tolist() == np.asarray(jout.status).tolist() == [1] * 8
    _close(out.obj.numpy(), jout.obj)
    # the branch boxes tighten: the objective does not fall
    assert np.all(np.diff(out.obj.numpy()) >= -1e-9)


def test_sharded_step_part_matches_jax():
    from minotaur_tpu.bnb.step import StepOptions
    from minotaur_tpu.parallel.pool import build_sharded_step
    res, gub = graft_entry.sharded_step_part(4, device="cpu")
    jsp = _jax_staged()
    mesh = Mesh(np.array(jax.devices()[:4]), ("nodes",))
    step = build_sharded_step(jsp, StepOptions(), mesh)
    vlb_b, vub_b = graft_entry.branch_boxes(jsp, 8)
    jres, jgub = step(jnp.asarray(jsp.A), jnp.asarray(jsp.clb),
                      jnp.asarray(jsp.cub), vlb_b, vub_b,
                      np.zeros((8, jsp.n)), np.zeros((8, jsp.m)), np.inf)
    assert res.status.tolist() == np.asarray(jres.status).tolist()
    _close(res.obj, jres.obj)
    if np.isfinite(jgub):
        _close(gub, jgub)
    else:
        assert gub == jgub


def test_partition_devices_cycle():
    assert graft_entry.partition_devices(3, "cpu") == ["cpu"] * 3


@pytest.mark.slow
def test_dryrun_multichip_on_cpu():
    graft_entry.dryrun_multichip(4, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.sharded_step_part(2)
