"""The node superstep: the port's `build_node_step` against the JAX
package's on identical boxes, starts and dual warm starts.

- The packed layout (B, 4n+m+10) float64 is the same, column for column,
  and both packages' `unpack_step_result` read it the same way.
- FBBT outputs (new_vlb, new_vub, fbbt_infeas) are exactly equal: the
  sweep is float64 with the same operations.
- Under the f64 dtype policy the IPM follows the same path in both
  packages, so statuses, integrality verdicts and branching variables are
  equal and objectives / bounds agree within 1e-6 * (1 + |obj|).  (Under
  the default mixed policy f32 rounding can flip lanes near the f32
  floor; tests/test_torch_ipm.py holds that policy to its own checks.)
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from minotaur_tpu.bnb.step import StepOptions as JStepOptions
from minotaur_tpu.bnb.step import build_node_step as jax_step
from minotaur_tpu.bnb.step import unpack_step_result as jax_unpack
from minotaur_tpu.engines.ipm import IPMOptions as JOpts
from minotaur_tpu.engines.staging import stage_problem as jax_stage
from minotaur_tpu.models import generators as G
from minotaur_tpu_torch.bnb.step import StepOptions, build_node_step
from minotaur_tpu_torch.convert import staged_fields, staged_from_numpy
from minotaur_tpu_torch.engines.ipm import IPMOptions

B = 8
F64 = dict(factor_f32=False, tail_factor_f32=False)


def _inputs(sp, seed):
    rng = np.random.default_rng(seed)
    lo = np.tile(sp.vlb, (B, 1))
    hi = np.tile(sp.vub, (B, 1))
    ints = np.where(sp.int_mask)[0]
    for b in range(1, B):
        pick = rng.choice(ints, size=min(len(ints), b), replace=False)
        v = np.clip(np.floor(rng.uniform(sp.vlb[pick], sp.vub[pick] + 1)),
                    sp.vlb[pick], sp.vub[pick])
        lo[b, pick] = np.maximum(v, lo[b, pick])
    lo[B - 1] = hi[B - 1]                    # everything at its max: no row fits
    x0 = rng.uniform(0, 1, size=(B, sp.n))
    y0 = np.zeros((B, sp.m))
    y0[2] = -rng.uniform(0, 1, size=sp.m)    # one dual warm start
    return lo, hi, x0, y0


@pytest.mark.parametrize("name,policy", [("cknap", "mixed"), ("cknap", "f64"),
                                         ("cmiqp", "mixed"), ("cmiqp", "f64")])
def test_step_matches_jax(name, policy):
    prob = G.correlated_knapsack(12, 2) if name == "cknap" \
        else G.convex_miqp(4, 4, 1)
    jsp = jax_stage(prob)
    sp = staged_from_numpy(staged_fields(jsp))
    kw = F64 if policy == "f64" else {}
    lo, hi, x0, y0 = _inputs(sp, 4)
    jpacked = np.asarray(jax_step(jsp, JStepOptions(ipm=JOpts(**kw))).dispatch(
        jnp.asarray(jsp.A), jnp.asarray(jsp.clb), jnp.asarray(jsp.cub),
        lo, hi, x0, y0))
    step = build_node_step(sp, StepOptions(ipm=IPMOptions(**kw)),
                           device="cpu")
    ppacked = step.dispatch(sp.A, sp.clb, sp.cub, lo, hi, x0, y0)
    assert tuple(ppacked.shape) == jpacked.shape == (B, 4 * sp.n + sp.m + 10)
    pp = ppacked.numpy()
    n = sp.n
    # FBBT columns: new_vlb, new_vub and fbbt_infeas, bit for bit
    fb = slice(10 + n, 10 + 3 * n)
    assert np.array_equal(pp[:, fb], jpacked[:, fb])
    assert np.array_equal(pp[:, 7], jpacked[:, 7])
    jr = jax_unpack(jpacked, n, sp.m)
    pr = step.unpack(ppacked)
    assert type(pr).__name__ == "StepResult" and pr._fields == jr._fields
    assert pr.fbbt_infeas[B - 1]             # the FBBT sweep proves it
    assert np.all(pr.status[pr.fbbt_infeas] == 2)
    assert np.all(pr.dual_bound[pr.fbbt_infeas] == 1e20)
    if policy == "f64":
        assert pr.status.tolist() == jr.status.tolist()
        assert pr.int_feasible.tolist() == jr.int_feasible.tolist()
        assert pr.branch_var.tolist() == jr.branch_var.tolist()
        assert pr.iters.tolist() == jr.iters.tolist()
        scale = 1 + np.abs(pr.obj)
        ok = pr.status != 2
        np.testing.assert_array_less(np.abs(pr.obj - jr.obj)[ok], 1e-6 * scale[ok])
        np.testing.assert_array_less(np.abs(pr.dual_bound - jr.dual_bound)[ok],
                                     1e-6 * scale[ok])
        np.testing.assert_allclose(pr.x[ok], jr.x[ok], rtol=0, atol=1e-6)


def test_step_result_layout_roundtrip():
    from minotaur_tpu_torch.bnb.step import pack_step_result, unpack_step_result
    import torch
    rng = np.random.default_rng(0)
    n, m, b = 3, 2, 4
    res = dict(status=torch.tensor([1, 2, 4, 1], dtype=torch.int32),
               obj=torch.tensor(rng.normal(size=b)),
               dual_bound=torch.tensor(rng.normal(size=b)),
               int_feasible=torch.tensor([True, False, False, True]),
               branch_var=torch.tensor([-1, 2, 0, -1]),
               branch_val=torch.tensor(rng.normal(size=b)),
               max_frac=torch.tensor(rng.uniform(size=b)),
               fbbt_infeas=torch.tensor([False, True, False, False]),
               kkt_err=torch.tensor(rng.uniform(size=b)),
               iters=torch.tensor([3, 1, 9, 4]))
    for f, w in (("x", n), ("new_vlb", n), ("new_vub", n), ("frac", n),
                 ("y", m)):
        res[f] = torch.tensor(rng.normal(size=(b, w)))
    arr = pack_step_result(res).numpy()
    for mine, ref in zip(unpack_step_result(arr, n, m), jax_unpack(arr, n, m)):
        assert np.array_equal(np.asarray(mine), np.asarray(ref))
    u = unpack_step_result(arr, n, m)
    assert u.status.tolist() == [1, 2, 4, 1]
    assert u.branch_var.tolist() == [-1, 2, 0, -1]
    np.testing.assert_array_equal(u.y, res["y"].numpy())
    assert dataclasses.is_dataclass(StepOptions)
