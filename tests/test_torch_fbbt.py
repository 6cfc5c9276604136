"""Linear FBBT: the port's batched `linear_fbbt` and superstep sweep
against the JAX package's (vmapped over the same boxes).

Tolerance: rtol 1e-12.  Both sides compute the same float64 expressions;
only the order of the row sums may differ.  Infinite bounds must match
exactly, and so must the infeasibility flags.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minotaur_tpu.ops.interval import linear_fbbt as jax_fbbt
from minotaur_tpu_torch.ops.interval import linear_fbbt as port_fbbt

RTOL = 1e-12


def _case(seed, B=6, m=5, n=7):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n)).round(2)
    A[rng.random((m, n)) < 0.3] = 0.0           # zero coefficients
    A[0, :] = 0.0
    A[0, 1] = 2.0                                # a singleton row
    lo = rng.uniform(-5, 0, size=(B, n))
    hi = rng.uniform(0, 5, size=(B, n))
    lo[rng.random((B, n)) < 0.25] = -np.inf      # +-inf bounds
    hi[rng.random((B, n)) < 0.25] = np.inf
    lo[1, :] = -np.inf                           # a lane with no lower bounds
    rlo = rng.uniform(-3, 0, size=m)
    rhi = rng.uniform(0, 3, size=m)
    rlo[rng.random(m) < 0.3] = -np.inf
    rhi[2] = np.inf
    lo[3, 0], hi[3, 0] = 4.0, 4.0               # fixed variable
    return A, rlo, rhi, lo, hi


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.array_equal(np.isinf(a), np.isinf(b))
    assert np.array_equal(np.sign(a[np.isinf(a)]), np.sign(b[np.isinf(b)]))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], rtol=RTOL, atol=1e-13)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_linear_fbbt_matches_jax(seed):
    A, rlo, rhi, lo, hi = _case(seed)
    jlo, jhi, jinf = jax.vmap(lambda l, h: jax_fbbt(
        jnp.asarray(A), jnp.asarray(rlo), jnp.asarray(rhi), l, h))(
            jnp.asarray(lo), jnp.asarray(hi))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    plo, phi, pinf = port_fbbt(t(A), t(rlo), t(rhi), t(lo), t(hi))
    _assert_same(plo.numpy(), jlo)
    _assert_same(phi.numpy(), jhi)
    assert np.array_equal(pinf.numpy(), np.asarray(jinf))


def test_linear_fbbt_infeasible_and_empty_rows():
    # row x0 + x1 >= 10 with both in [0, 1]: infeasible; and m = 0
    A = np.array([[1.0, 1.0]])
    lo = np.zeros((2, 2))
    hi = np.ones((2, 2))
    hi[1] = 20.0
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    _, _, inf = port_fbbt(t(A), t([10.0]), t([np.inf]), t(lo), t(hi))
    assert inf.tolist() == [True, False]
    plo, phi, inf0 = port_fbbt(t(np.zeros((0, 2))), t([]), t([]), t(lo), t(hi))
    assert not inf0.any() and torch.equal(plo, t(lo)) and torch.equal(phi, t(hi))


def test_fbbt_sweep_with_integer_rounding_matches_jax():
    from minotaur_tpu.bnb.step import build_fbbt_sweep as jax_sweep
    from minotaur_tpu.engines.staging import stage_problem as jax_stage
    from minotaur_tpu.models.generators import correlated_knapsack
    from minotaur_tpu_torch.bnb.step import build_fbbt_sweep
    from minotaur_tpu_torch.convert import staged_fields, staged_from_numpy

    jsp = jax_stage(correlated_knapsack(12, 3))
    sp = staged_from_numpy(staged_fields(jsp))
    rng = np.random.default_rng(5)
    B = 6
    lo = np.tile(sp.vlb, (B, 1))
    hi = np.tile(sp.vub, (B, 1))
    for b in range(B):                 # fix a few binaries to one
        j = rng.choice(sp.n, size=2 * b + 1, replace=False)
        lo[b, j] = 1.0
    js = jax_sweep(jsp)
    jres = jax.vmap(lambda l, h: js(jnp.asarray(jsp.A), jnp.asarray(jsp.clb),
                                    jnp.asarray(jsp.cub), l, h,
                                    jnp.asarray(False)))(
        jnp.asarray(lo), jnp.asarray(hi))
    ps = build_fbbt_sweep(sp, device="cpu")
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    pres = ps(t(sp.A), t(sp.clb), t(sp.cub), t(lo), t(hi),
              torch.zeros(B, dtype=torch.bool))
    _assert_same(pres[0].numpy(), jres[0])
    _assert_same(pres[1].numpy(), jres[1])
    assert np.array_equal(pres[2].numpy(), np.asarray(jres[2]))
    assert pres[2].any()               # some lanes overfill the knapsack
