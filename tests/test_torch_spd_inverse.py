"""K1 (batched SPD factorize + explicit inverse): the port's plain
version against the JAX package's Pallas kernel (interpret mode) and its
XLA path, plus the kernel spec of tests/test_pallas_kkt.py.  The CUDA
kernel is held to the plain version in test_torch_cuda_kernels.py.

Tolerances: the inverse is float32, so two correct implementations agree
to about kappa * eps32 relative; the spec matrices have kappa ~ 10, and
the comparisons use 2e-5 relative to max|Minv|.  The spec residuals are
the Pallas spec's own (5e-5, 1e-2 for the ill-conditioned case).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minotaur_tpu.ops.pallas_kkt import batched_spd_inverse
from minotaur_tpu_torch.ops.spd_inverse import (spd_inverse,
                                                spd_inverse_plain)

CMP_RTOL = 2e-5


def _spd(rng, B, k, scale=1.0):
    A = rng.standard_normal((B, k, k)).astype(np.float32)
    return np.einsum("bij,bkj->bik", A, A) / k + \
        np.eye(k, dtype=np.float32)[None] * scale


def _resid(M, Minv):
    k = M.shape[-1]
    return np.abs(np.eye(k)[None] - np.einsum(
        "bij,bjk->bik", M.astype(np.float64), Minv.astype(np.float64))).max()


SPEC = [(3, 50), (4, 130), (2, 300), (5, 1)]


@pytest.mark.parametrize("B,k", SPEC)
def test_plain_matches_pallas_interpret(B, k):
    rng = np.random.default_rng(0)
    M = _spd(rng, B, k, 2.0)
    minv, flag = spd_inverse(torch.from_numpy(M))
    assert minv.dtype == torch.float32 and flag.tolist() == [0.0] * B
    assert _resid(M, minv.numpy()) < 5e-5
    jminv, jflag = batched_spd_inverse(jnp.asarray(M), interpret=True)
    assert np.all(np.asarray(jflag) == 0.0)
    scale = np.abs(np.asarray(jminv)).max()
    np.testing.assert_allclose(minv.numpy(), np.asarray(jminv),
                               atol=CMP_RTOL * scale, rtol=0)


def _jax_solver_inverse(M, chol_retry):
    """M^-1 through the JAX IPM's _make_spd_solver (XLA path) under vmap:
    solve(I) with no refinement is dinv * Minv_s * dinv."""
    from minotaur_tpu.engines.ipm import IPMOptions, _make_spd_solver
    opts = IPMOptions(refine_steps=0, chol_retry=chol_retry)
    k = M.shape[-1]

    def one(Mi):
        solve, bad = _make_spd_solver(jax, jnp, Mi, opts, use_f32=True,
                                      out_dtype=jnp.float64)
        return solve(jnp.eye(k, dtype=Mi.dtype)), bad

    return jax.vmap(one)(jnp.asarray(M))


@pytest.mark.parametrize("chol_retry", [False, True])
def test_ipm_solver_matches_jax_xla(chol_retry):
    from minotaur_tpu_torch.engines.ipm import IPMOptions, _make_spd_solver
    rng = np.random.default_rng(3)
    k = 40
    M = _spd(rng, 4, k, 1.0).astype(np.float64)
    M[0] += np.diag(10.0 ** rng.uniform(-3, 3, size=k))
    M[2] -= 4.0 * np.eye(k)                 # indefinite lane
    jinv, jbad = _jax_solver_inverse(M, chol_retry)
    opts = IPMOptions(refine_steps=0, chol_retry=chol_retry)
    solve, bad = _make_spd_solver(torch.from_numpy(M), opts, use_f32=True,
                                  out_dtype=torch.float64)
    pinv = solve(torch.eye(k, dtype=torch.float64).expand(4, k, k))
    assert bad.tolist() == np.asarray(jbad).tolist()
    jinv = np.asarray(jinv)
    for b in range(4):
        scale = np.abs(jinv[b]).max()
        np.testing.assert_allclose(pinv[b].numpy(), jinv[b],
                                   atol=CMP_RTOL * scale, rtol=0)


def test_indefinite_lane_flagged():
    rng = np.random.default_rng(1)
    M = _spd(rng, 2, 64, 2.0)
    M[1] -= 6.0 * np.eye(64, dtype=np.float32)   # indefinite lane
    minv, flag = spd_inverse(torch.from_numpy(M))
    assert flag.tolist() == [0.0, 2.0]
    assert _resid(M[:1], minv[:1].numpy()) < 5e-5
    assert torch.equal(minv[1], torch.eye(64))


def test_ill_conditioned_jacobi_scaled():
    rng = np.random.default_rng(2)
    k = 200
    M = _spd(rng, 2, k, 1.0).astype(np.float64)
    M[0] += np.diag(10.0 ** rng.uniform(-6, 6, size=k))
    d = np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    Ms = (M / d[:, :, None] / d[:, None, :]).astype(np.float32)
    minv, flag = spd_inverse(torch.from_numpy(Ms))
    assert flag.tolist() == [0.0, 0.0]
    assert _resid(Ms, minv.numpy()) < 1e-2


def test_nan_lane_and_float64():
    M = _spd(np.random.default_rng(4), 3, 20, 1.0).astype(np.float64)
    M[2, 3, 4] = M[2, 4, 3] = np.nan
    minv, flag = spd_inverse(torch.from_numpy(M))
    assert minv.dtype == torch.float64 and flag.tolist() == [0.0, 0.0, 2.0]
    assert _resid(M[:2], minv[:2].numpy()) < 1e-12


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        spd_inverse(torch.zeros(2, 3, 4))
    with pytest.raises(TypeError):
        spd_inverse(torch.zeros(2, 3, 3, dtype=torch.float16))
