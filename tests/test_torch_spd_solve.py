"""K2 (scaled-inverse solve with monotone refinement): the port's plain
version against the JAX package's Pallas kernel (interpret mode, vmapped
over lanes) and, for matrix right-hand sides, against the JAX IPM's
solve_xla.  The CUDA kernel is held to the plain version in
test_torch_cuda_kernels.py.

Tolerances: all-float32 arithmetic on both sides with different
summation orders, so results agree to a few eps32 times kappa; the
operators here have kappa ~ 10 and the comparisons use 1e-5 relative.
The spec residual (relative, < 1e-5) is tests/test_pallas.py's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minotaur_tpu.ops.pallas_kernels import refined_spd_solve_f32
from minotaur_tpu_torch.ops.spd_inverse import spd_inverse
from minotaur_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain

RTOL = 1e-5


def _setup(n, B=3, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) + n * np.eye(n)[None]
    d = np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    dinv = 1.0 / d
    Ms = (M * dinv[:, :, None] * dinv[:, None, :]).astype(np.float32)
    minv, _ = spd_inverse(torch.from_numpy(Ms))
    return M, minv.numpy(), dinv


@pytest.mark.parametrize("n", [50, 301])
@pytest.mark.parametrize("steps", [0, 2])
def test_plain_matches_pallas_interpret(n, steps):
    M, minv, dinv = _setup(n)
    B = M.shape[0]
    r = np.random.default_rng(1).standard_normal((B, n))
    M32 = M.astype(np.float32)
    x = spd_solve(torch.from_numpy(minv), torch.from_numpy(M32),
                  torch.from_numpy(dinv.astype(np.float32)),
                  torch.zeros(B, n), torch.from_numpy(r.astype(np.float32)),
                  steps)
    assert x.dtype == torch.float32
    jx = jax.vmap(lambda mi, mm, dv, rr: refined_spd_solve_f32(
        mi, mm, dv, jnp.zeros(n), rr, refine_steps=steps, interpret=True))(
            jnp.asarray(minv), jnp.asarray(M32), jnp.asarray(dinv),
            jnp.asarray(r))
    x = x.numpy().astype(np.float64)
    np.testing.assert_allclose(x, np.asarray(jx), rtol=0,
                               atol=RTOL * np.abs(x).max())
    res = np.linalg.norm(r - np.einsum("bij,bj->bi", M, x), axis=1) / \
        np.linalg.norm(r, axis=1)
    assert res.max() < 1e-5


def test_matrix_rhs_matches_jax_solve_xla():
    # R > 1: one refinement decision per lane over all columns
    from minotaur_tpu.engines.ipm import IPMOptions as JOpts
    from minotaur_tpu.engines.ipm import _make_spd_solver as jax_solver
    from minotaur_tpu_torch.engines.ipm import IPMOptions, _make_spd_solver
    n, R = 40, 5
    M, _, _ = _setup(n, B=4, seed=7)
    rhs = np.random.default_rng(8).standard_normal((4, n, R))
    opts = dict(refine_steps=2, chol_retry=False)
    M32 = M.astype(np.float32)

    def one(Mi, ri):
        solve, _ = jax_solver(jax, jnp, Mi, JOpts(**opts), use_f32=True,
                              out_dtype=jnp.float64)
        return solve(ri)

    jx = np.asarray(jax.vmap(one)(jnp.asarray(M32), jnp.asarray(rhs)))
    solve, _ = _make_spd_solver(torch.from_numpy(M32), IPMOptions(**opts),
                                use_f32=True, out_dtype=torch.float64)
    px = solve(torch.from_numpy(rhs)).numpy()
    assert px.shape == (4, n, R)
    np.testing.assert_allclose(px, jx, rtol=0, atol=RTOL * np.abs(px).max())


# The port's IPM solver against the JAX package's, on the same numpy
# inputs: the main path's dtypes (float32 operator and factors, float64
# right-hand side and result, no refinement: the kernel reads float64 r and
# writes float64 x itself), refinement with a matrix right-hand side, and
# float64 factors with the floor of 3 refinement rounds.  Tolerance: the two
# packages invert the scaled matrix by different routes (cho_solve(I)
# against Linv' Linv) and sum in different orders, so float32 factors agree
# to a few eps32 times kappa (about 10 here): 1e-5 relative to max|x|, as
# above; float64 factors with 3 rounds agree to 1e-12.
@pytest.mark.parametrize("case", ["main_f32_rhs64_refine0",
                                  "f32_refine2_R5", "f64_floor3"])
def test_solver_matches_jax_make_spd_solver(case):
    from minotaur_tpu.engines.ipm import IPMOptions as JOpts
    from minotaur_tpu.engines.ipm import _make_spd_solver as jax_solver
    from minotaur_tpu_torch.engines.ipm import IPMOptions, _make_spd_solver
    n, B = 48, 3
    M, _, _ = _setup(n, B=B, seed=11)
    rng = np.random.default_rng(12)
    if case == "main_f32_rhs64_refine0":
        use_f32, opts, rhs, tol = True, dict(refine_steps=0), \
            rng.standard_normal((B, n)), RTOL
    elif case == "f32_refine2_R5":
        use_f32, opts, rhs, tol = True, dict(refine_steps=2), \
            rng.standard_normal((B, n, 5)), RTOL
    else:
        use_f32, opts, rhs, tol = False, dict(refine_steps=0), \
            rng.standard_normal((B, n, 2)), 1e-12
    opts["chol_retry"] = False
    Mi = M.astype(np.float32) if use_f32 else M

    def one(Ml, rl):
        solve, _ = jax_solver(jax, jnp, Ml, JOpts(**opts), use_f32=use_f32,
                              out_dtype=jnp.float64)
        return solve(rl)

    jx = np.asarray(jax.vmap(one)(jnp.asarray(Mi), jnp.asarray(rhs)))
    solve, _ = _make_spd_solver(torch.from_numpy(Mi), IPMOptions(**opts),
                                use_f32=use_f32, out_dtype=torch.float64)
    px = solve(torch.from_numpy(rhs))
    assert px.dtype == torch.float64 and tuple(px.shape) == rhs.shape
    px = px.numpy()
    np.testing.assert_allclose(px, jx, rtol=0, atol=tol * np.abs(px).max())


def test_linearity_over_the_batch():
    M, minv, dinv = _setup(64, B=1)
    r = np.random.default_rng(2).standard_normal(64)
    two = lambda a: torch.from_numpy(np.stack([a[0], a[0]]))  # noqa: E731
    x = spd_solve(two(minv), two(M.astype(np.float32)),
                  two(dinv.astype(np.float32)), torch.zeros(2, 64),
                  torch.from_numpy(np.stack([r, 2 * r]).astype(np.float32)), 2)
    np.testing.assert_allclose(x[1].numpy(), 2 * x[0].numpy(),
                               rtol=1e-4, atol=1e-6)
