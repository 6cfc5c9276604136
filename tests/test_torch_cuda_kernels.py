"""The CUDA kernels of minotaur_tpu_torch against their plain PyTorch
versions on the card, with the launch counters.  These tests need a GPU
and nvcc (a CUDA kernel has no CPU mode) and skip elsewhere.

This file imports no jax, so on a machine without it the tests run with
`python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda`.

Tolerances: K1 at 5e-5 (f32; the spec residual of tests/test_pallas_kkt.py)
and 1e-12 (f64) relative to max|Minv|; K2 at 1e-5 (f32 factor, the
spec of tests/test_pallas.py) and 1e-12 (f64) relative to max|x|.
"""

import numpy as np
import pytest
import torch

from minotaur_tpu_torch.ops.spd_inverse import spd_inverse, spd_inverse_plain
from minotaur_tpu_torch.ops.spd_solve import spd_solve, spd_solve_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _spd(rng, B, k, scale=1.0):
    A = rng.standard_normal((B, k, k)).astype(np.float32)
    return np.einsum("bij,bkj->bik", A, A) / k + \
        np.eye(k, dtype=np.float32)[None] * scale


def spoil(M, defect):
    """Make lane 0 of M fail: "shift" (-6 I, fails at column 0), "late"
    (the diagonal entry of column 2*32+5, or the last one, set 0.5 below
    its Schur complement term, so the pivot there is -0.5 and the failure
    comes after two panels of updates), "nan" (one NaN pair), or "none"."""
    k = M.shape[-1]
    if defect == "shift":
        M[0] -= 6.0 * np.eye(k, dtype=M.dtype)
    elif defect == "late":
        j = min(2 * 32 + 5, k - 1)
        a = M[0].astype(np.float64)
        s = a[j, :j] @ np.linalg.solve(a[:j, :j], a[:j, j]) if j else 0.0
        M[0, j, j] = s - 0.5
    elif defect == "nan":
        M[0, k // 2, k // 3] = M[0, k // 3, k // 2] = np.nan
    return M


# ragged k (not a multiple of the panel width 32), B=1, the bench shape,
# and k=900, whose f64 panel does not fit shared memory
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,k,defect", [
    (3, 50, "shift"), (4, 130, "shift"), (2, 300, "shift"), (5, 1, "none"),
    (64, 300, "shift"), (3, 31, "nan"), (3, 33, "late"), (4, 65, "late"),
    (4, 129, "nan"), (4, 301, "late"), (1, 300, "none"), (1, 1, "nan"),
    (2, 900, "late")])
def test_spd_inverse_kernel_matches_plain(cuda, dtype, B, k, defect):
    M = spoil(_spd(np.random.default_rng(0), B, k, 2.0), defect)
    ms = torch.from_numpy(M).to(cuda, dtype)
    n0 = spd_inverse.launches
    minv, flag = spd_inverse(ms)
    torch.cuda.synchronize()
    assert spd_inverse.launches == n0 + 1
    pminv, pflag = spd_inverse_plain(ms)
    assert torch.equal(flag, pflag)
    assert flag[0].item() == (0.0 if defect == "none" else 2.0)
    tol = 5e-5 if dtype == torch.float32 else 1e-12
    scale = pminv.abs().max()
    assert (minv - pminv).abs().max() <= tol * scale


def _solve_setup(n, B, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, n, n))
    M = np.einsum("bij,bkj->bik", A, A) + n * np.eye(n)[None]
    dinv = 1.0 / np.sqrt(np.diagonal(M, axis1=1, axis2=2))
    Ms = (M * dinv[:, :, None] * dinv[:, None, :]).astype(np.float32)
    minv, _ = spd_inverse_plain(torch.from_numpy(Ms))
    return M, minv.numpy(), dinv


@pytest.mark.parametrize("steps", [0, 2])
@pytest.mark.parametrize("R", [1, 8])
@pytest.mark.parametrize("fdt,mdt", [(torch.float32, torch.float32),
                                     (torch.float32, torch.float64),
                                     (torch.float64, torch.float64)])
def test_spd_solve_kernel_matches_plain(cuda, steps, R, fdt, mdt):
    M, minv, dinv = _solve_setup(300, 64)
    rng = np.random.default_rng(3)
    r = rng.standard_normal((64, 300, R))
    args = (torch.from_numpy(minv).to(cuda, fdt),
            torch.from_numpy(M).to(cuda, mdt),
            torch.from_numpy(dinv).to(cuda, mdt),
            torch.from_numpy(rng.uniform(0, 1e-3, (64, 300))).to(cuda, mdt),
            torch.from_numpy(r).to(cuda, mdt))
    n0 = spd_solve.launches
    x = spd_solve(*args, steps, torch.float64)
    torch.cuda.synchronize()
    assert spd_solve.launches == n0 + 1
    px = spd_solve_plain(*args, steps, torch.float64)
    tol = 1e-5 if fdt == torch.float32 else 1e-12
    assert (x - px).abs().max() <= tol * px.abs().max()


def test_wrappers_raise_on_unsupported_input(cuda):
    with pytest.raises(ValueError):
        spd_inverse(torch.zeros(2, 3, 3, device=cuda).transpose(1, 2)[:, :2])
    with pytest.raises(TypeError):
        spd_solve(torch.zeros(1, 3, 3, device=cuda, dtype=torch.float64),
                  torch.zeros(1, 3, 3, device=cuda),
                  torch.ones(1, 3, device=cuda), torch.zeros(1, 3, device=cuda),
                  torch.ones(1, 3, device=cuda))
