"""The CUDA kernels of minotaur_tpu_torch against their plain PyTorch
versions on the card, with the launch counters.  These tests need a GPU
and nvcc (a CUDA kernel has no CPU mode) and skip elsewhere.

This file imports no jax, so on a machine without it the tests run with
`python -m pytest --noconftest tests/test_torch_cuda_kernels.py -m cuda`.

Tolerances: K1 at 5e-5 (f32; the spec residual of tests/test_pallas_kkt.py)
and 1e-12 (f64) relative to max|Minv|; K2 at 1e-5 (f32 factor, the
spec of tests/test_pallas.py) and 1e-12 (f64) relative to max|x|.  The
NL path's shapes (K1 at k=1024 f64, K2 at (64, 1024) f64 refine 3) are
held to the f64 tolerances.
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


_SOLVE_INPUTS = {}


def _solve_setup(cuda, B, k):
    """(M, dinv, shift, Minv_s f32, Minv_s f64) for B lanes of order k,
    float64 on the card, made once per (B, k) from a seeded generator."""
    if (B, k) not in _SOLVE_INPUTS:
        g = torch.Generator(device=cuda).manual_seed(1000 * k + B)
        f64 = dict(dtype=torch.float64, device=cuda)
        A = torch.randn((B, k, k), generator=g, **f64)
        M = A @ A.transpose(1, 2) + k * torch.eye(k, **f64)
        dinv = 1.0 / torch.diagonal(M, dim1=1, dim2=2).sqrt()
        Ms = M * dinv[:, :, None] * dinv[:, None, :]
        shift = 1e-3 * torch.rand((B, k), generator=g, **f64)
        _SOLVE_INPUTS[(B, k)] = (M, dinv, shift, spd_inverse_plain(Ms.float())[0],
                                 spd_inverse_plain(Ms)[0])
    return _SOLVE_INPUTS[(B, k)]


F32, F64 = torch.float32, torch.float64


# k: the scalar path (1, 31, 33, 301), the 16-byte path (300, 1000), and
# 1000, whose refinement vectors at R=8 leave shared memory for the f64
# operator; dtypes (factor, operator, r, x): the three pairs, the main
# path's float32 pair with float64 r and x, and the light phase's float32
# pair with float64 r and float32 x (dtype f32)
@pytest.mark.parametrize("steps", [0, 1, 3])
@pytest.mark.parametrize("R", [1, 3, 8])
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("k", [1, 31, 33, 300, 301, 1000])
@pytest.mark.parametrize("fdt,mdt,rdt,odt", [(F32, F32, F32, F32),
                                             (F32, F64, F64, F64),
                                             (F64, F64, F64, F64),
                                             (F32, F32, F64, F64),
                                             (F32, F32, F64, F32)])
def test_spd_solve_kernel_matches_plain(cuda, steps, R, B, k, fdt, mdt, rdt,
                                        odt):
    M, dinv, shift, minv32, minv64 = _solve_setup(cuda, B, k)
    g = torch.Generator(device=cuda).manual_seed(3)
    r = torch.randn((B, k, R), generator=g, dtype=F64, device=cuda)
    args = (minv32 if fdt == F32 else minv64, M.to(mdt), dinv.to(mdt),
            shift.to(mdt), (r[:, :, 0] if R == 1 else r).to(rdt))
    n0 = spd_solve.launches
    x = spd_solve(*args, steps, odt)
    torch.cuda.synchronize()
    assert spd_solve.launches == n0 + 1
    px = spd_solve_plain(*args, steps, odt)
    assert x.dtype == odt and x.shape == px.shape
    tol = 1e-5 if fdt == F32 else 1e-12
    assert (x - px).abs().max() <= tol * px.abs().max()


def test_spd_solve_main_path_dtypes_one_launch(cuda):
    # the main path's call: float32 factors and operator, float64 r and
    # x; one wrapper call is one launch, and x comes back in float64
    M, dinv, shift, minv32, _ = _solve_setup(cuda, 64, 300)
    r = torch.randn((64, 300), dtype=F64, device=cuda)
    n0 = spd_solve.launches
    x = spd_solve(minv32, M.float(), dinv.float(), shift.float(), r, 0, F64)
    torch.cuda.synchronize()
    assert spd_solve.launches == n0 + 1
    assert x.dtype == F64 and x.shape == (64, 300)


@pytest.mark.parametrize("kernel", ["spd_inverse", "spd_solve"])
def test_nl_shapes_f64(cuda, kernel):
    """The NL path's shapes (normcon(1024) at B=64): every factorization
    float64, every solve refined 3 rounds.  K1 at (64, 1024, 1024), whose
    f64 panel lives in the global buffer; K2 at (64, 1024) refine 3."""
    B, k = 64, 1024
    if kernel == "spd_inverse":
        g = torch.Generator(device=cuda).manual_seed(5)
        A = torch.randn((B, k, k), generator=g, dtype=F64, device=cuda)
        ms = A @ A.transpose(1, 2) / k + 2.0 * torch.eye(k, dtype=F64,
                                                         device=cuda)
        del A
        n0 = spd_inverse.launches
        minv, flag = spd_inverse(ms)
        torch.cuda.synchronize()
        assert spd_inverse.launches == n0 + 1
        pminv, pflag = spd_inverse_plain(ms)
        assert torch.equal(flag, pflag) and bool((flag == 0).all())
        assert (minv - pminv).abs().max() <= 1e-12 * pminv.abs().max()
    else:
        M, dinv, shift, _, minv64 = _solve_setup(cuda, B, k)
        r = torch.randn((B, k), dtype=F64, device=cuda)
        n0 = spd_solve.launches
        x = spd_solve(minv64, M, dinv, shift, r, 3, F64)
        torch.cuda.synchronize()
        assert spd_solve.launches == n0 + 1
        px = spd_solve_plain(minv64, M, dinv, shift, r, 3, F64)
        assert (x - px).abs().max() <= 1e-12 * px.abs().max()
        _SOLVE_INPUTS.pop((B, k))


def test_wrappers_raise_on_unsupported_input(cuda):
    with pytest.raises(ValueError):
        spd_inverse(torch.zeros(2, 3, 3, device=cuda).transpose(1, 2)[:, :2])
    with pytest.raises(TypeError):
        spd_solve(torch.zeros(1, 3, 3, device=cuda, dtype=torch.float64),
                  torch.zeros(1, 3, 3, device=cuda),
                  torch.ones(1, 3, device=cuda), torch.zeros(1, 3, device=cuda),
                  torch.ones(1, 3, device=cuda))
