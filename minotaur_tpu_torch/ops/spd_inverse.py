"""K1: batched SPD factorize + explicit inverse.

Port of the TPU kernel minotaur_tpu/ops/pallas_kkt.py:_build_factor_inv
(reached through `batched_spd_inverse`).  For a batch of Jacobi-scaled SPD
matrices `ms (B, k, k)` it returns `(minv, flag)`: the inverse
`Linv' Linv`, and a per-lane flag that is 0 for a clean factorization and
2 for a failed one (non-positive or non-finite pivot, or a non-finite
inverse), in which case the lane's `minv` is the identity.

`spd_inverse` dispatches on the tensor's device: a CPU tensor goes to the
plain PyTorch version `spd_inverse_plain`; a CUDA tensor goes to the CUDA
kernel `csrc/spd_inverse.cu` (float32 or float64 instantiation) and
nothing else.  `spd_inverse.launches` counts calls that launched it.

The kernel is three launches on the current stream.  A: one CTA per
lane runs the blocked right-looking Cholesky with 32-column panels, with
the forward substitution of L X = I carried along in each panel's
rank-32 update (two warps factor and invert the next 32x32 diagonal block
ahead while the others update; the panel sits in shared memory), so it
writes Linv.  B: `Linv' Linv` on a grid of lower-triangle 64x64 tiles
times lanes, which fills the card.  C: the flag, and the identity for
failed lanes.  Panel width 32 is one warp's width: the diagonal factor
needs no block barrier, and the 32 x k panel fits shared memory up to
k = 1664 (f32) or 736 (f64).  Stage A is bound by its chain of k/32
dependent panel steps and by the FMA rate of one SM per lane, not by
the card's flops or bytes (the bound is in the source's note).
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

_MAX_K = 16384


def spd_inverse_plain(ms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel's algorithm: cholesky_ex, the
    triangular inverse Linv, then Minv = Linv' Linv, with the kernel's
    identity-plus-flag semantics for failed lanes.  (Linv' Linv is the
    TPU kernel's formulation too.  On intquad(300) sub-boxes under the f64
    policy, an inverse from cholesky_solve(I) or cholesky_inverse left
    5-6 of 64 IPM lanes stalled at the iteration limit; Linv' Linv
    converged all 64.)"""
    B, k = ms.shape[0], ms.shape[-1]
    eye = torch.eye(k, dtype=ms.dtype, device=ms.device)
    L, info = torch.linalg.cholesky_ex(ms)
    bad = (info != 0) | ~torch.isfinite(L).all(dim=(1, 2))
    # a failed lane's partial factor is replaced before the inverse so
    # no garbage (or a singular triangle) reaches the triangular solve
    L = torch.where(bad[:, None, None], eye, L)
    linv = torch.linalg.solve_triangular(L, eye.expand(B, k, k), upper=False)
    minv = torch.matmul(linv.transpose(1, 2), linv)
    bad = bad | ~torch.isfinite(minv).all(dim=(1, 2))
    minv = torch.where(bad[:, None, None], eye, minv)
    flag = torch.where(bad, 2.0, 0.0).to(ms.dtype)
    return minv, flag


def _check(ms: torch.Tensor) -> None:
    if ms.dim() != 3 or ms.shape[1] != ms.shape[2]:
        raise ValueError(f"spd_inverse: expected (B, k, k), got {tuple(ms.shape)}")
    if ms.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"spd_inverse: float32/float64 only, got {ms.dtype}")
    if not ms.is_contiguous():
        raise ValueError("spd_inverse: input must be contiguous")
    if ms.shape[1] > _MAX_K:
        raise ValueError(f"spd_inverse: k={ms.shape[1]} > {_MAX_K}")


def spd_inverse_cuda(ms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on `ms` (a CUDA tensor)."""
    _check(ms)
    if ms.device.type != "cuda":
        raise ValueError("spd_inverse_cuda: tensor is not on a CUDA device")
    lib = _build.load_library()
    B, k = ms.shape[0], ms.shape[1]
    out = torch.empty_like(ms)
    flag = torch.empty(B, dtype=ms.dtype, device=ms.device)
    if B == 0:
        return out, flag
    fn = lib.mt_spd_inverse_f32 if ms.dtype == torch.float32 \
        else lib.mt_spd_inverse_f64
    with torch.cuda.device(ms.device):
        # scratch: the trailing matrix and R, then Linv; one fail word per
        # lane; the panel buffer only for lanes too large for shared memory
        n = lib.mt_spd_inverse_wbuf_elems(k, ms.element_size())
        if n < 0:
            _build.check(-n, "spd_inverse device query")
        xbuf = torch.empty_like(ms)
        fail = torch.empty(B, dtype=torch.int32, device=ms.device)
        wbuf = torch.empty(B * n, dtype=ms.dtype, device=ms.device) if n else None
        stream = torch.cuda.current_stream(ms.device).cuda_stream
        err = fn(ms.data_ptr(), out.data_ptr(), xbuf.data_ptr(),
                 None if wbuf is None else wbuf.data_ptr(), fail.data_ptr(),
                 flag.data_ptr(), B, k, stream)
    _build.check(err, "spd_inverse kernel launch")
    spd_inverse.launches += 1
    return out, flag


def spd_inverse(ms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, k, k) SPD -> (Minv (B, k, k), flag (B,)), same dtype as `ms`."""
    if ms.device.type == "cuda":
        return spd_inverse_cuda(ms)
    if ms.device.type != "cpu":
        raise ValueError(f"spd_inverse: unsupported device {ms.device}")
    _check(ms)
    return spd_inverse_plain(ms)


spd_inverse.launches = 0
