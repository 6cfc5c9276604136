"""K1: batched SPD factorize + explicit inverse.

Port of the TPU kernel minotaur_tpu/ops/pallas_kkt.py:_build_factor_inv
(reached through `batched_spd_inverse`).  For a batch of Jacobi-scaled SPD
matrices `ms (B, k, k)` it returns `(minv, flag)`: the inverse
`Linv' Linv`, and a per-lane flag that is 0 for a clean factorization and
2 for a failed one (non-positive or non-finite pivot, or a non-finite
inverse), in which case the lane's `minv` is the identity.

`spd_inverse` dispatches on the tensor's device: a CPU tensor goes to the
plain PyTorch version `spd_inverse_plain`; a CUDA tensor goes to the CUDA
kernel `csrc/spd_inverse.cuh` (float32 or float64 instantiation) and
nothing else.  `spd_inverse.launches` counts calls that launched it.
Each call is a `k1` span (utils/trace.py).

The kernel is three launches on the current stream.  A: the blocked
right-looking Cholesky with 32-column panels, with the forward
substitution of L X = I carried along in each panel's rank-32 update (two
warps factor and invert the next 32x32 diagonal block ahead while the
others update), so it writes Linv.  B: `Linv' Linv` on a grid of
lower-triangle 64x64 tiles times lanes, which fills the card.  C: the
flag, and the identity for failed lanes.

Stage A has two designs, and the C launcher picks one from (B, k)
(`spd_inverse_design` reports it): one CTA a lane below k = 384 or above
66 lanes (the main path's (64, 300)), else a thread-block cluster of C
CTAs a lane, C = 2 at B = 64 and 4 at B <= 33, whose CTAs split each
panel's substitution and update and read the panel from each other's
shared memory.  One CTA a lane is bound by the chain of k/32 panel steps
on B SMs; the cluster spreads that chain over B * C SMs, at a copy of the
panel through distributed shared memory per step that grows with C.  Both
round exactly alike (the same operations on every entry in the same
order), so they return the same bits.  A cluster that cannot be placed
raises; nothing falls back to the other design or to the plain version.
The 32 x k panel sits in shared memory up to k = 1664 (f32) or 736 (f64),
beyond that in a global buffer.  The bound is in the source's note.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import trace
from . import _build

_MAX_K = 16384
# the `cluster` argument: 0 the launcher's pick, 1 one CTA a lane, or one
# of the cluster sizes the launcher picks (csrc: kMaxClusterA)
CLUSTER_ARGS = (0, 1, 2, 4)


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


def spd_inverse_cuda(ms: torch.Tensor,
                     cluster: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on `ms` (a CUDA tensor).  `cluster` picks
    stage A's design: 0 the launcher's own choice (`spd_inverse_design`),
    1 one CTA a lane, 2 or 4 a cluster of that many CTAs a lane, the sizes
    the launcher picks.  A cluster that cannot be placed on the card
    raises."""
    _check(ms)
    if ms.device.type != "cuda":
        raise ValueError("spd_inverse_cuda: tensor is not on a CUDA device")
    if cluster not in CLUSTER_ARGS:
        raise ValueError(f"spd_inverse: cluster {cluster} not in "
                         f"{CLUSTER_ARGS}")
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
        n = lib.mt_spd_inverse_wbuf_elems(B, k, ms.element_size(), cluster)
        if n < 0:
            _build.check(-n, "spd_inverse device query")
        xbuf = torch.empty_like(ms)
        fail = torch.empty(B, dtype=torch.int32, device=ms.device)
        wbuf = torch.empty(B * n, dtype=ms.dtype, device=ms.device) if n else None
        stream = torch.cuda.current_stream(ms.device).cuda_stream
        err = fn(ms.data_ptr(), out.data_ptr(), xbuf.data_ptr(),
                 None if wbuf is None else wbuf.data_ptr(), fail.data_ptr(),
                 flag.data_ptr(), B, k, cluster, stream)
    _build.check(err, "spd_inverse kernel launch")
    spd_inverse.launches += 1
    return out, flag


def spd_inverse_design(B: int, k: int, device=None) -> int:
    """Stage A's design for B lanes of order k on a CUDA device: 1 (one CTA
    a lane) or the cluster size, as the launcher picks it."""
    lib = _build.load_library()
    with torch.cuda.device(device if device is not None else
                           torch.cuda.current_device()):
        c = lib.mt_spd_inverse_design(B, k)
    if c < 0:
        _build.check(-c, "spd_inverse device query")
    return c


def spd_inverse(ms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, k, k) SPD -> (Minv (B, k, k), flag (B,)), same dtype as `ms`."""
    with trace.span("k1"):
        if ms.device.type == "cuda":
            return spd_inverse_cuda(ms)
        if ms.device.type != "cpu":
            raise ValueError(f"spd_inverse: unsupported device {ms.device}")
        _check(ms)
        return spd_inverse_plain(ms)


spd_inverse.launches = 0
