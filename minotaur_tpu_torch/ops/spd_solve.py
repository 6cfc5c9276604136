"""K2: batched scaled-inverse solve with monotone refinement.

Port of the TPU kernel minotaur_tpu/ops/pallas_kernels.py
(`refined_spd_solve_f32`, kernel body `_build_kernel`), whose math the
JAX IPM runs as XLA ops in engines/ipm.py::_make_spd_solver.solve_xla:

    x = dinv * (Minv_s @ (dinv * r))
    refine_steps times, keeping a round only if ||res||^2 drops:
        res = r - (M @ x + shift * x);  x' = x + dinv * (Minv_s @ (dinv * res))

One call serves every right-hand side of a factorization: `r` is
(B, k) or (B, k, R), and the monotone test uses ONE norm per lane over
all R columns.  `minv_s` is in the factor dtype (float32 or float64);
`m_op`, `dinv`, `shift` and `r` are in the operator dtype, in which the
refinement runs; the result is cast to `out_dtype`.

`spd_solve` dispatches on the tensor's device: CPU tensors go to the
plain PyTorch version `spd_solve_plain`; CUDA tensors go to the CUDA
kernel `csrc/spd_solve.cu` and nothing else.  `spd_solve.launches`
counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build

_KERNELS = {
    (torch.float32, torch.float32): "mt_spd_solve_f32_f32",
    (torch.float32, torch.float64): "mt_spd_solve_f32_f64",
    (torch.float64, torch.float64): "mt_spd_solve_f64_f64",
}


def spd_solve_plain(minv_s, m_op, dinv, shift, r, refine_steps: int,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain PyTorch version (the batched solve_xla math)."""
    md = m_op.dtype
    vec = r.dim() == 2
    rr = (r[:, :, None] if vec else r).to(md)
    dv = dinv.to(md)[:, :, None]

    def base_solve(v):
        u = (v * dv).to(minv_s.dtype)
        return torch.matmul(minv_s, u).to(md) * dv

    def apply_eff(v):
        return torch.matmul(m_op, v) + shift.to(md)[:, :, None] * v

    x = base_solve(rr)
    if refine_steps > 0:
        res = rr - apply_eff(x)
        nrm = (res * res).sum(dim=(1, 2))
        for _ in range(refine_steps):
            x2 = x + base_solve(res)
            res2 = rr - apply_eff(x2)
            nrm2 = (res2 * res2).sum(dim=(1, 2))
            better = (nrm2 < nrm)[:, None, None]
            x = torch.where(better, x2, x)
            res = torch.where(better, res2, res)
            nrm = torch.minimum(nrm2, nrm)
    x = x.to(out_dtype or md)
    return x[:, :, 0] if vec else x


def _shapes(minv_s, m_op, dinv, shift, r):
    if minv_s.dim() != 3 or minv_s.shape[1] != minv_s.shape[2]:
        raise ValueError(f"spd_solve: minv_s must be (B, k, k), got "
                         f"{tuple(minv_s.shape)}")
    B, k = minv_s.shape[0], minv_s.shape[1]
    if tuple(m_op.shape) != (B, k, k):
        raise ValueError(f"spd_solve: m_op must be {(B, k, k)}")
    for name, v in (("dinv", dinv), ("shift", shift)):
        if tuple(v.shape) != (B, k):
            raise ValueError(f"spd_solve: {name} must be {(B, k)}")
    if r.dim() not in (2, 3) or tuple(r.shape[:2]) != (B, k):
        raise ValueError(f"spd_solve: r must be (B, k) or (B, k, R), got "
                         f"{tuple(r.shape)}")


def spd_solve_cuda(minv_s, m_op, dinv, shift, r, refine_steps: int,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the CUDA kernel (all operands CUDA tensors)."""
    _shapes(minv_s, m_op, dinv, shift, r)
    md = m_op.dtype
    name = _KERNELS.get((minv_s.dtype, md))
    if name is None:
        raise TypeError(f"spd_solve: no kernel for factor {minv_s.dtype} / "
                        f"operator {md}")
    dev = minv_s.device
    for t in (minv_s, m_op, dinv, shift, r):
        if t.device != dev or dev.type != "cuda":
            raise ValueError("spd_solve_cuda: all operands must be on one "
                             "CUDA device")
    if not (minv_s.is_contiguous() and m_op.is_contiguous()):
        raise ValueError("spd_solve: minv_s and m_op must be contiguous")
    if refine_steps < 0:
        raise ValueError("spd_solve: refine_steps must be >= 0")
    vec = r.dim() == 2
    B, k = minv_s.shape[0], minv_s.shape[1]
    R = 1 if vec else r.shape[2]
    # small (B, k[, R]) vectors: converting them here is the cast that
    # base_solve applies (rr.astype(M.dtype), dinv.astype(M.dtype))
    rr = r.to(md).reshape(B, k, R).contiguous()
    dv = dinv.to(md).contiguous()
    sh = shift.to(md).contiguous()
    x = torch.empty((B, k, R), dtype=md, device=dev)
    if B and R:
        lib = _build.load_library()
        res = torch.empty_like(x)
        x2 = torch.empty_like(x)
        res2 = torch.empty_like(x)
        u = torch.empty((B, k, R), dtype=minv_s.dtype, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = getattr(lib, name)(
                minv_s.data_ptr(), m_op.data_ptr(), dv.data_ptr(),
                sh.data_ptr(), rr.data_ptr(), x.data_ptr(), res.data_ptr(),
                x2.data_ptr(), res2.data_ptr(), u.data_ptr(), B, k, R,
                int(refine_steps), stream)
        _build.check(err, "spd_solve kernel launch")
        spd_solve.launches += 1
    x = x.to(out_dtype or md)
    return x[:, :, 0] if vec else x


def spd_solve(minv_s, m_op, dinv, shift, r, refine_steps: int = 0,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Solve M x = r for every lane through the scaled explicit inverse."""
    if minv_s.device.type == "cuda":
        return spd_solve_cuda(minv_s, m_op, dinv, shift, r, refine_steps,
                              out_dtype)
    if minv_s.device.type != "cpu":
        raise ValueError(f"spd_solve: unsupported device {minv_s.device}")
    _shapes(minv_s, m_op, dinv, shift, r)
    return spd_solve_plain(minv_s, m_op, dinv, shift, r, refine_steps,
                           out_dtype)


spd_solve.launches = 0
