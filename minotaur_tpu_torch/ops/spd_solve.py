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
`m_op`, `dinv` and `shift` are in the operator dtype, in which the
refinement runs; `r` is taken to the operator dtype and the result to
`out_dtype`.

`spd_solve` dispatches on the tensor's device: CPU tensors go to the
plain PyTorch version `spd_solve_plain`; CUDA tensors go to the CUDA
kernel `csrc/spd_solve.cuh` and nothing else.  `spd_solve.launches`
counts calls that launched it (one kernel per call).  At refine 0 the
kernel runs a grid of 32-row blocks times lanes (every main-path call).
With refinement the C launcher picks one of two designs from (B, k)
(`spd_solve_design` reports it): one CTA a lane, or, from k = 256, a
thread-block cluster of C CTAs a lane (C = 2 at B = 64, 4 at B = 16),
each CTA on its own SM streaming a block of rows in loads of 8 bytes or
more (float32 rows in pairs from their first 8-byte boundary, at odd k
too), the slices of each new vector copied between them through
distributed shared memory.  Both are bound by the bytes of Minv_s and M
streamed from HBM, by B or B * C SMs; both sum every row and the
monotone test's norm in one order, so they return the same bits.  A
cluster that cannot be placed raises; nothing falls back.  Float64 `r`
and a float64 result are read and written by the kernel itself, so the
IPM's mixed policy (float32 operator, float64 vectors) runs no cast
kernels around the call.

Each call is a `k2` span (utils/trace.py) with two counts: `refining`,
1 where refine_steps > 0, and `cluster`, 1 where the launcher took a
cluster design (it reports the design it took; 0 on the CPU).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..utils import trace
from . import _build

# (factor, operator) dtype pairs with a kernel; r and x may each be in the
# operator dtype or float64 (the kernel converts at the load and the store)
_PAIRS = ((torch.float32, torch.float32), (torch.float32, torch.float64),
          (torch.float64, torch.float64))
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# the `cluster` argument: 0 the launcher's pick, 1 one CTA a lane, or one
# of the cluster sizes the launcher picks (csrc: kMaxClusterS)
CLUSTER_ARGS = (0, 1, 2, 4)


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
    s = minv_s.shape
    if len(s) != 3 or s[1] != s[2]:
        raise ValueError(f"spd_solve: minv_s must be (B, k, k), got {tuple(s)}")
    if m_op.shape != s:
        raise ValueError(f"spd_solve: m_op must be {tuple(s)}")
    if dinv.shape != s[:2] or shift.shape != s[:2]:
        raise ValueError(f"spd_solve: dinv and shift must be {tuple(s[:2])}")
    if r.dim() not in (2, 3) or r.shape[:2] != s[:2]:
        raise ValueError(f"spd_solve: r must be (B, k) or (B, k, R), got "
                         f"{tuple(r.shape)}")


def spd_solve_cuda(minv_s, m_op, dinv, shift, r, refine_steps: int,
                   out_dtype: Optional[torch.dtype] = None,
                   cluster: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel (all operands CUDA tensors).  `cluster` picks
    the design of a refining call: 0 the launcher's own choice
    (`spd_solve_design`), 1 one CTA a lane, 2 or 4 a cluster of that many
    CTAs a lane, the sizes the launcher picks (refine 0 always takes the
    row-block grid).  A cluster that cannot be placed on the card raises."""
    return _solve_cuda(minv_s, m_op, dinv, shift, r, refine_steps,
                       out_dtype, cluster)[0]


def _solve_cuda(minv_s, m_op, dinv, shift, r, refine_steps: int,
                out_dtype: Optional[torch.dtype],
                cluster: int) -> Tuple[torch.Tensor, int]:
    """spd_solve_cuda, and the design the launcher took (0: refine 0 or
    no launch, 1: one CTA a lane, else the cluster size)."""
    _shapes(minv_s, m_op, dinv, shift, r)
    md = m_op.dtype
    if (minv_s.dtype, md) not in _PAIRS:
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
    if cluster not in CLUSTER_ARGS:
        raise ValueError(f"spd_solve: cluster {cluster} not in "
                         f"{CLUSTER_ARGS}")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _solve_cuda(minv_s, m_op, dinv, shift, r, refine_steps,
                               out_dtype, cluster)
    B, k = minv_s.shape[0], minv_s.shape[1]
    R = 1 if r.dim() == 2 else r.shape[2]
    od = out_dtype or md
    # r and x keep their dtype where the kernel has it (the operator's or
    # float64): it takes r to the operator dtype at the load and x to od
    # at the store, the casts of base_solve, with no cast kernels around
    rr = (r if r.dtype in (md, torch.float64) else r.to(md)).contiguous()
    xd = od if od in (md, torch.float64) else md
    dv = (dinv if dinv.dtype == md else dinv.to(md)).contiguous()
    sh = (shift if shift.dtype == md else shift.to(md)).contiguous()
    x = torch.empty(r.shape, dtype=xd, device=dev)
    design = ctypes.c_int(0)
    if B and k and R:
        lib = _build.load_library()
        fn = getattr(lib, "mt_spd_solve_" + "_".join(
            _SUFFIX[t] for t in (minv_s.dtype, md, rr.dtype, xd)))
        scratch = None
        if refine_steps:
            # a global buffer only where a lane's refinement vectors do
            # not fit shared memory (the C module decides)
            n = lib.mt_spd_solve_scratch_bytes(
                k, R, minv_s.element_size(), m_op.element_size(),
                int(refine_steps))
            if n < 0:
                _build.check(-n, "spd_solve device query")
            if n:
                scratch = torch.empty(B * n, dtype=torch.uint8, device=dev)
        err = fn(minv_s.data_ptr(), m_op.data_ptr(), dv.data_ptr(),
                 sh.data_ptr(), rr.data_ptr(), x.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B, k, R,
                 int(refine_steps), int(cluster),
                 torch.cuda.current_stream().cuda_stream,
                 ctypes.byref(design))
        _build.check(err, "spd_solve kernel launch")
        spd_solve.launches += 1
    return (x if xd == od else x.to(od)), design.value


def spd_solve_design(B: int, k: int, R: int, factor_dtype, operator_dtype,
                     refine_steps: int, device=None) -> int:
    """The design the launcher picks for a call on a CUDA device: 0 at
    refine 0 (the row-block grid), 1 one CTA a lane, else the cluster
    size."""
    lib = _build.load_library()
    sizes = [torch.empty((), dtype=d).element_size()
             for d in (factor_dtype, operator_dtype)]
    with torch.cuda.device(device if device is not None else
                           torch.cuda.current_device()):
        c = lib.mt_spd_solve_design(B, k, R, *sizes, int(refine_steps))
    if c < 0:
        _build.check(-c, "spd_solve device query")
    return c


def spd_solve(minv_s, m_op, dinv, shift, r, refine_steps: int = 0,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Solve M x = r for every lane through the scaled explicit inverse."""
    with trace.span("k2", refining=int(refine_steps > 0), cluster=0):
        if minv_s.device.type == "cuda":
            x, design = _solve_cuda(minv_s, m_op, dinv, shift, r,
                                    refine_steps, out_dtype, 0)
            if design > 1:
                trace.count("cluster", 1)
            return x
        if minv_s.device.type != "cpu":
            raise ValueError(
                f"spd_solve: unsupported device {minv_s.device}")
        _shapes(minv_s, m_op, dinv, shift, r)
        return spd_solve_plain(minv_s, m_op, dinv, shift, r, refine_steps,
                               out_dtype)


spd_solve.launches = 0
