"""Device and dtype policy of the port.

- The device is always named by the caller (`torch.device`); the default
  is "cuda", and asking for CUDA on a machine without it raises.
- State and certificates are float64; factors are float32 (the JAX
  package's "mixed" policy).  The port never changes torch's global
  default dtype: every tensor is created with its dtype.
- float32 products whose results feed accuracy-critical arithmetic ran
  at `Precision.HIGHEST` in the JAX package, so on CUDA the IPM refuses
  to run with TF32 matmuls enabled (`check_fp32_matmul`).
- Each CUDA kernel wrapper counts its launches in a plain integer
  attribute (`spd_inverse.launches`, `spd_solve.launches`);
  `reset_launches` / `launch_counts` read and clear them together.
"""

from __future__ import annotations

from typing import Dict, Union

import torch

F64 = torch.float64
F32 = torch.float32

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def check_fp32_matmul(device: torch.device) -> None:
    """Refuse TF32 on CUDA: the f32 Gram assembly and the split-f32
    matvecs need full float32 products (about 7 digits, not TF32's 3)."""
    if device.type != "cuda":
        return
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "TF32 matmuls are enabled (torch.backends.cuda.matmul."
            "allow_tf32 / torch.set_float32_matmul_precision); the IPM "
            "needs full float32 products")


def _kernel_wrappers():
    from .ops.spd_inverse import spd_inverse
    from .ops.spd_solve import spd_solve
    return {"spd_inverse": spd_inverse, "spd_solve": spd_solve}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """Launch count of every kernel wrapper, by kernel name."""
    return {name: int(fn.launches)
            for name, fn in _kernel_wrappers().items()}
