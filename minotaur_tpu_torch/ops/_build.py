"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled at first use, one `nvcc` process per
source, all started together, and linked into a shared library with a
plain C interface under
`minotaur_tpu_torch/_build/`, and loaded with ctypes.  The library name
carries a hash of the sources, so an edited kernel is rebuilt and an
unchanged one is loaded as it is.  No PyTorch header is included: a
build takes seconds, not minutes.

Nothing here runs at import time; `load_library()` is called by the
kernel wrappers when they are first given a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "minotaur_tpu_torch are built from csrc/ at first use")


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libminotaur_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile csrc/*.cu if the hashed library is missing; returns its
    path.  The library is written under a temporary name and renamed, so
    a concurrent or interrupted build never leaves a half-written file."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    cu = [p for p in _sources() if p.endswith(".cu")]
    t0 = time.monotonic()
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    objs = [f"{tmp}.{i}.o" for i in range(len(cu))]
    try:
        nvcc = _nvcc()
        jobs = []
        for src, obj in zip(cu, objs):
            cmd = [nvcc] + NVCC_FLAGS + ["-I", CSRC, "-c", "-o", obj, src]
            jobs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, proc in jobs:          # wait for every compile
            out_s, err_s = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out_s}\n{err_s}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        cmd = [nvcc, "-shared", "-o", tmp] + objs
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for path in objs + [tmp]:
            if os.path.exists(path):
                os.remove(path)
    build_seconds = time.monotonic() - t0
    return out


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for suffix in ("f32", "f64"):
        fn = getattr(lib, f"mt_spd_inverse_{suffix}")
        # (ms, out, xbuf, wbuf, fail, flag, B, k, cluster, stream)
        fn.argtypes = [p] * 6 + [i, i, i, p]
        fn.restype = i
    # (B, k, itemsize, cluster) -> elements per lane of the global panel
    # buffer
    lib.mt_spd_inverse_wbuf_elems.argtypes = [i] * 4
    lib.mt_spd_inverse_wbuf_elems.restype = ctypes.c_longlong
    # (B, k) -> the design: 1 (one CTA a lane) or the cluster size
    lib.mt_spd_inverse_design.argtypes = [i, i]
    lib.mt_spd_inverse_design.restype = i
    # factor, operator, r and x dtypes
    for suffix in ("f32_f32_f32_f32", "f32_f32_f32_f64", "f32_f32_f64_f32",
                   "f32_f32_f64_f64", "f32_f64_f64_f64", "f64_f64_f64_f64"):
        fn = getattr(lib, f"mt_spd_solve_{suffix}")
        # (minv, m_op, dinv, shift, r, x, scratch, B, k, R, refine_steps,
        #  cluster, stream, design: int * written with the design taken)
        fn.argtypes = [p] * 7 + [i, i, i, i, i, p, ctypes.POINTER(i)]
        fn.restype = i
    # (k, R, factor itemsize, operator itemsize, refine_steps) -> bytes of
    # global scratch per lane
    lib.mt_spd_solve_scratch_bytes.argtypes = [i] * 5
    lib.mt_spd_solve_scratch_bytes.restype = ctypes.c_longlong
    # (B, k, R, factor itemsize, operator itemsize, refine_steps) -> the
    # design: 0 (refine 0, the row-block grid), 1 (one CTA a lane) or the
    # cluster size
    lib.mt_spd_solve_design.argtypes = [i] * 6
    lib.mt_spd_solve_design.restype = i


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        _declare(lib)
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a non-zero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
