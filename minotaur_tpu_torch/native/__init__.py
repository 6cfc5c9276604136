"""The C++ node store (treestore.cpp), bound via ctypes.

Port of minotaur_tpu/native/__init__.py.  `treestore.cpp` is the JAX
package's file as it is.  The shared library is built with g++ at first
use into `minotaur_tpu_torch/_build/` (not next to the sources), under a
name that carries a hash of the source, and written under a temporary
name and renamed, so concurrent builds never load a half-written file.
Where the JAX loader returns None on a failed build (and its driver
falls back to the Python heap), this one raises with the compiler's
message: a default run must not quietly change its node store.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "treestore.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None

#: scalar record layout (must match treestore.cpp kScalars block)
SCAL_NID, SCAL_DEPTH, SCAL_LB, SCAL_BVAR, SCAL_BDIR, SCAL_BFRAC, \
    SCAL_VIO, SCAL_PRED_ITERS, SCAL_TB, SCAL_HAS_X, SCAL_HAS_Y = range(11)
N_SCALARS = 11


def library_path() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libtreestore_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile treestore.cpp if the hashed library is missing; returns
    its path.  Raises RuntimeError with g++'s output on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++"] + CXX_FLAGS + [_SRC, "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"native treestore: cannot run g++ ({e})")
        if proc.returncode != 0:
            raise RuntimeError(
                f"native treestore: g++ failed ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native library once per process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    lib.treestore_scalars.restype = ctypes.c_int64
    if lib.treestore_scalars() != N_SCALARS:
        raise RuntimeError("native treestore: scalar layout mismatch")
    c_dp = ctypes.POINTER(ctypes.c_double)
    lib.treestore_create.restype = ctypes.c_void_p
    lib.treestore_create.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int]
    lib.treestore_destroy.argtypes = [ctypes.c_void_p]
    lib.treestore_push.argtypes = [ctypes.c_void_p, c_dp, c_dp, c_dp,
                                   c_dp, c_dp]
    lib.treestore_push_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, c_dp, c_dp, c_dp, c_dp, c_dp]
    lib.treestore_pop_batch.restype = ctypes.c_int64
    lib.treestore_pop_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_double, c_dp, c_dp,
        c_dp, c_dp, c_dp, ctypes.POINTER(ctypes.c_int64)]
    lib.treestore_prune.restype = ctypes.c_int64
    lib.treestore_prune.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.treestore_best_lb.restype = ctypes.c_double
    lib.treestore_best_lb.argtypes = [ctypes.c_void_p]
    lib.treestore_size.restype = ctypes.c_int64
    lib.treestore_size.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeTreeStore:
    """ctypes wrapper over the C++ slab store.  Nodes live as rows of
    contiguous (scalars, vlb, vub, warm_x, warm_y) arrays; batch pops
    return dense slabs ready for the device superstep."""

    def __init__(self, n: int, m: int = 0, order: int = 2):
        lib = load_library()
        self._lib = lib
        self._h = ctypes.c_void_p(lib.treestore_create(n, m, order))
        self.n = n
        self.m = m

    def __del__(self):  # pragma: no cover
        try:
            if getattr(self, "_h", None):
                self._lib.treestore_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def push(self, scal: np.ndarray, vlb: np.ndarray, vub: np.ndarray,
             warm_x: Optional[np.ndarray] = None,
             warm_y: Optional[np.ndarray] = None) -> None:
        scal = np.ascontiguousarray(scal, dtype=np.float64)
        assert scal.shape == (N_SCALARS,)
        vlb = np.ascontiguousarray(vlb, dtype=np.float64)
        vub = np.ascontiguousarray(vub, dtype=np.float64)
        wx = np.ascontiguousarray(warm_x, dtype=np.float64) \
            if warm_x is not None else np.zeros(self.n)
        wy = np.ascontiguousarray(warm_y, dtype=np.float64) \
            if warm_y is not None else np.zeros(max(self.m, 1))
        self._lib.treestore_push(self._h, _dp(scal), _dp(vlb), _dp(vub),
                                 _dp(wx), _dp(wy))

    def push_batch(self, scal: np.ndarray, vlb: np.ndarray,
                   vub: np.ndarray, warm_x: np.ndarray,
                   warm_y: np.ndarray) -> None:
        k = scal.shape[0]
        scal = np.ascontiguousarray(scal, dtype=np.float64)
        vlb = np.ascontiguousarray(vlb, dtype=np.float64)
        vub = np.ascontiguousarray(vub, dtype=np.float64)
        warm_x = np.ascontiguousarray(warm_x, dtype=np.float64)
        warm_y = np.ascontiguousarray(warm_y, dtype=np.float64)
        self._lib.treestore_push_batch(self._h, k, _dp(scal), _dp(vlb),
                                       _dp(vub), _dp(warm_x), _dp(warm_y))

    def pop_batch(self, k: int, cutoff: float = 1e300):
        """-> (got, pruned, scal, vlb, vub, warm_x, warm_y) slabs."""
        n, m = self.n, max(self.m, 1)
        scal = np.empty((k, N_SCALARS))
        vlb = np.empty((k, n))
        vub = np.empty((k, n))
        wx = np.empty((k, n))
        wy = np.empty((k, m))
        pruned = ctypes.c_int64(0)
        got = self._lib.treestore_pop_batch(
            self._h, k, cutoff, _dp(scal), _dp(vlb), _dp(vub), _dp(wx),
            _dp(wy), ctypes.byref(pruned))
        return (got, pruned.value, scal[:got], vlb[:got], vub[:got],
                wx[:got], wy[:got])

    def prune(self, cutoff: float) -> int:
        return int(self._lib.treestore_prune(self._h, cutoff))

    def best_lb(self) -> float:
        v = float(self._lib.treestore_best_lb(self._h))
        return float("inf") if v >= 1e299 else v

    def __len__(self) -> int:
        return int(self._lib.treestore_size(self._h))
