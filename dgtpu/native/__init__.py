"""ctypes loader for the native C++ relaxation kernels.

Compiles ``relaxation.cpp`` with g++ on first use (cached as ``librelax.so``
next to the source).  Returns None gracefully when no toolchain is present —
all callers fall back to the XLA kernels.
"""

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


def _build():
    src = os.path.join(_HERE, "relaxation.cpp")
    out = os.path.join(_HERE, "librelax.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    # build under a private name and rename into place: processes that
    # build at once (parallel test workers) never load a half-written file
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load():
    """Load (and lazily build) the native library; None if unavailable."""
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(_build())
    except Exception:
        return None
    dp = ctypes.POINTER(ctypes.c_double)
    ip = ctypes.POINTER(ctypes.c_int32)
    up = ctypes.POINTER(ctypes.c_uint8)
    lib.stencil_matvec.argtypes = [dp, ip, up, ctypes.c_int64, ctypes.c_int64,
                                   dp, dp]
    lib.block_gauss_seidel_sweep.argtypes = [dp, ip, up, dp, ctypes.c_int64,
                                             ctypes.c_int64, dp, dp,
                                             ctypes.c_int, ctypes.c_double]
    lib.block_jacobi_sweep.argtypes = [dp, ip, up, dp, ctypes.c_int64,
                                       ctypes.c_int64, dp, dp, ctypes.c_double]
    _LIB = lib
    return _LIB


def _as(arr, dtype):
    return np.ascontiguousarray(np.asarray(arr), dtype=dtype)


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


class NativeStencil:
    """Host-side stencil kernels over a StencilOperator's arrays."""

    def __init__(self, op):
        lib = load()
        if lib is None:
            raise RuntimeError("native kernels unavailable (no g++?)")
        self.lib = lib
        self.blocks = _as(op.blocks, np.float64)
        self.nbr = _as(op.nbr, np.int32)
        self.mask = _as(op.mask, np.uint8)
        self.n, _, self.b, _ = self.blocks.shape
        self.dinv = np.linalg.inv(self.blocks[:, 0]).copy()

    def matvec(self, x):
        x = _as(x, np.float64)
        y = np.empty_like(x)
        self.lib.stencil_matvec(
            _ptr(self.blocks, ctypes.c_double), _ptr(self.nbr, ctypes.c_int32),
            _ptr(self.mask, ctypes.c_uint8), self.n, self.b,
            _ptr(x, ctypes.c_double), _ptr(y, ctypes.c_double))
        return y

    def gauss_seidel(self, rhs, x, direction="symmetric", iterations=1, omega=1.0):
        rhs = _as(rhs, np.float64)
        x = _as(x, np.float64).copy()
        for _ in range(int(iterations)):
            if direction in ("forward", "symmetric"):
                self.lib.block_gauss_seidel_sweep(
                    _ptr(self.blocks, ctypes.c_double),
                    _ptr(self.nbr, ctypes.c_int32),
                    _ptr(self.mask, ctypes.c_uint8),
                    _ptr(self.dinv, ctypes.c_double), self.n, self.b,
                    _ptr(rhs, ctypes.c_double), _ptr(x, ctypes.c_double),
                    0, omega)
            if direction in ("backward", "symmetric"):
                self.lib.block_gauss_seidel_sweep(
                    _ptr(self.blocks, ctypes.c_double),
                    _ptr(self.nbr, ctypes.c_int32),
                    _ptr(self.mask, ctypes.c_uint8),
                    _ptr(self.dinv, ctypes.c_double), self.n, self.b,
                    _ptr(rhs, ctypes.c_double), _ptr(x, ctypes.c_double),
                    1, omega)
        return x

    def jacobi(self, rhs, x, iterations=1, omega=1.0):
        rhs = _as(rhs, np.float64)
        x = _as(x, np.float64).copy()
        for _ in range(int(iterations)):
            self.lib.block_jacobi_sweep(
                _ptr(self.blocks, ctypes.c_double),
                _ptr(self.nbr, ctypes.c_int32),
                _ptr(self.mask, ctypes.c_uint8),
                _ptr(self.dinv, ctypes.c_double), self.n, self.b,
                _ptr(rhs, ctypes.c_double), _ptr(x, ctypes.c_double), omega)
        return x
