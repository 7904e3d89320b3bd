"""ctypes bindings + lazy build of the native edge-array kitchen (pack.cpp).

``coo_dedup`` -- graph/csr.py::_finish_coo's sum-duplicates + CSR indptr
(the linalgcpp ``CooMatrix::ToSparse`` role, embed.cpp:51-66) -- gets a C++
backend (stable radix sort instead of np.lexsort).  It is bit-identical to
the numpy implementation (differential tests in tests/test_native_pack.py);
callers fall back to numpy on any failure.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from . import build_shared

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "pack.cpp")
_SO = os.path.join(_HERE, "_pack.so")
_LOCK = threading.Lock()
_LIB = None

_i64 = ctypes.c_int64
_p = ctypes.c_void_p


def _build() -> str:
    return build_shared(_SRC, _SO)


def _lib():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build())
            lib.ge_coo_dedup.restype = _p
            lib.ge_coo_dedup.argtypes = [_i64, _i64, _p, _p, _p,
                                         ctypes.POINTER(_i64)]
            lib.ge_coo_fill.restype = None
            lib.ge_coo_fill.argtypes = [_p, _p, _p, _p, _p]
            lib.ge_coo_free.restype = None
            lib.ge_coo_free.argtypes = [_p]
            _LIB = lib
    return _LIB


def _ptr(a):
    return a.ctypes.data_as(_p)


def coo_dedup(s, r, w, n: int):
    """Sum duplicate (s, r) entries (stable order) and build CSR indptr.

    Returns ``(s, r, w, indptr)`` -- s/r int64 sorted by (s, r), w float64
    duplicate-summed in ascending original order, indptr int64[n + 1].
    Bit-identical to the numpy path in ``graph.csr._finish_coo``.
    """
    lib = _lib()
    s = np.ascontiguousarray(s, dtype=np.int64)
    r = np.ascontiguousarray(r, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    m = s.size
    count = _i64(0)
    handle = lib.ge_coo_dedup(m, int(n), _ptr(s), _ptr(r), _ptr(w),
                              ctypes.byref(count))
    if not handle:
        raise OSError("native coo_dedup failed")
    try:
        e = count.value
        so = np.empty(e, dtype=np.int64)
        ro = np.empty(e, dtype=np.int64)
        wo = np.empty(e, dtype=np.float64)
        indptr = np.empty(n + 1, dtype=np.int64)
        lib.ge_coo_fill(handle, _ptr(so), _ptr(ro), _ptr(wo), _ptr(indptr))
    finally:
        lib.ge_coo_free(handle)
    return so, ro, wo, indptr
