"""Native (C++) layout engine: ctypes loader with numpy fallback.

``group_ell(keys, idx, vals, num_groups)`` is the one primitive every
device-layout routine needs (see layout_kernels.cc).  The shared library
is compiled lazily with g++ into ``_build/`` next to this file (plain C ABI
+ ctypes).  Environments without a toolchain fall back to the numpy
implementation — identical output, just O(N log N) instead of O(N).  This
is host preparation, not device compute: the fallback hides no kernel.
``native_available()`` says which of the two runs.

``csr_matmat_f64`` is the float64 host SpMM of certified refine (OpenMP
over (right-hand side, row block) tasks); without the library it returns
None and its callers keep their scipy path.

Set BSLS_NO_NATIVE=1 to force the numpy path (used by the equivalence
tests).  A copy of ``bsls_tpu/native``."""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["csc_ell", "csr_matmat_f64", "group_ell", "native_available"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "layout_kernels.cc")
_LIB_PATH = os.path.join(_HERE, "_build", "libbsls_layout.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("BSLS_NO_NATIVE") == "1":
            return None
        try:
            if not os.path.exists(_LIB_PATH) or (
                os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)
            ):
                os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
                tmp = _LIB_PATH + ".tmp.so"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-fopenmp", "-shared",
                     "-fPIC", "-o", tmp, _SRC],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, _LIB_PATH)
            lib = ctypes.CDLL(_LIB_PATH)
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.bsls_group_counts.restype = ctypes.c_int64
            lib.bsls_group_counts.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p]
            lib.bsls_ell_fill.restype = None
            lib.bsls_ell_fill.argtypes = [
                i64p, i32p, f32p, ctypes.c_int64, ctypes.c_int64, i32p, i32p, f32p,
            ]
            lib.bsls_ell_fill_f64.restype = None
            lib.bsls_ell_fill_f64.argtypes = [
                i64p, i32p, f64p, ctypes.c_int64, ctypes.c_int64, i32p, i32p, f64p,
            ]
            lib.bsls_csc_fill.restype = None
            lib.bsls_csc_fill.argtypes = [
                i64p, i32p, f32p, ctypes.c_int64, ctypes.c_int64, i32p, f32p,
            ]
            lib.bsls_csc_fill_f64.restype = None
            lib.bsls_csc_fill_f64.argtypes = [
                i64p, i32p, f64p, ctypes.c_int64, ctypes.c_int64, i32p, f64p,
            ]
            lib.bsls_csr_matmat_f64.restype = None
            lib.bsls_csr_matmat_f64.argtypes = [
                i64p, i32p, f64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                f64p, f64p,
            ]
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def native_available() -> bool:
    return _load() is not None


def _group_ell_numpy(keys, idx, vals, num_groups):
    order = np.argsort(keys, kind="stable")
    key_s = keys[order]
    first = np.searchsorted(key_s, key_s)
    pos = np.arange(key_s.size) - first
    width = int(pos.max()) + 1 if key_s.size else 1
    cols = np.zeros((num_groups, width), np.int32)
    out_vals = np.zeros((num_groups, width), vals.dtype)
    cols[key_s, pos] = idx[order]
    out_vals[key_s, pos] = vals[order]
    return cols, out_vals


def _csc_ell_numpy(indptr, indices, data, width):
    n = indptr.size - 1
    counts = np.diff(indptr)
    rows = np.zeros((n, width), np.int32)
    vals = np.zeros((n, width), data.dtype)
    col_id = np.repeat(np.arange(n), counts)
    pos = np.arange(indices.size) - np.repeat(indptr[:-1], counts)
    rows[col_id, pos] = indices
    vals[col_id, pos] = data
    return rows, vals


def csc_ell(indptr, indices, data):
    """CSC components -> padded column-ELL (rows int32 (n, W), vals (n, W)),
    W = max per-column count.  One O(nnz) native pass with no key
    materialisation; numpy fallback is the classic repeat/scatter."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    want64 = np.dtype(data.dtype) == np.float64
    data = np.ascontiguousarray(data, np.float64 if want64 else np.float32)
    n = indptr.size - 1
    width = max(int(np.diff(indptr).max()) if n else 1, 1)
    lib = _load()
    if lib is None:
        return _csc_ell_numpy(indptr, indices, data, width)
    rows = np.zeros((n, width), np.int32)
    vals = np.zeros((n, width), data.dtype)
    fill = lib.bsls_csc_fill_f64 if want64 else lib.bsls_csc_fill
    fill(indptr, indices, data, n, width, rows.reshape(-1), vals.reshape(-1))
    return rows, vals


def group_ell(keys, idx, vals, num_groups: int):
    """Scatter (keys, idx, vals) triples into padded (num_groups, W) ELL
    arrays, W = max group size, stable within groups.  Returns
    (cols int32 (G, W), vals (G, W))."""
    keys = np.ascontiguousarray(keys, np.int64)
    idx = np.ascontiguousarray(idx, np.int32)
    want64 = np.dtype(vals.dtype) == np.float64
    vals = np.ascontiguousarray(vals, np.float64 if want64 else np.float32)
    lib = _load()
    if lib is None:
        return _group_ell_numpy(keys, idx, vals, num_groups)
    counts = np.zeros(num_groups, np.int64)
    width = int(lib.bsls_group_counts(keys, keys.size, num_groups, counts))
    width = max(width, 1)
    cursors = np.zeros(num_groups, np.int32)
    cols = np.zeros((num_groups, width), np.int32)
    out_vals = np.zeros((num_groups, width), vals.dtype)
    fill = lib.bsls_ell_fill_f64 if want64 else lib.bsls_ell_fill
    fill(keys, idx, vals, keys.size, width, cursors, cols.reshape(-1),
         out_vals.reshape(-1))
    return cols, out_vals


def csr_matmat_f64(indptr, indices, data, m: int, X):
    """Y (S, m) = X (S, n) @ A^T for CSR A (m x n): one parallel CSR
    matvec per RHS row via the native OpenMP kernel (parallel over
    (rhs, row-block) tasks).  Returns None when the native library is
    unavailable (callers fall back to scipy).  Inputs must be prepared
    once by the caller: int64 indptr, int32 indices, float64 data, and a
    C-contiguous float64 X of shape (S, n)."""
    lib = _load()
    if lib is None:
        return None
    S, n = X.shape
    Y = np.empty((S, m), np.float64)
    lib.bsls_csr_matmat_f64(indptr, indices, data, m, n, S, X, Y)
    return Y
