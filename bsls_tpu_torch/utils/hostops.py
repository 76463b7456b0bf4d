"""Host float64 SpMM closures over the native OpenMP CSR kernel.

The certified-refine PCG (solvers.base.refine_polish, host path) does
hundreds of (S, n) x A^T A products on the host; scipy's csr_matvecs is
single-threaded and loops RHS columns.  The native kernel
(native/layout_kernels.cc::bsls_csr_matmat_f64) is parallel over OpenMP
threads.  A copy of ``bsls_tpu/utils/hostops.py``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["host_matmat_ops"]


def host_matmat_ops(A):
    """(mm, rmm) closures for float64 (S, n)->(S, m) / (S, m)->(S, n)
    products backed by the native kernel, or ``None`` when the native
    library or a scipy conversion is unavailable (callers keep their
    scipy path).  CSR components for A and A^T are prepared once."""
    from ..native import csr_matmat_f64, native_available

    if not native_available():
        return None
    try:
        import scipy.sparse as sp

        M = sp.csr_matrix(A.to_scipy()).astype(np.float64)
    except Exception:
        return None
    Mt = sp.csr_matrix(M.T)
    packs = [
        (np.ascontiguousarray(Mat.indptr, np.int64),
         np.ascontiguousarray(Mat.indices, np.int32),
         np.ascontiguousarray(Mat.data, np.float64),
         Mat.shape[0])
        for Mat in (M, Mt)
    ]

    def _apply(pack, X):
        ip, ix, dt, m = pack
        Xc = np.ascontiguousarray(np.asarray(X, np.float64))
        return csr_matmat_f64(ip, ix, dt, m, Xc)

    return (lambda X: _apply(packs[0], X)), (lambda X: _apply(packs[1], X))
