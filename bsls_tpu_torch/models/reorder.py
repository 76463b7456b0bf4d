"""Bandwidth-reducing row reordering (reverse Cuthill-McKee).

The banded-split layout (ops/banded.py) needs each column's nonzero rows
clustered in a window.  Real route-incidence instances have that structure
*physically* (routes touch spatially local links) but their link numbering
is arbitrary; RCM on the rows-share-a-column graph (pattern of A·Aᵀ)
recovers an ordering where graph-adjacent links get nearby ids.  The row
order of a least-squares system is semantically free — only ``b`` permutes
with it — so this is a pure preprocessing step:

    prob2 = reorder_rows_rcm(prob)      # same solutions, bandable layout
    res = solve(prob2, ...)             # prepare() auto-selects banded

Column/block ordering needs no user action: the banded prepare sorts
blocks by their row window itself.

Host numpy/scipy only: a copy of ``bsls_tpu/models/reorder.py``.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np

from .problem import DenseMatrix, EllMatrix, Problem

__all__ = ["reorder_rows_rcm", "rcm_row_permutation", "estimate_bandability"]


def rcm_row_permutation(A) -> np.ndarray:
    """Reverse-Cuthill-McKee order of A's rows on the rows-share-a-column
    graph.  Returns perm with ``perm[new_pos] = old_row``."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    S = A.to_scipy() if hasattr(A, "to_scipy") else sp.csr_matrix(np.asarray(A))
    S = sp.csr_matrix(S)
    S.data = np.ones_like(S.data)
    G = (S @ S.T).tocsr()
    return np.asarray(reverse_cuthill_mckee(G, symmetric_mode=True), np.int64)


def estimate_bandability(A, perm: np.ndarray | None = None, window: int = 896) -> float:
    """nnz-weighted fraction of columns whose (optionally permuted) row span
    fits a ``window``-row band — the same pre-screen prepare() applies."""
    if isinstance(A, EllMatrix):
        rows = np.asarray(A.rows)
        nz = np.asarray(A.vals) != 0
    else:
        raise TypeError("estimate_bandability expects an EllMatrix")
    if perm is not None:
        rank = np.empty(perm.size, np.int64)
        rank[perm] = np.arange(perm.size)
        rows = rank[rows]
    # sentinel must match rows' dtype: an int64 max inside np.where silently
    # wraps to -1 when rows is int32
    big = np.iinfo(rows.dtype).max
    rmin = np.where(nz, rows, big).min(axis=1)
    rmax = np.where(nz, rows, -1).max(axis=1)
    nnz = nz.sum(axis=1)
    ok = (rmax - rmin) <= window
    return float(nnz[ok & (nnz > 0)].sum()) / max(int(nnz.sum()), 1)


def reorder_rows_rcm(problem: Problem) -> Problem:
    """Return an equivalent Problem with RCM-reordered rows (b permuted to
    match; x-space untouched, so solutions and constraints carry over)."""
    perm = rcm_row_permutation(problem.A)
    rank = np.empty(perm.size, np.int64)
    rank[perm] = np.arange(perm.size)
    A = problem.A
    if isinstance(A, EllMatrix):
        A2 = EllMatrix(
            rows=rank[np.asarray(A.rows)].astype(np.int32),
            vals=np.asarray(A.vals),
            num_rows=A.num_rows,
        )
    elif isinstance(A, DenseMatrix):
        A2 = DenseMatrix(np.asarray(A.data)[perm])
    else:
        raise TypeError(f"unsupported matrix type {type(A)}")
    b = np.asarray(problem.b)[..., perm]
    return replace(problem, A=A2, b=b, name=problem.name + "+rcm")
