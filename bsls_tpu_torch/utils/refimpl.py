"""Pure-numpy reference implementations of the core kernels.

These are the ground-truth oracles for every accelerated kernel in
``bsls_tpu_torch.ops`` (plain torch and CUDA alike): slow, simple, float64,
single-vector.  Algorithms follow arXiv:1101.6081 for the sort-based
simplex projection and the classical stack-based PAVA for isotonic
regression.  A copy of ``bsls_tpu/utils/refimpl.py``.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "proj_simplex_np",
    "proj_blocks_np",
    "pava_np",
    "pava_blocks_np",
    "x_to_z_np",
    "z_to_x_np",
]


def proj_simplex_np(v: np.ndarray, s: float = 1.0) -> np.ndarray:
    """Euclidean projection of ``v`` onto the simplex {x >= 0, sum x = s}.

    Sort-based O(n log n) algorithm (arXiv:1101.6081): sort descending,
    find the pivot rho = max{k : u_k - (cumsum_k - s)/k > 0}, threshold
    tau = (cumsum_rho - s)/rho, return max(v - tau, 0).
    """
    v = np.asarray(v, dtype=np.float64)
    if v.ndim != 1:
        raise ValueError("proj_simplex_np expects a 1-D vector")
    n = v.size
    if n == 1:
        return np.array([s], dtype=np.float64)
    u = np.sort(v)[::-1]
    css = np.cumsum(u)
    k = np.arange(1, n + 1)
    cond = u - (css - s) / k > 0
    rho = np.nonzero(cond)[0][-1]
    tau = (css[rho] - s) / (rho + 1)
    return np.maximum(v - tau, 0.0)


def proj_blocks_np(v: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Project a concatenated vector block-by-block onto unit simplices."""
    v = np.asarray(v, dtype=np.float64)
    out = np.empty_like(v)
    off = 0
    for n in np.asarray(sizes, dtype=np.int64):
        out[off : off + n] = proj_simplex_np(v[off : off + n])
        off += n
    assert off == v.size
    return out


def pava_np(
    y: np.ndarray,
    w: np.ndarray | None = None,
    lo: float | None = None,
    hi: float | None = None,
    increasing: bool = True,
) -> np.ndarray:
    """Isotonic regression by stack-based Pool-Adjacent-Violators, O(n).

    Returns argmin_x sum w_i (x_i - y_i)^2 subject to x nondecreasing
    (or nonincreasing) and optional box bounds ``lo <= x <= hi``.

    Box bounds commute with the monotone cone projection for uniform
    bounds, so they are applied as a final clip.
    """
    y = np.asarray(y, dtype=np.float64)
    n = y.size
    if w is None:
        w = np.ones(n, dtype=np.float64)
    else:
        w = np.asarray(w, dtype=np.float64)
    sgn = 1.0 if increasing else -1.0
    yy = sgn * y
    means: list[float] = []
    weights: list[float] = []
    lengths: list[int] = []
    for i in range(n):
        m, wt, ln = yy[i], w[i], 1
        # pool while the previous level violates nondecreasing order
        while means and means[-1] > m:
            pm, pw, pl = means.pop(), weights.pop(), lengths.pop()
            m = (m * wt + pm * pw) / (wt + pw)
            wt += pw
            ln += pl
        means.append(m)
        weights.append(wt)
        lengths.append(ln)
    out = np.concatenate(
        [np.full(l, m, dtype=np.float64) for m, l in zip(means, lengths)]
    )
    out = sgn * out
    if lo is not None or hi is not None:
        out = np.clip(out, lo, hi)
    return out


def pava_blocks_np(
    y: np.ndarray, sizes: np.ndarray, lo: float = 0.0, hi: float = 1.0
) -> np.ndarray:
    """Bounded isotonic regression applied per block of a concatenated vector."""
    y = np.asarray(y, dtype=np.float64)
    out = np.empty_like(y)
    off = 0
    for n in np.asarray(sizes, dtype=np.int64):
        out[off : off + n] = pava_np(y[off : off + n], lo=lo, hi=hi)
        off += n
    return out


def x_to_z_np(x: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Change of variable block-simplex -> order-simplex.

    Per block of size n, z_k = sum_{j<=k} x_j for k = 1..n-1.  ``z`` lies in
    the order simplex {0 <= z_1 <= ... <= z_{n-1} <= 1} iff ``x`` lies in the
    simplex.  Output has length N - B (one fewer entry per block).
    """
    x = np.asarray(x, dtype=np.float64)
    zs = []
    off = 0
    for n in np.asarray(sizes, dtype=np.int64):
        zs.append(np.cumsum(x[off : off + n])[:-1])
        off += n
    return np.concatenate(zs) if zs else np.zeros(0)


def z_to_x_np(z: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """Inverse of :func:`x_to_z_np`: x_1 = z_1, x_j = z_j - z_{j-1}, x_n = 1 - z_{n-1}."""
    z = np.asarray(z, dtype=np.float64)
    xs = []
    off = 0
    for n in np.asarray(sizes, dtype=np.int64):
        zb = z[off : off + n - 1]
        ze = np.concatenate([[0.0], zb, [1.0]])
        xs.append(np.diff(ze))
        off += n - 1
    return np.concatenate(xs)
