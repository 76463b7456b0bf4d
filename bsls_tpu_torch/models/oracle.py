"""CPU float64 oracle solver: certified ground-truth objectives.

An accelerated projected-gradient (FISTA) solve in float64 with monotone
restarts, whose optimality is *certified* by the Frank-Wolfe duality gap

    f(x) - f*  <=  gap(x) = grad f(x) . (x - s),   s = per-block vertex argmin

which is exactly computable on a product of simplices.  A copy of the
unconstrained half of ``bsls_tpu/models/oracle.py`` (numpy/scipy only); the
equality-constrained oracle needs the equality-constrained solver's host
halves and comes with that slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


from .problem import Problem

__all__ = ["OracleResult", "fw_gap_np", "oracle_solve",
           "cached_oracle_objective"]


@dataclass
class OracleResult:
    x: np.ndarray
    objective: float
    gap: float  # FW duality gap certificate: f(x) - f* <= gap
    iterations: int


def fw_gap_np(g: np.ndarray, x: np.ndarray, sizes: np.ndarray) -> float:
    """Frank-Wolfe duality gap g.(x - s) with s the blockwise vertex argmin
    (vectorised via minimum.reduceat over block offsets)."""
    sizes = np.asarray(sizes, dtype=np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    mins = np.minimum.reduceat(g, offs)
    return float(g @ x - mins.sum())


class _ScipyOp:
    """CSR-backed matvec pair (EllMatrix.matvec's np.add.at is ~100x slower)."""

    def __init__(self, M):
        import scipy.sparse as sp

        self.M = sp.csr_matrix(M.to_scipy()).astype(np.float64)
        self.Mt = sp.csr_matrix(self.M.T)

    def matvec(self, x):
        return self.M @ x

    def rmatvec(self, r):
        return self.Mt @ r

    def matmat(self, X):  # (S, n) -> (S, m): one SpMM for all scenarios
        return (self.M @ X.T).T

    def rmatmat(self, R):  # (S, m) -> (S, n)
        return (self.Mt @ R.T).T


def _fast_operator(A):
    from .problem import DenseMatrix, EllMatrix

    if isinstance(A, EllMatrix):
        return _ScipyOp(A)
    if isinstance(A, DenseMatrix):
        return A
    return A


def _make_vectorized_projection(part):
    """Vectorised numpy block projection over the partition's padded buckets
    (the per-block Python loop in refimpl is ~1000x too slow for 10k-block
    oracle solves)."""

    def proj(v: np.ndarray) -> np.ndarray:
        out = np.zeros_like(v)
        for b in part.buckets:
            m = b.mask.astype(bool)
            vp = np.where(m, v[b.pad_to_flat], -np.inf)
            u = -np.sort(-vp, axis=1)
            u0 = np.where(np.isfinite(u), u, 0.0)
            css = np.cumsum(u0, axis=1)
            k = np.arange(1, b.width + 1)
            widths = b.sizes[:, None]
            with np.errstate(invalid="ignore"):
                cond = (u * k > css - 1.0) & (k <= widths)
            rho = np.where(cond, np.arange(b.width), -1).max(axis=1)
            rho_c = np.maximum(rho, 0)
            tau = (css[np.arange(css.shape[0]), rho_c] - 1.0) / (rho_c + 1)
            res = np.maximum(np.where(m, v[b.pad_to_flat], 0.0) - tau[:, None], 0.0) * m
            out[b.pad_to_flat[m]] = res[m]
        return out

    return proj


def _power_iteration_sq_norm(A, n: int, iters: int = 60, seed: int = 0) -> float:
    """Estimate ||A||_2^2 (Lipschitz constant of the gradient)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = A.rmatvec(A.matvec(v))
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 1.0
        v = w / lam
    return lam * 1.01  # small safety margin


def oracle_solve(
    problem: Problem,
    tol_gap: float = 1e-10,
    max_iter: int = 20000,
    scenario: int | None = None,
) -> OracleResult:
    """Solve one scenario of ``problem`` to FW-gap <= tol_gap (float64 FISTA).

    Equality constraints (problem.C) are NOT handled here: the
    equality-constrained oracle is not ported yet.
    """
    if problem.C is not None:
        raise NotImplementedError(
            "oracle for equality-constrained instances is not ported yet "
            "(later slice: equality-constrained path)")
    A = _fast_operator(problem.A)
    b = np.asarray(problem.b, dtype=np.float64)
    if b.ndim == 2:
        b = b[0 if scenario is None else scenario]
    sizes = problem.partition.sizes
    n = problem.partition.n_flat

    L = _power_iteration_sq_norm(A, n)
    step = 1.0 / L

    def obj(v):
        rr = A.matvec(v) - b
        return 0.5 * float(rr @ rr)

    proj = _make_vectorized_projection(problem.partition)

    # feasible start: uniform on each block
    x = np.concatenate([np.full(int(s), 1.0 / s) for s in sizes])
    y = x.copy()
    t_mom = 1.0
    f_prev = np.inf
    gap = np.inf
    it = 0
    for it in range(1, max_iter + 1):
        r = A.matvec(y) - b
        g = A.rmatvec(r)
        x_new = proj(y - step * g)
        f_new = obj(x_new)
        if f_new > f_prev:  # monotone restart
            y = x.copy()
            t_mom = 1.0
            r = A.matvec(y) - b
            g = A.rmatvec(r)
            x_new = proj(y - step * g)
            f_new = obj(x_new)
        t_new = 0.5 * (1.0 + np.sqrt(1.0 + 4.0 * t_mom * t_mom))
        y = x_new + ((t_mom - 1.0) / t_new) * (x_new - x)
        x, t_mom, f_prev = x_new, t_new, f_new
        if it % 25 == 0 or it == max_iter:
            gx = A.rmatvec(A.matvec(x) - b)
            gap = fw_gap_np(gx, x, sizes)
            if gap <= tol_gap:
                break
    return OracleResult(x=x, objective=problem.objective_np(x), gap=gap, iterations=it)


def cached_oracle_objective(
    problem: Problem,
    key: str | None,
    tol_gap: float = 1e-10,
    max_iter: int = 50_000,
) -> float:
    """f* for ``problem`` with an on-disk cache keyed by ``key``.

    The float64 oracle on medium-scale instances costs minutes per fresh
    process; ``cli --oracle`` shares this cache so only the first process
    pays.  Keys should be deterministic instance identities (e.g.
    "medium_0" = config + seed); pass ``key=None`` for file-loaded or
    ad-hoc instances to skip caching.
    """
    import json as _json
    import os as _os

    cache_dir = _os.environ.get(
        "BSLS_CACHE_DIR", _os.path.join(_os.getcwd(), ".bench"))
    path = None
    if key:
        path = _os.path.join(cache_dir, f"oracle_{key}.json")
        if _os.path.exists(path):
            with open(path) as fh:
                return _json.load(fh)["objective"]
    orc = oracle_solve(problem, tol_gap=tol_gap, max_iter=max_iter)
    if path:
        _os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            _json.dump({"objective": orc.objective, "gap": orc.gap,
                        "iterations": orc.iterations}, fh)
        _os.replace(tmp, path)
    return orc.objective
