"""CPU float64 oracle solver: certified ground-truth objectives.

An accelerated projected-gradient (FISTA) solve in float64 with monotone
restarts, whose optimality is *certified* by the Frank-Wolfe duality gap

    f(x) - f*  <=  gap(x) = grad f(x) . (x - s),   s = per-block vertex argmin

which is exactly computable on a product of simplices, and its
equality-constrained counterpart ``oracle_solve_eq`` (an augmented-Lagrangian
loop over the same FISTA, finished by the active-set walk
``solvers.eq_constrained.prox_bpp_polish`` and certified by a Lagrangian
dual bound).

A copy of ``bsls_tpu/models/oracle.py`` (numpy/scipy only).  One deviation:
the objective of a solve of one scenario of a multi-RHS problem is taken
against that scenario's own ``b`` (the reference evaluates the 1-D x against
the whole (S, m) ``b`` and raises).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


from .problem import Problem

__all__ = ["OracleResult", "fw_gap_np", "oracle_solve", "oracle_solve_eq",
           "cached_oracle_objective"]


@dataclass
class OracleResult:
    x: np.ndarray
    objective: float
    gap: float  # FW duality gap certificate: f(x) - f* <= gap
    iterations: int
    eq_violation: float | None = None  # ||Cx - d||_inf / max(1, ||d||_inf)


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
    # composite wrappers (VStackMatrix, ScaledMatrix) that expose to_scipy
    # also take the CSR path: refine_polish on the stacked eq operator does
    # hundreds of matvecs, and the per-part bincount loop is ~10x slower
    if hasattr(A, "to_scipy"):
        try:
            return _ScipyOp(A)
        except Exception:
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

    Equality constraints (problem.C) are NOT handled here, as in the
    reference: ``oracle_solve_eq`` solves the constrained problem (it calls
    this oracle on the augmented quadratic).  The objective is evaluated
    against the solved scenario's ``b``.
    """
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
    # the solved scenario's b: problem.objective_np would take a 1-D x
    # against the whole (S, m) b of a multi-RHS problem
    r = problem.A.matvec(np.asarray(x, np.float64)) - b
    return OracleResult(x=x, objective=0.5 * float(r @ r), gap=gap, iterations=it)


def oracle_solve_eq(
    problem: Problem,
    tol_eq: float = 1e-9,
    tol_gap: float = 1e-10,
    max_outer: int = 40,
    inner_iter: int = 20000,
    scenario: int | None = None,
    direct: bool | str = "auto",
) -> OracleResult:
    """Float64 oracle for the EQUALITY-CONSTRAINED variant.

    Augmented-Lagrangian outer loop over ``oracle_solve`` inners on the
    stacked quadratic  0.5||[A; sqrt(rho) C] x - [b; sqrt(rho)(d - lam/rho)]||^2
    (the same formulation the device solver uses, in numpy float64).

    The reported ``gap`` is a SOUND bound on f(x) - f* for the constrained
    problem via Lagrangian duality: with the final multipliers lam,

        q(lam) = min_{v in product-of-simplices} f(v) + lam.(Cv - d)
               >= [f(x) + lam.(Cx - d)] - gap_FW(grad f(x) + C^T lam, x)

    so  f(x) - f* <= f(x) - q(lam) <= gap_FW(...) - lam.(Cx - d).

    ``direct`` (default "auto"): up to the sparse-KKT scale (n + B + p <=
    100,000), finish with the exact active-set walk (``prox_bpp_polish``)
    from a SHORT AL warm start instead of grinding AL-FISTA outers: on
    perturbed instances the AL path can hit its inner caps with a useless
    bound while the active-set point is feasible, better, and certifies to
    ~f64 roundoff.  ``direct=False`` forces the AL-only path;
    ``direct=True`` fails loudly beyond that scale.  ``scenario`` selects
    one right-hand side (and target row of a per-scenario ``d``); objective
    and violation are that scenario's.
    """
    import scipy.sparse as sp

    if problem.C is None:
        return oracle_solve(problem, tol_gap=tol_gap, max_iter=inner_iter,
                            scenario=scenario)
    from dataclasses import replace as dc_replace

    part0 = problem.partition
    kkt_dim = part0.n_flat + len(part0.sizes) + problem.C.shape[0]
    # 100k: prox_bpp_polish's sparse-KKT ceiling (face systems above ~2500
    # dims solve by projected PCG instead of dense LAPACK)
    if direct == "auto":
        direct = kkt_dim <= 100_000
    elif direct and kkt_dim > 100_000:
        raise ValueError(
            f"oracle_solve_eq(direct=True): KKT dimension {kkt_dim} exceeds "
            "the sparse-KKT scale (100000); use the AL path")
    if direct:
        from ..solvers.eq_constrained import eq_dual_bound, prox_bpp_polish

        warm = oracle_solve_eq(
            problem, tol_eq=max(tol_eq, 1e-6), tol_gap=max(tol_gap, 1e-8),
            max_outer=6, inner_iter=3000, scenario=scenario, direct=False,
        )
        b_sel = np.asarray(problem.b, np.float64)
        d_sel = np.asarray(problem.d, np.float64)
        if b_sel.ndim == 2:
            s = 0 if scenario is None else scenario
            b_sel = b_sel[s]
            if d_sel.ndim == 2:
                d_sel = d_sel[s]
        prob1 = dc_replace(problem, b=b_sel, d=d_sel, x_true=None)
        x_d, lam_d, ok = prox_bpp_polish(prob1, warm.x, dual_rtol=1e-12)
        if ok:
            C_sp = sp.csr_matrix(problem.C.to_scipy()).astype(np.float64)
            A_sp = sp.csr_matrix(problem.A.to_scipy()).astype(np.float64)
            r_d = A_sp @ x_d - b_sel
            f_d = 0.5 * float(r_d @ r_d)
            dref = max(1.0, float(np.abs(d_sel).max())) if d_sel.size else 1.0
            bound = eq_dual_bound(prob1, x_d, lam_d) * max(1.0, abs(f_d))
            return OracleResult(
                x=x_d, objective=f_d, gap=float(bound),
                iterations=warm.iterations,
                eq_violation=float(np.abs(C_sp @ x_d - d_sel).max()) / dref)
        # polish failed (exchange cap): fall through to the full AL path

    A_csr = sp.csr_matrix(problem.A.to_scipy()).astype(np.float64)
    C_csr = sp.csr_matrix(problem.C.to_scipy()).astype(np.float64)
    b = np.asarray(problem.b, np.float64)
    if b.ndim == 2:
        b = b[0 if scenario is None else scenario]
    d = np.asarray(problem.d, np.float64)
    if d.ndim == 2:
        d = d[0 if scenario is None else scenario]
    part = problem.partition
    sizes = part.sizes

    op_A = _ScipyOp(problem.A)
    L_A = _power_iteration_sq_norm(op_A, part.n_flat)

    class _Raw:
        def __init__(self, M):
            self.M, self.Mt = M, sp.csr_matrix(M.T)

        def matvec(self, x):
            return self.M @ x

        def rmatvec(self, r):
            return self.Mt @ r

    L_C = _power_iteration_sq_norm(_Raw(C_csr), part.n_flat)
    rho = max(1.0, 0.1 * L_A / max(L_C, 1e-30))
    lam = np.zeros(d.shape, np.float64)
    dref = max(1.0, float(np.abs(d).max())) if d.size else 1.0
    x = None
    viol_prev = np.inf
    total_inner = 0
    for _ in range(max_outer):
        sr = np.sqrt(rho)
        A_st = sp.vstack([A_csr, sr * C_csr], format="csr")
        b_st = np.concatenate([b, sr * (d - lam / rho)])
        p_st = dc_replace(problem, A=_WrapOp(A_st, (A_st.shape[0], part.n_flat)),
                          b=b_st, C=None, d=None, x_true=None)
        res = oracle_solve(p_st, tol_gap=tol_gap, max_iter=inner_iter)
        x = res.x
        total_inner += res.iterations
        cx_d = C_csr @ x - d
        viol = float(np.abs(cx_d).max()) / dref if d.size else 0.0
        lam = lam + rho * cx_d
        if viol <= tol_eq:
            break
        if viol > 0.25 * viol_prev:  # not shrinking fast enough
            rho *= 10.0
        viol_prev = viol

    r = A_csr @ x - b
    f = 0.5 * float(r @ r)
    # sound dual bound at (x, lam): FW gap of the Lagrangian minus the
    # complementarity term (see docstring)
    gL = A_csr.T @ r + C_csr.T @ lam
    bound = fw_gap_np(gL, x, sizes) - float(lam @ (C_csr @ x - d))
    # AL multipliers can certify sound-but-uselessly: refit lam on the
    # active face (sparse LSMR, seconds at any scale) and keep the tighter
    # sound bound
    from ..solvers.eq_constrained import eq_multiplier_polish

    b_all = np.asarray(problem.b, np.float64)
    prob_s = (problem if b_all.ndim == 1 else
              dc_replace(problem, b=b, d=d, x_true=None))
    lam_fit = eq_multiplier_polish(prob_s, x)
    gF = A_csr.T @ r + C_csr.T @ lam_fit
    bound_fit = fw_gap_np(gF, x, sizes) - float(lam_fit @ (C_csr @ x - d))
    bound = min(bound, bound_fit)
    return OracleResult(x=x, objective=f, gap=float(bound),
                        iterations=total_inner,
                        eq_violation=float(np.abs(C_csr @ x - d).max()) / dref)


class _WrapOp:
    """Duck-typed matrix for oracle_solve: scipy CSR with a .shape."""

    def __init__(self, M, shape):
        import scipy.sparse as sp

        self.M = M
        self.Mt = sp.csr_matrix(M.T)
        self.shape = shape

    def matvec(self, x):
        return self.M @ x

    def rmatvec(self, r):
        return self.Mt @ r

    def matmat(self, X):  # (S, n) -> (S, m): one SpMM for all scenarios
        return (self.M @ X.T).T

    def rmatmat(self, R):  # (S, m) -> (S, n)
        return (self.Mt @ R.T).T


def cached_oracle_objective(
    problem: Problem,
    key: str | None,
    tol_gap: float = 1e-10,
    max_iter: int = 50_000,
    scenario: int | None = None,
) -> float:
    """f* for ``problem`` (one scenario of it: ``scenario``, default the
    first) with an on-disk cache keyed by ``key``.

    The float64 oracle on medium-scale instances costs minutes per fresh
    process; ``cli --oracle`` shares this cache so only the first process
    pays.  Keys should be deterministic instance identities (e.g.
    "medium_0" = config + seed, with the scenario in it for a multi-RHS
    instance); pass ``key=None`` for file-loaded or ad-hoc instances to skip
    caching.  Eq-constrained problems route through ``oracle_solve_eq``
    (sound Lagrangian dual bound), unconstrained through FISTA (FW-gap
    certificate).
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
    orc = (oracle_solve_eq(problem, tol_eq=1e-9, tol_gap=tol_gap, scenario=scenario)
           if problem.C is not None
           else oracle_solve(problem, tol_gap=tol_gap, max_iter=max_iter,
                             scenario=scenario))
    if path:
        _os.makedirs(cache_dir, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            _json.dump({"objective": orc.objective, "gap": orc.gap,
                        "iterations": orc.iterations}, fh)
        _os.replace(tmp, path)
    return orc.objective
