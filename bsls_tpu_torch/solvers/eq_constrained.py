"""Equality-constrained block-simplex LSQ via augmented Lagrangian.

    minimize 0.5||Ax-b||^2  s.t.  x in product of simplices,  C x = d

Outer loop (host): with multiplier lam and penalty rho, the inner problem

    min 0.5||Ax-b||^2 + lam.(Cx-d) + rho/2 ||Cx-d||^2
  = min 0.5|| [A; sqrt(rho) C] x - [b; sqrt(rho)(d - lam/rho)] ||^2 + const

is a *standard* block-simplex LSQ on the stacked operator, so every inner
solve is the unconstrained chunk runner of ``solvers/base.py`` unchanged:
only the bottom RHS block and the penalty scale change between outer
iterations, and the scale is the 0-d tensor ``DeviceVStack.bottom_scale``,
so the stacked operator is prepared once.  Multiplier update
lam += rho (Cx - d), in float64 on the host; rho grows when the violation
stalls.

Multi-RHS scenarios are first-class: for b of shape (S, m) the multipliers
are per-scenario vectors lam (S, p), the stacked RHS [b_s; sqrt(rho)
(d_s - lam_s/rho)] batches over s, and one shared rho (driven by the
worst-scenario violation) keeps the stacked operator identical across
scenarios.  ``d`` may be (p,) (shared targets) or (S, p).

The augmented Lagrangian, not null-space elimination: elimination destroys
the block-simplex structure the per-block kernels exploit, while the AL
keeps the inner iteration identical to the unconstrained path.

The host halves (``prox_bpp_polish``, ``_face_pcg``, ``eq_multiplier_polish``,
``eq_dual_bound``, ``solve_eq_sensitivity``) are float64 numpy/scipy copies
of ``bsls_tpu/solvers/eq_constrained.py``.  One intended deviation:
``_face_pcg``'s ``_ggt_factors`` raises, naming the block, where a block has
no positive weight (the reference clamps it at 1e-300).  The device half,
``solve_equality_constrained``, runs on one device and checkpoints at outer
granularity; its mesh branches raise ``NotImplementedError`` naming the slice
that brings them.
"""
from __future__ import annotations

import time
from dataclasses import replace as dc_replace
from typing import Optional

import numpy as np
import torch

from ..models.problem import Problem, ScaledMatrix, VStackMatrix
from ..ops import layout as L
from ..utils.checkpoint import latest_checkpoint, load_state, save_state

__all__ = ["solve_equality_constrained", "solve_eq_sensitivity",
           "prox_bpp_polish", "eq_dual_bound", "eq_multiplier_polish"]


def _c_matvec(C, x: np.ndarray) -> np.ndarray:
    """C @ x for x of shape (n,) or (S, n) -> (p,) or (S, p)."""
    if x.ndim == 1:
        return C.matvec(x)
    return np.stack([C.matvec(x[s]) for s in range(x.shape[0])])


def _violation(cx_d: np.ndarray, d: np.ndarray, p: int) -> float:
    """||Cx - d||_inf / max(1, ||d||_inf) over every scenario."""
    if not p:
        return 0.0
    return float(np.abs(cx_d).max()) / max(1.0, float(np.abs(d).max()))


def op_cache_key(problem: Problem, dtype, method: str, line_search: str, device) -> tuple:
    """The ``op_cache`` entry of ``solve_equality_constrained`` for this
    instance: keyed on the operator identity (the A/C objects, stable when a
    caller swaps only the RHS with ``dataclasses.replace``), the dtype, the
    batch shape, the trial-step space (z-space inners cache the z-curvature
    bounds) and the device, so that a dict shared across instances or
    devices never hands back the wrong prepared operator."""
    from .base import uses_zspace

    return ("op", id(problem.A), id(problem.C), str(dtype), np.shape(problem.b),
            uses_zspace(method, line_search), str(L.resolve_device(device)))


def solve_equality_constrained(
    problem: Problem,
    method: str = "pgd",
    tol: float = 1e-6,
    eq_tol: float = 1e-6,
    max_iter: int = 10_000,
    chunk: int = 100,
    line_search: str = "exact",
    step_size: float = 0.0,
    dtype=torch.float32,
    rho0: float = 1.0,
    rho_growth: float = 4.0,
    outer_iters: int = 12,
    inner_iters: int = 2000,
    mesh=None,
    lam0=None,
    rho_init: float = 0.0,
    x0=None,
    op_cache: Optional[dict] = None,
    lbfgs_mem: int = 8,
    metrics=None,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    checkpoint_keep: int = 0,
    resume: bool = False,
    refine: int = 0,
    refine_tol: Optional[float] = None,
    shard_rows: bool = False,
    device="cuda",
):
    """Returns a SolveResult whose ``eq_violation`` records the relative
    ||Cx-d||_inf (worst scenario for multi-RHS), with the objective of the
    ORIGINAL problem (not the augmented one).

    ``max_iter`` is the TOTAL inner-iteration budget across all outer
    iterations; each outer runs at most ``min(inner_iters,
    remaining_budget)``.  A solve stopped by the budget reports its honest
    ``eq_violation`` and ``converged`` flags, with ``stop_reason``
    "budget_exhausted".

    ``lam0``/``rho_init``/``x0`` warm-start the augmented-Lagrangian state
    (for a stream of nearby right-hand sides the optimal multipliers move
    slowly, so warm outer loops converge in 1-2 outers instead of ~5).  The
    final state is reported as ``eq_lam``/``eq_rho``.

    ``op_cache`` (a plain dict owned by the caller, keyed by
    ``op_cache_key``) keeps the prepared stacked operator and its Lipschitz
    constants ACROSS calls: repeat requests against one instance skip the
    host re-encode, the upload and the power iterations.  An entry is
    ``(prepared, rho_base, L_base, L_C, A, C)``: it keeps the A and C it was
    prepared from, so that their ids are not reused while it lives, and it is
    used only for those very objects.  The bound then
    updates analytically, lam_max(A^T A + rho C^T C) <= L(rho_base) +
    (rho - rho_base) lam_max(C^T C), in x- and z-space alike; the block
    equilibration stays that of the first outer's rho.

    ``metrics`` receives one "outer" record per outer iteration (violation,
    rho after the update and ``inner_rho`` the inner solve used, inner
    iterations, objective, and the seconds of the inner solve and of the
    host multiplier update) on top of the inner solves' per-chunk records.

    ``refine=K`` runs K float64 AL finishing outers (``refine_polish`` on the
    stacked problem, then the multiplier update in float64); ``refine_tol``
    runs the certified finisher (``prox_bpp_polish``, then
    ``eq_multiplier_polish`` where the walk does not certify) and reports
    the Lagrangian dual bound as ``refine_fw_gap``.

    ``checkpoint_path``/``checkpoint_every``/``checkpoint_keep``/``resume``
    checkpoint at OUTER granularity (``checkpoint_every`` counts outer
    iterations): the state is ``{"lam", "x"}`` in float64 with the outer
    index, rho, the violation and the inner iterations so far in its meta;
    resume replays the multipliers and warm-starts the next outer.  A
    checkpoint whose inner iterations already meet ``max_iter`` comes back
    as its x with ``stop_reason`` "budget_exhausted".

    ``mesh``/``shard_rows`` raise ``NotImplementedError``: their slice is not
    ported yet.
    """
    from .base import (
        SolveResult, _reject_unported, power_lipschitz, power_lipschitz_z, refine_polish,
        solve, uses_zspace,
    )

    _reject_unported(mesh=mesh is not None, shard_rows=shard_rows)
    if problem.C is None:
        raise ValueError("problem has no equality constraints")
    dev = L.resolve_device(device)

    C = problem.C
    b = np.asarray(problem.b, dtype=np.float64)
    multi = b.ndim == 2
    S = b.shape[0] if multi else 1
    p = C.shape[0]
    d = np.asarray(problem.d, dtype=np.float64)
    if multi and d.ndim == 1:
        d = np.broadcast_to(d, (S, p))
    if lam0 is not None:
        lam = np.broadcast_to(
            np.asarray(lam0, np.float64), (S, p) if multi else (p,)
        ).copy()
    else:
        lam = np.zeros((S, p) if multi else p)

    # scale rho by the ratio of squared column norms so the penalty term is
    # commensurate with the data term from the first outer iteration; start
    # an order of magnitude below the data term so early inners optimise the
    # objective, and let rho grow as needed
    a_scale = float(np.mean(L._col_norms_sq(problem.A)))
    c_scale = float(np.mean(L._col_norms_sq(C))) or 1.0
    rho = float(rho_init) if rho_init > 0 else 0.1 * float(rho0) * a_scale / c_scale

    n = problem.A.shape[1]
    viol = np.inf
    total_iters = 0
    start_outer = 0
    if resume and checkpoint_path:
        ck = latest_checkpoint(checkpoint_path)
        if ck:
            like = {"lam": lam, "x": np.zeros((S, n) if multi else n)}
            ck_state, meta = load_state(ck, like)
            lam, x0 = ck_state["lam"], ck_state["x"]
            rho = float(meta.get("rho", rho))
            viol = float(meta.get("viol", viol))
            total_iters = int(meta.get("total_iters", 0))
            start_outer = int(meta.get("iteration", 0))
            # a checkpoint at the outer budget still gets one settling outer
            outer_iters = max(outer_iters, start_outer + 1)

    # z-space inners need the z-curvature; the analytic bound splits the
    # same way there, since D^T (A^T A + rho C^T C) D does
    power = power_lipschitz_z if uses_zspace(method, line_search) else power_lipschitz
    if op_cache is None:
        op_cache = {}
    key = op_cache_key(problem, dtype, method, line_search, dev)
    # an entry holds the A and C it was prepared from: their ids stay taken
    # while the entry lives, and an entry of other objects is not used
    dp_cache, rho_base, L_base, LC, A_c, C_c = op_cache.get(key, (None,) * 6)
    if A_c is not problem.A or C_c is not problem.C:
        dp_cache = None

    def stacked_rhs(rho_now):
        sr_now = np.sqrt(rho_now)
        return sr_now, np.concatenate([b, sr_now * (d - lam / rho_now)], axis=-1)

    def on_device(dp, sr_now, b_st):
        """The cached stacked operator with this penalty and this RHS."""
        return dc_replace(
            dp, A=dc_replace(dp.A, bottom_scale=torch.tensor(sr_now, dtype=dp.b.dtype,
                                                            device=dp.device)),
            b=torch.as_tensor(b_st, dtype=dp.b.dtype).to(dp.device))

    result = None
    ok_streak = 0
    for outer in range(start_outer, outer_iters):
        budget = max_iter - total_iters
        if budget <= 0:
            break
        this_inner = min(inner_iters, budget)
        sr, b_stacked = stacked_rhs(rho)
        x_prev = x0 if result is None else np.asarray(result.x)
        if dp_cache is None:
            stacked = Problem(
                A=VStackMatrix(top=problem.A, bottom=ScaledMatrix(C, sr)),
                b=b_stacked,
                partition=problem.partition,
                name=problem.name + "+eq",
            )
            dp_cache = L.prepare(stacked, dtype=dtype, device=dev)
            rho_base = rho
            L_base = power(dp_cache)
            # lam_max(C^T C) by power iteration on the bottom part alone
            # (the same equilibrated encoding, unit scale)
            LC = power(dc_replace(dp_cache, A=dp_cache.A.bottom))
            op_cache[key] = (dp_cache, rho_base, L_base, LC, problem.A, C)
        t_solve = time.perf_counter()
        result = solve(
            on_device(dp_cache, sr, b_stacked), method=method, tol=tol,
            max_iter=this_inner, chunk=chunk, line_search=line_search,
            step_size=step_size, dtype=dtype,
            x0=x_prev,  # warm start from the previous outer iterate
            lbfgs_mem=lbfgs_mem, metrics=metrics,
            lipschitz=L_base + max(0.0, rho - rho_base) * LC,
        )
        t_host = time.perf_counter()
        total_iters += result.iterations
        x = np.asarray(result.x, dtype=np.float64)
        cx_d = _c_matvec(C, x) - d
        new_viol = _violation(cx_d, d, p)
        rho_inner = rho
        lam = lam + rho * cx_d
        if new_viol > 0.25 * viol and new_viol > eq_tol:
            rho *= rho_growth
        viol = new_viol
        t_end = time.perf_counter()
        if metrics is not None:
            metrics.log("outer", outer=outer + 1, viol=viol, rho=rho, inner_rho=rho_inner,
                        inner_iters=int(result.iterations),
                        f=np.asarray(problem.objective_np(x)).tolist(),
                        solve_secs=t_host - t_solve, host_secs=t_end - t_host)
        if checkpoint_path and checkpoint_every and (outer + 1) % checkpoint_every == 0:
            save_state(checkpoint_path, {"lam": lam, "x": x},
                       meta={"iteration": outer + 1, "rho": rho, "viol": viol,
                             "total_iters": total_iters},
                       keep=checkpoint_keep)
        # stop only after two consecutive outers with constraints holding and
        # the inner subproblem solved to optimality (the second pass lets the
        # multiplier update settle the objective)
        ok_streak = ok_streak + 1 if (viol <= eq_tol and result.converged) else 0
        if ok_streak >= 2:
            break
    if result is None:
        # no budget for a single outer (or a resume whose checkpoint already
        # spent it): the warm start or the checkpointed x (zeros without
        # either, as the reference) comes back as an honest
        # budget-exhausted result
        x_ck = (np.asarray(x0, np.float64) if x0 is not None
                else np.zeros((S, n) if multi else n))
        result = SolveResult(
            x=x_ck, objective=problem.objective_np(x_ck),
            gap=np.inf, iterations=0, converged=False,
            trace_f=np.zeros(0), trace_gap=np.zeros(0),
            chunk_times=np.zeros(0), chunk_iters=np.zeros(0),
            stop_reason="budget_exhausted")

    # refine=K: float64 augmented-Lagrangian finishing outers.  Each round
    # solves the CURRENT stacked subproblem to f64 precision with the
    # tangent-space polish (refine_polish: CG on the active-set subspace of
    # [A; sqrt(rho) C], anchored in f64), then updates lam in f64.  This
    # removes the fp32 precision floor once the AL has essentially converged
    # (violation ~1e-7 -> ~5e-13); it does not rescue an AL that stopped far
    # from the constrained optimum on an ill-conditioned instance
    # (oracle_solve_eq or refine_tol do that).
    if refine > 0:
        x = np.asarray(result.x, np.float64)
        # feasibility guard: the exact subproblem optimum can be LESS
        # feasible than the fp32 AL's iterate (the AL trades violation
        # against objective at finite rho): revert wholesale if the rounds
        # end with a worse violation
        x_before, lam_before, viol_before = x.copy(), lam.copy(), viol
        refine_wall = 0.0
        for _ in range(refine):
            sr, b_stacked = stacked_rhs(rho)
            host_stacked = Problem(
                A=VStackMatrix(top=problem.A, bottom=ScaledMatrix(C, sr)),
                b=b_stacked,
                partition=problem.partition,
                name=problem.name + "+eq",
            )
            # no prepared operator when the budget ran out before any outer:
            # the host float64 PCG path polishes instead
            dp_pol = None if dp_cache is None else on_device(dp_cache, sr, b_stacked)
            seed = dc_replace(result, x=x)
            polished = refine_polish(host_stacked, dp_pol, seed, rounds=2)
            refine_wall += polished.refine_secs  # every round's wall counts
            xn = np.asarray(polished.x, np.float64)
            total_iters = total_iters + (polished.iterations - seed.iterations)
            if not np.any(np.abs(xn - x) > 0):
                break  # polish rejected everything: do NOT drift lam
            x = xn
            cx_d = _c_matvec(C, x) - d
            lam = lam + rho * cx_d
            viol = _violation(cx_d, d, p)
            if viol <= 1e-12:
                break
        if viol > viol_before:
            x, lam, viol = x_before, lam_before, viol_before
        result = dc_replace(result, x=x, refine_secs=result.refine_secs + refine_wall)

    # refine_tol: CERTIFIED refine.  Walk to the exact f64 KKT point with
    # prox_bpp_polish (warm from the AL iterate) and certify with the
    # Lagrangian dual bound at the exact multipliers, which evaluates to
    # ~f64 roundoff there.  Beyond that scale the refitted multipliers
    # certify (sound, possibly loose); the certificate is reported either
    # way as ``refine_fw_gap`` — loose never means unsound.
    if refine_tol is not None:
        t_rt = time.perf_counter()
        x_cur = np.asarray(result.x, np.float64)
        lam_cert = lam
        bound = eq_dual_bound(problem, x_cur, lam_cert)
        if bound > refine_tol:
            # tight complementarity (dual_rtol 1e-12, as oracle direct=)
            xp, lamp, ok = prox_bpp_polish(problem, x_cur, dual_rtol=1e-12)
            if ok:
                violp = _violation(_c_matvec(C, xp) - d, d, p)
                # the exact KKT point is feasible to roundoff by
                # construction; keep the guard anyway
                if violp <= max(viol, eq_tol):
                    x_cur, lam_cert, viol = xp, lamp, violp
                    lam = np.asarray(lamp, np.float64)
                    bound = eq_dual_bound(problem, x_cur, lam_cert)
        if bound > refine_tol:
            # refit the multipliers alone on the active face (sparse f64
            # LSMR) and keep whichever lam certifies tighter: both bounds
            # are sound, so the min is sound
            lam_fit = eq_multiplier_polish(problem, x_cur)
            bound_fit = eq_dual_bound(problem, x_cur, lam_fit)
            if bound_fit < bound:
                bound = bound_fit
        result = dc_replace(
            result, x=x_cur,
            refine_secs=result.refine_secs + (time.perf_counter() - t_rt))
        result.refine_fw_gap = float(bound)

    # report the ORIGINAL objective (not the augmented one)
    x = np.asarray(result.x, np.float64)
    result.objective = problem.objective_np(x)
    result.iterations = total_iters
    result.eq_violation = viol
    result.eq_lam = lam
    result.eq_rho = rho
    result.converged = bool(result.converged and viol <= eq_tol)
    if (not result.converged and total_iters >= max_iter
            and result.stop_reason != "budget_exhausted"):
        # make budget-limited terminations visible: converged=False alone
        # does not say WHY
        result.stop_reason = "budget_exhausted"
    return result


def _face_pcg(AF, CF, bids_f, B_blocks: int, b_s, d_s, xa_f, eps: float,
              x_f, max_cg: int = 2000, rtol2: float = 1e-26):
    """Exact-constraint face solve for BPP beyond dense-KKT scale.

    Minimises  0.5||AF y - b||^2 + (eps/2)||y - xa||^2  subject to
    blocksum(y)=1 (per free block) and CF y = d, via projected PCG
    (Gould–Hribar–Nocedal): iterates live in null(G) exactly, because the
    projection (G G^T)^{-1} is computed in closed form — the blocksum rows
    are disjoint (GB GB^T = diag of per-block free counts) and only the
    p x p equality-row Schur complement is dense.  Jacobi (diag A^T A + eps)
    preconditioning; each iteration costs one AF/AF^T pair, O(nnz), no
    factorization — which is what survives random-incidence instances
    whose AF^T AF is an expander with no sparse elimination order.

    Returns (y, mu) with mu = [blocksum multipliers; eq multipliers]
    refitted by least squares on the final stationarity residual.
    """
    import scipy.sparse as sp

    nf = bids_f.size
    p = 0 if CF is None else CF.shape[0]
    AFc = sp.csc_matrix(AF)
    AFr = sp.csr_matrix(AFc)
    dH = np.asarray(AFc.multiply(AFc).sum(axis=0)).ravel() + eps
    dH = np.maximum(dH, 1e-300)
    W = 1.0 / dH  # Jacobi preconditioner weights

    def h_apply(v):
        return AFc.T @ (AFr @ v) + eps * v

    def _ggt_factors(w):
        """Closed-form (G diag(w) G^T)^{-1}: blocksum block is diagonal
        (disjoint rows), equality block is a small dense p x p Schur."""
        Dw = np.bincount(bids_f, weights=w, minlength=B_blocks)
        # ensure_live keeps >= 1 free coordinate per block, so every Dw is
        # positive; a block without one has no feasible face (blocksum = 1
        # needs support), and clamping its Dw would solve another system
        dead = np.nonzero(~(Dw > 0))[0]
        if dead.size:
            raise ValueError(
                f"_face_pcg: block {int(dead[0])} has no free coordinate with "
                f"positive weight (Dw = {Dw[dead[0]]!r}); the face solve needs "
                "at least one per block")
        if not p:
            return Dw, None, None
        Mw = (GB @ (CFt.multiply(w[:, None]))).toarray()  # (B, p)
        CCw = (CFc.multiply(w) @ CFc.T).toarray()
        Sw = CCw - Mw.T @ (Mw / Dw[:, None])
        try:
            import scipy.linalg as sla

            cho = np.linalg.cholesky(Sw)

            def solve_S(v):
                return sla.cho_solve((cho, True), v)
        except np.linalg.LinAlgError:
            Sp = np.linalg.pinv(Sw, rcond=1e-13)

            def solve_S(v):
                return Sp @ v
        return Dw, Mw, solve_S

    if p:
        CFc = sp.csc_matrix(CF)
        CFt = sp.csr_matrix(CFc.T)  # (nf, p)
    GB = sp.csr_matrix((np.ones(nf), (bids_f, np.arange(nf))),
                       shape=(B_blocks, nf))

    def g_apply(v):
        top = np.bincount(bids_f, weights=v, minlength=B_blocks)
        return top, (CFc @ v if p else np.zeros(0))

    def gt_apply(muB, mup):
        out = muB[bids_f]
        if p:
            out = out + CFt @ mup
        return out

    def make_solver(w):
        Dw, Mw, solve_S = _ggt_factors(w)

        def solve(wB, wp):
            if not p:
                return wB / Dw, wp
            mu_p = solve_S(wp - Mw.T @ (wB / Dw))
            return (wB - Mw @ mu_p) / Dw, mu_p

        return solve

    ggt_solve = make_solver(np.ones(nf))  # Euclidean: feasibility + mu fit
    ggtw_solve = make_solver(W)  # preconditioned projection metric

    def proj(v):
        muB, mup = ggt_solve(*g_apply(v))
        return v - gt_apply(muB, mup)

    def prec_proj(r):
        # Nocedal–Wright PPCG preconditioner-projection: solve
        # [diag(dH) G^T; G 0][g; v] = [r; 0]  =>
        # (G W G^T) v = G W r,  g = W (r - G^T v);  G g = 0 exactly.
        # Using the EUCLIDEAN projection of W r here instead (a first
        # cut) breaks the CG conjugacy and stalls the iteration.
        muB, mup = ggtw_solve(*g_apply(W * r))
        return W * (r - gt_apply(muB, mup))

    # feasible start: project the warm x onto {G y = c}
    c_B = np.ones(B_blocks)
    y = np.asarray(x_f, np.float64).copy()
    gB, gp = g_apply(y)
    muB, mup = ggt_solve(c_B - gB, (d_s - gp) if p else gp)
    y = y + gt_apply(muB, mup)
    # Projected PCG on the correction z (y_final = y + z, G z = 0).  The
    # residual is kept EUCLIDEAN-PROJECTED throughout: the raw gradient
    # converges to -G^T mu (O(||g||), never small), and carrying that
    # range(G^T) component through the r @ g inner products floors the
    # attainable accuracy at ~1e-16 * ||G^T mu|| / dH — measured 1e-7 y
    # error on the 60-var unit check.  Projecting r each step keeps the
    # inner products at the scale of the actual optimality residual, which
    # restores f64-roundoff face solves.
    rhs1 = AFc.T @ b_s + eps * xa_f
    r = proj(h_apply(y) - rhs1)
    z = np.zeros(nf)
    g = prec_proj(r)
    d = -g
    rg = float(r @ g)
    rg0 = max(rg, 1e-300)
    for k in range(max_cg):
        if rg <= rtol2 * rg0 or rg <= 0:
            break
        Hd = h_apply(d)
        dHd = float(d @ Hd)
        if dHd <= 0:
            break
        alpha = rg / dHd
        z += alpha * d
        if (k + 1) % 64 == 0:
            # fresh true residual + direction restart: sheds conjugacy
            # loss and null(G) drift
            z = proj(z)
            r = proj(h_apply(y + z) - rhs1)
            g = prec_proj(r)
            rg = float(r @ g)
            d = -g
            continue
        r = proj(r + alpha * Hd)
        g = prec_proj(r)
        rg_new = float(r @ g)
        d = -g + (rg_new / rg) * d
        rg = rg_new
    y = y + proj(z)
    # multipliers: least-squares fit of stationarity, exact via (G G^T)^{-1}
    s_res = h_apply(y) - (AFc.T @ b_s + eps * xa_f)
    muB, mup = ggt_solve(*g_apply(-s_res))
    return y, np.concatenate([muB, mup]) if p else np.concatenate(
        [muB, np.zeros(0)])


def prox_bpp_polish(
    problem: Problem,
    x0: np.ndarray,
    rounds: int = 40,
    eps0_rel: float = 1e-4,
    eps_min_rel: float = 1e-9,
    prox_outers: int = 12,
    max_kkt: int = 100_000,
    dense_kkt: int = 2500,
    dual_rtol: float = 1e-9,
    debug: bool = False,
):
    """Exact float64 constrained optimum at serving scale: a proximal-point
    outer loop over block principal pivoting (Kim & Park's BPP exchange
    strategy for NNLS, arXiv:1102.1006 SS3, extended to the product-simplex
    + Cx=d constraint set) with dense-KKT face solves on the host.

    Solves  min 0.5||Ax-b||^2  s.t. blocksum(x)=1, x>=0 (and Cx=d when the
    problem has equality constraints) to float64 KKT cleanliness:

    1. **Prox outer** k: minimize  ||Ay-b||^2 + eps_k ||y - x_k||^2  over
       the feasible set, with x_k the previous outer's solution and eps_k
       shrinking eps0_rel -> eps_min_rel (relative to mean ||A_col||^2).
       The proximal term is what makes BPP converge on rank-deficient
       route-incidence instances: without it the face LSQ has a null
       space, face solutions carry ~100 arbitrary negative coords, and
       the pin/release exchange cycles indefinitely (measured on the
       16x16 grid config).  Re-anchoring kills the prox bias
       geometrically (measured f trace 2877.19 -> 2870.5061 -> stable to
       1e-9 over outers).
    2. **BPP inner**: exact face solves of the prox objective via ONE
       KKT factorization per exchange round
       ([[H+eps I, G^T],[G, 0]], G = [blocksum rows; C] restricted to the
       free columns); pin every primal violator (y_j < 0), release every
       dual violator (reduced gradient w_j < 0), with the single-swap
       anti-cycling fallback after 3 non-improving full exchanges.
       KKT-clean => exact constrained optimum of the prox subproblem.
       Warm-started, inners after the first converge in 1-2 rounds.
       Face systems up to ``dense_kkt`` dims factor dense
       (``np.linalg.solve``); above that they solve by PROJECTED PCG
       (``_face_pcg`` — no factorization at all; direct sparse factoring
       was measured dead, see its docstring), which is what carries the
       serving fast path past a 3000-dim dense ceiling.

    Returns ``(X, lam, ok)`` with X (S, n) or (n,) matching x0's batch
    shape, lam the equality multipliers ((S, p) / (p,); empty when the
    problem has no C), and ok=False when the path does not apply (KKT
    dimension n + B + p above ``max_kkt``) or an exchange cap was hit.
    The multipliers make the result CERTIFIABLE: at the clean KKT point
    the Lagrangian dual bound  fw_gap(g + C^T lam, x) - lam.(Cx-d)  is a
    sound f(x) - f* bound that evaluates to ~f64 roundoff (the basis of
    eq ``refine_tol`` and ``oracle_solve_eq(direct=True)``).
    """
    import scipy.sparse as sp

    from ..ops.layout import _col_norms_sq

    C = problem.C
    b = np.asarray(problem.b, np.float64)
    x_arr = np.asarray(x0, np.float64)
    multi = x_arr.ndim == 2
    S = x_arr.shape[0] if multi else 1
    p = C.shape[0] if C is not None else 0
    if p:
        d = np.asarray(problem.d, np.float64)
        if multi and d.ndim == 1:
            d = np.broadcast_to(d, (S, p))
    else:
        d = np.zeros((S, 0)) if multi else np.zeros(0)

    part = problem.partition
    sizes = np.asarray(part.sizes, np.int64)
    B_blocks = sizes.size
    n = int(sizes.sum())
    empty_lam = np.zeros((S, 0)) if multi else np.zeros(0)
    if n + B_blocks + p > max_kkt:
        return x_arr, empty_lam, False
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    block_ids = np.repeat(np.arange(B_blocks), sizes)
    A_csr = sp.csr_matrix(problem.A.to_scipy()).astype(np.float64)
    A_csc = A_csr.tocsc()  # column slicing per face: CSC is O(cols picked)
    if p:
        C_csr = sp.csr_matrix(C.to_scipy()).astype(np.float64)
        C_csc = C_csr.tocsc()
    a_scale = float(np.mean(_col_norms_sq(problem.A))) or 1.0

    def ensure_live(free, ref):
        """Every block keeps >= 1 free coord (blocksum=1 needs support)."""
        cnt = np.add.reduceat(free.astype(np.int64), offsets)
        for bidx in np.nonzero(cnt == 0)[0]:
            lo = offsets[bidx]
            free[lo + int(np.argmax(ref[lo:lo + sizes[bidx]]))] = True
        return free

    def bpp(xa, b_s, d_s, eps, rt=dual_rtol):
        """One prox subproblem: BPP face solves (dense or projected-PCG).
        ``rt`` is this call's complementarity cleanliness threshold.
        Returns (y, mu_eq, ok)."""
        x = np.maximum(xa, 0.0)
        free = ensure_live(x > 1e-8, x)
        nbest = np.inf
        patience = 3
        stuck = 0
        rt_eff = rt
        y, mu = x, np.zeros(B_blocks + p)
        for rnd in range(rounds):
            fidx = np.nonzero(free)[0]
            nf = fidx.size
            nc = B_blocks + p
            AF = A_csc[:, fidx]
            if nf + nc > dense_kkt:
                # Sparse face solve by PROJECTED PCG, not factorization.
                # Direct sparse KKT factorization is a dead end here twice
                # over (both measured): SuperLU's partial pivoting
                # on the zero dual block fills catastrophically, and even
                # in quasi-definite SymmetricMode the fill is inherent —
                # H = AF^T AF of a RANDOM incidence matrix is an expander
                # graph with no small separators, so any elimination order
                # densifies (a 24k-dim KKT allocated GBs for >10 min).
                # Instead: Gould–Hribar–Nocedal projected PCG on null(G).
                # The constraint projection is EXACT and cheap because the
                # blocksum rows of G are disjoint: GB GB^T = diag(free
                # counts), so (G G^T)^{-1} reduces to a diagonal solve plus
                # a dense p x p Schur complement (p = #eq rows, small).
                # Each CG iteration is one AF/AF^T pair — O(nnz), no fill.
                y_f, mu = _face_pcg(
                    AF, C_csc[:, fidx] if p else None, block_ids[fidx],
                    B_blocks, b_s, d_s, xa[fidx], eps, x[fidx])
                sol = np.concatenate([y_f, mu])
            else:
                H = (AF.T @ AF).toarray()
                H[np.diag_indices(nf)] += eps
                GB = np.zeros((B_blocks, nf))
                GB[block_ids[fidx], np.arange(nf)] = 1.0
                if p:
                    G = np.vstack([GB, C_csc[:, fidx].toarray()])
                else:
                    G = GB
                KKT = np.zeros((nf + nc, nf + nc))
                KKT[:nf, :nf] = H
                KKT[:nf, nf:] = G.T
                KKT[nf:, :nf] = G
                rhs = np.concatenate([
                    AF.T @ b_s + eps * xa[fidx],
                    np.concatenate([np.ones(B_blocks), d_s]),
                ])
                try:
                    sol = np.linalg.solve(KKT, rhs)
                except np.linalg.LinAlgError:
                    sol, *_ = np.linalg.lstsq(KKT, rhs, rcond=None)
            y = np.zeros(n)
            y[fidx] = sol[:nf]
            mu = sol[nf:]
            g = A_csr.T @ (A_csr @ y - b_s) + eps * (y - xa)
            w_red = g + mu[:B_blocks][block_ids]
            if p:
                w_red = w_red + C_csr.T @ mu[B_blocks:]
            gscale = max(1.0, float(np.abs(w_red).max()))
            prim_bad = free & (y < -1e-12)
            # dual_rtol sets how clean the complementarity signs must be
            # relative to the gradient scale — it bounds the Lagrangian
            # dual-bound deficit (each pinned coord with w in
            # (-dual_rtol*gscale, 0) leaks up to |w| into the
            # certificate).  Serving keeps 1e-9 (latency first);
            # oracle_solve_eq(direct=) passes 1e-12 for a tight bound.
            dual_bad = (~free) & (w_red < -rt_eff * gscale)
            nviol = int(prim_bad.sum() + dual_bad.sum())
            if debug:
                print(f"[bpp] rnd={rnd} prim={int(prim_bad.sum())} "
                      f"dual={int(dual_bad.sum())} free={nf} eps={eps:.1e} "
                      f"rt={rt_eff:.0e}")
            if nviol == 0:
                return np.maximum(y, 0.0), mu[B_blocks:], True
            if nviol < nbest:
                nbest, patience = nviol, 3
            else:
                patience -= 1
            if patience >= 0:  # full block exchange
                free = (free & ~prim_bad) | dual_bad
            else:  # anti-cycling: exchange only the single worst violator
                stuck += 1
                if stuck >= 12 and nviol > 32:
                    # single swaps move one coordinate per round; a
                    # 100+-violator set that full exchanges could not
                    # shrink is structurally unreachable this way — bail
                    # now instead of burning the remaining rounds
                    return np.maximum(y, 0.0), mu[B_blocks:], False
                if stuck % 3 == 0 and rt_eff < 1e-5:
                    # degenerate ties: near-zero duals flip sign with the
                    # face and the single-swap walk 2-cycles (measured:
                    # warm 3k-dim requests burned all 40 rounds on
                    # (1,10)<->(0,7) oscillations).  Widen the
                    # complementarity deadband — the tolerated |w| leaks
                    # into the SOUND dual-bound certificate instead of
                    # failing the whole polish.
                    rt_eff *= 10.0
                cand = np.maximum(np.where(prim_bad, -y, -np.inf),
                                  np.where(dual_bad, -w_red, -np.inf))
                j = int(np.argmax(cand))
                free = free.copy()
                free[j] = ~free[j]
            free = ensure_live(free, y)
            x = np.maximum(y, 0.0)
        return np.maximum(y, 0.0), mu[B_blocks:], False

    X = np.atleast_2d(x_arr).copy()
    B_rhs = np.atleast_2d(b)
    D_tgt = np.atleast_2d(d)
    lam_out = np.zeros((S, p))
    X_out = np.zeros_like(X)

    for s in range(S):
        x = np.maximum(X[s], 0.0)
        eps_rel = eps0_rel
        f_prev = None
        lam_s = np.zeros(p)
        certified = False
        capouts = 0  # consecutive exchange cap-outs: fail fast when stuck
        for k in range(prox_outers):
            # Complementarity cleanliness is only needed at the FINAL
            # (eps_min) subproblem — the one the certificate is read from.
            # Intermediate outers use a loose threshold (1e-6): chasing
            # 1e-9-marginal dual violators on a face that the next eps
            # shrink will reshuffle anyway is what made warm 2%-perturbed
            # requests 2-cycle to the 40-round cap at ~3k KKT dims
            # (measured).  An exchange
            # cap-out at an intermediate eps likewise keeps the best face
            # and continues the ladder instead of aborting the polish.
            final = eps_rel <= eps_min_rel
            rt = dual_rtol if final else max(dual_rtol, 1e-6)
            y, lam_s, ok = bpp(x, B_rhs[s], D_tgt[s], eps_rel * a_scale,
                               rt)
            if not ok and final:
                return x_arr, empty_lam, False
            if ok:
                capouts = 0
            else:
                capouts += 1
                if capouts >= 2:
                    # two straight cap-outs: the exchange is chasing a
                    # structurally wrong face (e.g. hundreds of primal
                    # violators on a rank-deficient instance after an RHS
                    # shift) — burning the rest of the ladder costs
                    # 40 rounds per remaining outer for nothing.  Fail
                    # fast; the caller's full AL solve handles it.
                    return x_arr, empty_lam, False
            certified = ok and final
            f = 0.5 * float(np.sum((A_csr @ y - B_rhs[s]) ** 2))
            if debug:
                print(f"[bpp] s={s} prox k={k} eps_rel={eps_rel:.1e} "
                      f"f={f:.9g} move={float(np.abs(y - x).max()):.2e}")
            x = y
            if (certified and f_prev is not None
                    and abs(f_prev - f) <= 1e-10 * max(1.0, abs(f))):
                break
            f_prev = f
            eps_rel = max(eps_rel / 10.0, eps_min_rel)
        if not certified:
            # ladder ended without a clean tight-complementarity solve
            return x_arr, empty_lam, False
        X_out[s] = x
        lam_out[s] = lam_s

    if multi:
        return X_out, lam_out, True
    return X_out[0], lam_out[0], True


def eq_multiplier_polish(problem: Problem, x: np.ndarray,
                         thresh: float = 1e-10) -> np.ndarray:
    """Dual-only polish: refit the equality multipliers at a FIXED iterate
    so ``eq_dual_bound`` tightens where ``prox_bpp_polish`` cannot run
    (KKT dimension above ``max_kkt``).

    At an (approximate) constrained optimum, stationarity on the active
    face reads  g_j + (C^T lam)_j + mu_{b(j)} = 0  for every free coord j
    (g = A^T(Ax-b)); the AL's running multipliers satisfy this only as
    well as the penalty converged, which is why the raw AL dual bound can
    be sound-but-useless on perturbed instances.  This refits (lam, mu) by sparse float64 LSMR on
    exactly that system, restricted to the free coords x_j > ``thresh``:
    one least-squares solve in (p + B) unknowns with nnz(C_F) + nf
    nonzeros — seconds at any scale the framework handles, no
    factorization of n-dimensional systems.  Any lam gives a SOUND
    ``eq_dual_bound`` (the bound optimises the simplex multipliers mu
    internally via the blockwise FW min), so the caller simply keeps
    whichever of {AL lam, refitted lam} certifies tighter.

    Returns lam with x0's batch shape ((p,) or (S, p)).
    """
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    C = problem.C
    if C is None:
        raise ValueError("problem has no equality constraints")
    p = C.shape[0]
    A_csr = sp.csr_matrix(problem.A.to_scipy()).astype(np.float64)
    C_csr = sp.csr_matrix(C.to_scipy()).astype(np.float64)
    sizes = np.asarray(problem.partition.sizes, np.int64)
    B_blocks = sizes.size
    block_ids = np.repeat(np.arange(B_blocks), sizes)
    X = np.atleast_2d(np.asarray(x, np.float64))
    B_rhs = np.atleast_2d(np.asarray(problem.b, np.float64))
    S = X.shape[0]
    lam_out = np.zeros((S, p))
    for s in range(S):
        g = A_csr.T @ (A_csr @ X[s] - B_rhs[s])
        free = np.nonzero(X[s] > thresh)[0]
        nf = free.size
        if nf == 0:
            continue
        # rows: free coords; cols: [lam (p), mu (B)]; solve
        # min || C_F^T lam + E_F mu + g_F ||_2 in sparse f64
        Ct = C_csr.T.tocsr()[free]  # (nf, p)
        E = sp.csr_matrix(
            (np.ones(nf), (np.arange(nf), block_ids[free])),
            shape=(nf, B_blocks))
        M = sp.hstack([Ct, E], format="csr")
        sol = spla.lsmr(M, -g[free], atol=1e-14, btol=1e-14,
                        maxiter=4 * (p + B_blocks))[0]
        lam_out[s] = sol[:p]
    return lam_out if np.asarray(x).ndim == 2 else lam_out[0]


def eq_dual_bound(problem: Problem, x: np.ndarray, lam: np.ndarray) -> float:
    """Sound Lagrangian dual bound  f(x) - f* <= bound  for the
    eq-constrained problem (worst scenario for multi-RHS), relative to
    max(1, |f|).  With multipliers lam,

        q(lam) = min_{v in product-of-simplices} f(v) + lam.(Cv - d)
               >= [f(x) + lam.(Cx - d)] - gap_FW(grad f(x) + C^T lam, x)

    so  f(x) - f* <= f(x) - q(lam) <= gap_FW(...) - lam.(Cx - d).  At a
    clean KKT point (prox_bpp_polish) this evaluates to ~f64 roundoff.
    """
    import scipy.sparse as sp

    from ..models.oracle import fw_gap_np

    A_csr = sp.csr_matrix(problem.A.to_scipy()).astype(np.float64)
    sizes = problem.partition.sizes
    X = np.atleast_2d(np.asarray(x, np.float64))
    B_rhs = np.atleast_2d(np.asarray(problem.b, np.float64))
    S = X.shape[0]
    p = problem.C.shape[0] if problem.C is not None else 0
    if p:
        C_csr = sp.csr_matrix(problem.C.to_scipy()).astype(np.float64)
        d = np.asarray(problem.d, np.float64)
        if d.ndim == 1:
            d = np.broadcast_to(d, (S, p))
        lam2 = np.atleast_2d(np.asarray(lam, np.float64))
    worst = 0.0
    for s in range(S):
        r = A_csr @ X[s] - B_rhs[s]
        f = 0.5 * float(r @ r)
        gL = A_csr.T @ r
        comp = 0.0
        if p:
            gL = gL + C_csr.T @ lam2[s]
            comp = float(lam2[s] @ (C_csr @ X[s] - d[s]))
        bound = fw_gap_np(gL, X[s], sizes) - comp
        worst = max(worst, bound / max(1.0, abs(f)))
    return worst


def solve_eq_sensitivity(
    problem: Problem,
    x0: np.ndarray,
    rho: float = 1.0,
    rounds: int = 40,
    eq_tol: float = 1e-6,
    eps0_rel: float = 1e-4,
    eps_min_rel: float = 1e-9,
    prox_outers: int = 12,
    max_kkt: int = 100_000,
    debug: bool = False,
):
    """Sensitivity fast path for STREAMING equality-constrained requests:
    warm-started ``prox_bpp_polish`` (proximal-point block principal
    pivoting, dense-KKT face solves, all float64 on the host).

    Given a previously CONVERGED request's iterate x0 and a nearby
    right-hand side, the new optimum sits on a mostly-unchanged active
    face, so instead of re-running fp32 AL inner solves (6-8 outers for a
    2% b drift on the grid instance) the active-set method walks to the new
    exact f64 KKT point in a handful of face solves.

    Returns a converged SolveResult (stop_reason="sensitivity"), or
    ``None`` when the path does not apply — instance beyond dense-KKT
    scale (``max_kkt``), exchange-round cap, or final violation above
    ``eq_tol`` — in which case the caller falls back to the full AL
    solve.  ``rho`` passes through to ``eq_rho`` so the serving warm
    cache keeps a consistent AL state for a later full solve.
    """
    import time as _time

    from .base import SolveResult

    t0 = _time.perf_counter()
    C = problem.C
    p = C.shape[0]
    d = np.asarray(problem.d, np.float64)
    x_res, lam, ok = prox_bpp_polish(
        problem, x0, rounds=rounds, eps0_rel=eps0_rel,
        eps_min_rel=eps_min_rel, prox_outers=prox_outers, max_kkt=max_kkt,
        debug=debug,
    )
    if not ok:
        return None
    multi = np.asarray(x0).ndim == 2
    if multi and d.ndim == 1:
        d = np.broadcast_to(d, (x_res.shape[0], p))
    dref = max(1.0, float(np.abs(d).max())) if p else 1.0
    viol = float(np.abs(_c_matvec(C, x_res) - d).max()) / dref if p else 0.0
    if viol > eq_tol:
        return None  # certificate failed: caller runs the full AL solve
    # the exact multipliers come for free from the KKT walk; one matvec
    # pair turns them into a shipped optimality certificate, so streaming
    # responses are self-certifying
    bound = eq_dual_bound(problem, x_res, lam)
    out = SolveResult(
        x=x_res,
        objective=problem.objective_np(x_res),
        gap=np.inf,
        iterations=0,
        converged=True,
        trace_f=np.zeros(0),
        trace_gap=np.zeros(0),
        chunk_times=np.zeros(0),
        chunk_iters=np.zeros(0),
        eq_violation=viol,
        stop_reason="sensitivity",
        refine_secs=_time.perf_counter() - t0,
        refine_fw_gap=float(bound),
    )
    out.eq_lam = lam
    out.eq_rho = float(rho)
    return out
