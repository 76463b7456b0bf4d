"""Projected L-BFGS solver (x-space sort-projection or z-space PAVA).

Scheme per iteration:

  1. the limited-memory inverse-Hessian product q = H g is evaluated in
     the COMPACT representation (Byrd, Nocedal & Schnabel, "Representations
     of quasi-Newton matrices...", Math. Prog. 63, 1994):

         H = gamma I + [S  gamma Y] W [S  gamma Y]^T,
         W = [[R^{-T}(D + gamma Y^T Y)R^{-1},  -R^{-T}], [-R^{-1}, 0]]

     with R = triu(S^T Y), D = diag(S^T Y).  This needs two batched
     (M, n) @ (n,) history products and two MxM triangular solves, where
     the classic two-loop recursion is 2M strictly dependent dot+AXPY
     stages.  The two-loop is kept below as the cross-check oracle.
  2. candidate = proj(x - q)  (sort-projection in x-space, bounded
     isotonic/PAVA in z-space) — the projection-arc direction
     d = candidate - x is tested for descent (g.d < 0) and otherwise
     replaced by the plain projected-gradient direction at step 1/L;
  3. exact quadratic line search along d (closed form) — monotone descent
     by construction.

The pair history lives in two SHIFT buffers (newest pair at index M-1)
plus MxM Gram buffers S^T Y and Y^T Y maintained incrementally.
Empty/rejected slots carry rho = 0 and are masked out of the Gram matrices
(their R diagonal is pinned to 1 so the triangular solves pass zeros
through).  On a convex quadratic the curvature condition s.y > 0 holds
wherever s != 0 (y = A^T A s), so pairs are only rejected at numerical
noise level.

Counterpart of ``bsls_tpu/solvers/lbfgs.py``.  Where the reference keeps
(M, n) histories per scenario under ``vmap``, this state holds (S, M, n)
histories, (S, M, M) Grams and (S, M) ring validity: every mask, pinned
diagonal and triangular solve is each scenario's own, and the history
products are batched matrix products at full fp32.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..ops import isotonic, layout as L, projection, quadratic as Q, ztransform as Z
from .base import SolveOptions, fw_gap
from .pgd import _dz_forward, _rhs as rhs

__all__ = ["LBFGSState", "init", "step", "refresh", "compact_hg", "two_loop_hg",
           "update_pairs"]


@dataclass(frozen=True)
class LBFGSState:
    xp: tuple
    r: torch.Tensor
    f: torch.Tensor
    gap: torch.Tensor
    k: torch.Tensor  # (S,)
    u_prev: torch.Tensor  # (S, n_pf) previous iterate (x- or z-space)
    g_prev: torch.Tensor  # (S, n_pf) previous gradient (same space)
    s_hist: torch.Tensor  # (S, M, n_pf) shift buffer of iterate differences (newest last)
    y_hist: torch.Tensor  # (S, M, n_pf) shift buffer of gradient differences
    rho_hist: torch.Tensor  # (S, M) 1/(s.y), 0 marks an empty/rejected slot
    sty: torch.Tensor  # (S, M, M) Gram s_i . y_j (maintained incrementally)
    yty: torch.Tensor  # (S, M, M) Gram y_i . y_j
    gamma: torch.Tensor  # (S,) H0 scaling (s.y)/(y.y) of the newest pair


# how each field lies on a mesh (parallel/sharding.py::leaf_layout)
LBFGSState.SHARD_KINDS = {
    "xp": "x", "r": "r", "f": "scalar", "gap": "scalar", "k": "scalar",
    "u_prev": "xflat", "g_prev": "xflat",
    "s_hist": "xflat_hist", "y_hist": "xflat_hist",
    "rho_hist": "hist", "sty": "gram", "yty": "gram",
    "gamma": "scalar",
}


def compact_hg(dp, g_flat: torch.Tensor, st: LBFGSState) -> torch.Tensor:
    """q = H g via the compact (BNS) representation — two batched history
    products + two MxM triangular solves per scenario."""
    zero = torch.zeros((), dtype=g_flat.dtype, device=g_flat.device)
    valid = st.rho_hist > 0  # (S, M)
    pair_mask = valid[:, :, None] & valid[:, None, :]
    u = torch.where(valid, L.xmatdot(dp, st.s_hist, g_flat), zero)
    v = torch.where(valid, L.xmatdot(dp, st.y_hist, g_flat), zero)
    # R = triu(S^T Y) over valid pairs; invalid diagonal pinned to 1 so the
    # solves carry zeros through those slots
    R = torch.triu(torch.where(pair_mask, st.sty, zero))
    R = R + torch.diag_embed(torch.where(valid, zero, torch.ones_like(zero)))
    D = torch.where(valid, torch.diagonal(st.sty, dim1=-2, dim2=-1), zero)
    YtY = torch.where(pair_mask, st.yty, zero)
    gamma = st.gamma[:, None]
    w1 = torch.linalg.solve_triangular(R, u[..., None], upper=True)[..., 0]  # R^{-1} u
    t = D * w1 + gamma * torch.matmul(YtY, w1[..., None])[..., 0] - gamma * v
    p = torch.linalg.solve_triangular(R.transpose(-1, -2), t[..., None],
                                      upper=False)[..., 0]  # R^{-T} t
    hp = torch.matmul(p[:, None, :], st.s_hist)[:, 0]  # sum_m p_m s_m
    hw = torch.matmul(w1[:, None, :], st.y_hist)[:, 0]
    return gamma * g_flat + hp - gamma * hw


def two_loop_hg(dp, g_flat: torch.Tensor, st: LBFGSState) -> torch.Tensor:
    """q = H g via the classic two-loop recursion (Nocedal & Wright ch.
    7.2) — 2M serially dependent stages.  Kept as the cross-check oracle
    for ``compact_hg``."""
    M = st.rho_hist.shape[-1]
    zero = torch.zeros((), dtype=g_flat.dtype, device=g_flat.device)
    q = g_flat
    stages = []
    for t in range(M):
        j = M - 1 - t
        s, y, rho = st.s_hist[:, j], st.y_hist[:, j], st.rho_hist[:, j]
        alpha = torch.where(rho > 0, rho * L.xdot(dp, s, q), zero)
        q = q - alpha[:, None] * y
        stages.append((j, alpha))
    q = st.gamma[:, None] * q
    for j, alpha in reversed(stages):
        s, y, rho = st.s_hist[:, j], st.y_hist[:, j], st.rho_hist[:, j]
        beta = torch.where(rho > 0, rho * L.xdot(dp, y, q), zero)
        q = q + s * (alpha - beta)[:, None]
    return q


def init(dp: L.DeviceProblem, L_est, opts: SolveOptions, xp0=None) -> LBFGSState:
    if opts.line_search not in ("exact",):
        raise ValueError(
            f"method 'lbfgs' does not support line_search={opts.line_search!r}; "
            "the quasi-Newton arc always uses the exact quadratic line search"
        )
    if opts.step_size > 0:
        raise ValueError(
            "method 'lbfgs' ignores step_size; the trial step is H g from "
            "the curvature memory (use method='pgd' for fixed steps)"
        )
    b = rhs(dp)
    S = b.shape[0]
    xp = xp0 if xp0 is not None else L.feasible_init(dp, scenarios=S)
    x_flat = L.padded_to_flat(dp, xp)
    r = Q.residual(dp, x_flat, b)
    f = Q.objective_from_residual(dp, r)
    M = max(int(opts.lbfgs_mem), 1)
    n = x_flat.shape[-1]
    kw = dict(dtype=x_flat.dtype, device=x_flat.device)
    return LBFGSState(
        xp=xp, r=r, f=f,
        gap=torch.full_like(f, float("inf")),
        k=torch.zeros(f.shape, dtype=torch.int32, device=f.device),
        u_prev=x_flat,
        g_prev=torch.zeros_like(x_flat),
        s_hist=torch.zeros((S, M, n), **kw),
        y_hist=torch.zeros((S, M, n), **kw),
        rho_hist=torch.zeros((S, M), **kw),
        sty=torch.zeros((S, M, M), **kw),
        yty=torch.zeros((S, M, M), **kw),
        gamma=torch.full_like(f, 1.0 / float(L_est)),
    )


def refresh(dp, st: LBFGSState, L_est, opts: SolveOptions) -> LBFGSState:
    r = Q.residual(dp, L.padded_to_flat(dp, st.xp), rhs(dp))
    return replace(st, r=r, f=Q.objective_from_residual(dp, r))


def _shift_gram(G: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Shift each (M, M) Gram buffer of (S, M, M) up-left and write the new
    last row/col (the column last, so that it owns the corner)."""
    out = torch.zeros_like(G)
    out[:, :-1, :-1] = G[:, 1:, 1:]
    out[:, -1, :] = row
    out[:, :, -1] = col
    return out


def update_pairs(dp, st: LBFGSState, u_flat: torch.Tensor, gu_flat: torch.Tensor) -> LBFGSState:
    """Append the (s, y) pair from the previous iterate to the shift
    buffers and maintain the MxM Gram matrices incrementally."""
    s = u_flat - st.u_prev
    y = gu_flat - st.g_prev
    sy = L.xdot(dp, s, y)
    ss = L.xdot(dp, s, s)
    yy = L.xdot(dp, y, y)
    valid = (st.k > 0) & (sy > 1e-10 * torch.sqrt(ss * yy) + 1e-30)
    zero = torch.zeros((), dtype=s.dtype, device=s.device)
    rho_new = torch.where(valid, 1.0 / torch.clamp(sy, min=1e-30), zero)
    s_m = torch.where(valid[:, None], s, zero)
    y_m = torch.where(valid[:, None], y, zero)
    # shift (drop oldest, append newest)
    s_hist = torch.cat([st.s_hist[:, 1:], s_m[:, None]], dim=1)
    y_hist = torch.cat([st.y_hist[:, 1:], y_m[:, None]], dim=1)
    rho_hist = torch.cat([st.rho_hist[:, 1:], rho_new[:, None]], dim=1)
    # Gram updates: one batched product per matrix against the new pair
    sty = _shift_gram(st.sty, L.xmatdot(dp, y_hist, s_m),  # s_new . y_j
                      L.xmatdot(dp, s_hist, y_m))          # s_i . y_new
    row_y = L.xmatdot(dp, y_hist, y_m)
    yty = _shift_gram(st.yty, row_y, row_y)
    gamma = torch.where(valid, sy / torch.clamp(yy, min=1e-30), st.gamma)
    return replace(st, s_hist=s_hist, y_hist=y_hist, rho_hist=rho_hist,
                   sty=sty, yty=yty, gamma=gamma)


def step(dp, st: LBFGSState, L_est, opts: SolveOptions) -> LBFGSState:
    x_flat = L.padded_to_flat(dp, st.xp)
    g_flat = Q.grad_flat(dp, st.r)
    gp = L.flat_to_padded(dp, g_flat)
    gap = fw_gap(dp, g_flat, x_flat, gp)
    zspace = opts.space == "z"

    if zspace:
        # reparametrise: u = z (order simplex), grad_u = D^T g
        zp = tuple(Z.x_to_z_padded(x, bk.mask) for x, bk in zip(st.xp, dp.buckets))
        gzp = tuple(Z.dz_adjoint_padded(g, bk.mask) for g, bk in zip(gp, dp.buckets))
        u_flat = L.padded_to_flat(dp, zp)
        gu_flat = L.padded_to_flat(dp, gzp)
    else:
        u_flat, gu_flat = x_flat, g_flat

    st = update_pairs(dp, st, u_flat, gu_flat)

    # ---- quasi-Newton projection-arc candidate ----
    qp = L.flat_to_padded(dp, compact_hg(dp, gu_flat, st))
    t0 = Q.inv_lipschitz(L_est, st.f)[:, None, None]
    if zspace:
        def arc(yp):
            zhat = isotonic.pava_blocks(yp, dp.buckets)
            return _dz_forward(tuple(zh - z for zh, z in zip(zhat, zp)), dp.buckets)

        d_qn = arc(tuple(z - dq for z, dq in zip(zp, qp)))
        d_gd = arc(tuple(z - t0 * g for z, g in zip(zp, gzp)))
    else:
        xhat_qn = projection.proj_blocks(
            tuple(x - dq for x, dq in zip(st.xp, qp)), dp.buckets)
        xhat_gd = projection.proj_blocks(
            tuple(x - t0 * g for x, g in zip(st.xp, gp)), dp.buckets)
        d_qn = tuple(xh - x for xh, x in zip(xhat_qn, st.xp))
        d_gd = tuple(xh - x for xh, x in zip(xhat_gd, st.xp))

    # descent safeguard: keep the QN arc only if it is a descent direction
    use_qn = (L.xdot(dp, g_flat, L.padded_to_flat(dp, d_qn)) < -1e-30)[:, None, None]
    dxp = tuple(torch.where(use_qn, a, b) for a, b in zip(d_qn, d_gd))

    # ---- exact quadratic line search along the chosen direction ----
    d_flat = L.padded_to_flat(dp, dxp)
    Ad = L.matvec_ps(dp, d_flat)
    t = Q.exact_step(dp, L.xdot(dp, g_flat, d_flat), Ad, 0.0, 1.0)

    tb = t[:, None, None]
    xp_new = tuple(x + tb * d for x, d in zip(st.xp, dxp))
    r_new = st.r + t[:, None] * Ad
    return replace(st, xp=xp_new, r=r_new, f=Q.objective_from_residual(dp, r_new), gap=gap,
                   k=st.k + 1, u_prev=u_flat, g_prev=gu_flat)
