"""Accelerated projected gradient (monotone FISTA with restart).

Nesterov momentum over the projected-gradient map, with a monotone
safeguard: a candidate that increases f is rejected and the momentum is
restarted from the current iterate.  Residuals at both the iterate x and
the extrapolated point y are carried incrementally (r is affine in x), so
one iteration costs the same two matvec-equivalents as plain PGD while
converging O(1/k^2).

Counterpart of ``bsls_tpu/solvers/apgd.py``.  Every field has a leading
scenario axis S; the acceptance test and the momentum are per scenario
(``torch.where`` on (S,) tensors, no host branch).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import layout as L, projection, quadratic as Q
from .base import SolveOptions, fw_gap
from .pgd import _rhs as rhs

__all__ = ["APGDState", "init", "step", "refresh"]


@dataclass(frozen=True)
class APGDState:
    xp: tuple  # current iterate x_k, per bucket (S, Bk, w)
    yp: tuple  # extrapolated point y_k
    r: torch.Tensor  # (S, m) residual at x_k
    ry: torch.Tensor  # (S, m) residual at y_k
    f: torch.Tensor  # (S,) f(x_k)
    gap: torch.Tensor  # (S,)
    k: torch.Tensor  # (S,) iterations taken
    t_mom: torch.Tensor  # (S,) momentum parameter


def init(dp: L.DeviceProblem, L_est, opts: SolveOptions, xp0=None) -> APGDState:
    # APGD steps with the fixed 1/L (or opts.step_size) FISTA step; the PGD
    # line-search modes would silently not apply, so reject them up front
    if opts.line_search in ("bb", "pava"):
        raise ValueError(
            f"method 'apgd' does not support line_search={opts.line_search!r}; "
            "use 'exact'/'fixed' (both mean the FISTA 1/L step) or method 'pgd'"
        )
    if opts.space != "x":
        raise ValueError("method 'apgd' supports space='x' only")
    b = rhs(dp)
    xp = xp0 if xp0 is not None else L.feasible_init(dp, scenarios=b.shape[0])
    r = Q.residual(dp, L.padded_to_flat(dp, xp), b)
    f = Q.objective_from_residual(dp, r)
    return APGDState(
        xp=xp, yp=xp, r=r, ry=r, f=f,
        gap=torch.full_like(f, float("inf")),
        k=torch.zeros(f.shape, dtype=torch.int32, device=f.device),
        t_mom=torch.ones_like(f),
    )


def refresh(dp, st: APGDState, L_est, opts: SolveOptions) -> APGDState:
    b = rhs(dp)
    r = Q.residual(dp, L.padded_to_flat(dp, st.xp), b)
    ry = Q.residual(dp, L.padded_to_flat(dp, st.yp), b)
    return APGDState(xp=st.xp, yp=st.yp, r=r, ry=ry, f=Q.objective_from_residual(dp, r),
                     gap=st.gap, k=st.k, t_mom=st.t_mom)


def step(dp, st: APGDState, L_est, opts: SolveOptions) -> APGDState:
    g_flat = Q.grad_flat(dp, st.ry)  # gradient at y
    gp = L.flat_to_padded(dp, g_flat)
    y_flat = L.padded_to_flat(dp, st.yp)
    gap = fw_gap(dp, g_flat, y_flat, gp)

    step_t = opts.step_size if opts.step_size > 0 else 1.0 / float(L_est)
    xhat = projection.proj_blocks(tuple(y - step_t * g for y, g in zip(st.yp, gp)),
                                  dp.buckets)
    d_flat = L.padded_to_flat(dp, tuple(xh - y for xh, y in zip(xhat, st.yp)))
    r_cand = st.ry + L.matvec(dp.A, d_flat)
    f_cand = Q.objective_from_residual(dp, r_cand)

    # monotone safeguard: keep the candidate only if it does not increase f
    accept = f_cand <= st.f
    acc3 = accept[:, None, None]
    xp_new = tuple(torch.where(acc3, xh, x) for xh, x in zip(xhat, st.xp))
    r_new = torch.where(accept[:, None], r_cand, st.r)
    f_new = torch.where(accept, f_cand, st.f)

    t_next = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * st.t_mom * st.t_mom))
    beta = torch.where(accept, (st.t_mom - 1.0) / t_next, torch.zeros_like(t_next))
    t_next = torch.where(accept, t_next, torch.ones_like(t_next))  # restart on rejection

    b3 = beta[:, None, None]
    yp_new = tuple(x + b3 * (x - xo) for x, xo in zip(xp_new, st.xp))
    ry_new = r_new + beta[:, None] * (r_new - st.r)  # r is affine in x
    return APGDState(xp=xp_new, yp=yp_new, r=r_new, ry=ry_new, f=f_new, gap=gap,
                     k=st.k + 1, t_mom=t_next)
