"""Frank-Wolfe (conditional gradient) solver, plus the pairwise variant.

LMO on a product of simplices is the per-block vertex argmin; the duality
gap g.(x - s) falls out for free and is the convergence certificate.  Step
via the closed-form quadratic line search (default) or the classic 2/(k+2)
schedule (line_search="fixed").

``method="afw"`` (aliases "pairwise", "pairwise_fw") runs **pairwise
Frank-Wolfe**: weight moves from the per-block away vertex (worst support
coordinate) to the FW vertex, which restores linear convergence on
polytopes (Lacoste-Julien & Jaggi, arXiv:1511.05932) where plain FW
zig-zags sublinearly.  On a simplex the active set is just supp(x), so the
away vertex costs one masked argmax per block (see
ops.simplex.pairwise_direction_padded).  Plain-FW steps are mixed in every
``_FW_MIX`` iterations to retain FW's global-progress guarantee when the
support is badly initialised.

Counterpart of ``bsls_tpu/solvers/frank_wolfe.py``.  Every field has a
leading scenario axis S; the iteration counter ``k`` is an (S,) tensor, so
the plain-FW mix is chosen per scenario with ``torch.where``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import layout as L, quadratic as Q
from ..ops.simplex import fw_vertex, pairwise_direction
from .base import PAIRWISE, SolveOptions
from .pgd import _rhs as rhs

__all__ = ["FWState", "init", "step", "refresh"]

_FW_MIX = 8  # in afw mode, take a plain-FW step every _FW_MIX iterations


@dataclass(frozen=True)
class FWState:
    xp: tuple
    r: torch.Tensor
    f: torch.Tensor
    gap: torch.Tensor
    k: torch.Tensor  # (S,)
    qp: tuple | None = None  # diag(A^T A) per bucket (Bk, w), pairwise mode only


def init(dp: L.DeviceProblem, L_est, opts: SolveOptions, xp0=None) -> FWState:
    b = rhs(dp)
    xp = xp0 if xp0 is not None else L.feasible_init(dp, scenarios=b.shape[0])
    r = Q.residual(dp, L.padded_to_flat(dp, xp), b)
    f = Q.objective_from_residual(dp, r)
    # the pairwise transfer sizes need diag(A^T A): one pass over A per solve
    qp = Q.diag_quad(dp) if opts.method in PAIRWISE else None
    return FWState(xp=xp, r=r, f=f, gap=torch.full_like(f, float("inf")),
                   k=torch.zeros(f.shape, dtype=torch.int32, device=f.device), qp=qp)


def refresh(dp, st: FWState, L_est, opts: SolveOptions) -> FWState:
    r = Q.residual(dp, L.padded_to_flat(dp, st.xp), rhs(dp))
    return FWState(xp=st.xp, r=r, f=Q.objective_from_residual(dp, r), gap=st.gap, k=st.k,
                   qp=st.qp)


def step(dp, st: FWState, L_est, opts: SolveOptions) -> FWState:
    pairwise = opts.method in PAIRWISE
    g_flat = Q.grad_flat(dp, st.r)
    gp = L.flat_to_padded(dp, g_flat)
    sp = fw_vertex(gp, dp.buckets)
    d_fw = tuple(s - x for s, x in zip(sp, st.xp))
    d_fw_flat = L.padded_to_flat(dp, d_fw)
    g_dot_dfw = L.xdot(dp, g_flat, d_fw_flat)
    # exact FW duality gap: g.(x - s) = -g.d — valid certificate either way
    gap = -g_dot_dfw

    if pairwise:
        d_pw = pairwise_direction(st.xp, gp, dp.buckets, st.qp)
        # periodic plain-FW step keeps global progress when the away steps
        # alone would shuffle weight pair-by-pair within blocks
        use_fw = (st.k % _FW_MIX) == (_FW_MIX - 1)
        fw3 = use_fw[:, None, None]
        dxp = tuple(torch.where(fw3, df, dw) for df, dw in zip(d_fw, d_pw))
        d_flat = L.padded_to_flat(dp, dxp)
        g_dot_d = torch.where(use_fw, g_dot_dfw, L.xdot(dp, g_flat, d_flat))
    else:
        dxp, d_flat, g_dot_d = d_fw, d_fw_flat, g_dot_dfw

    Ad = L.matvec(dp.A, d_flat)
    if opts.line_search == "fixed" and not pairwise:
        t = 2.0 / (st.k.to(g_flat.dtype) + 2.0)
    else:
        t = Q.exact_step(dp, g_dot_d, Ad, 0.0, 1.0)
    tb = t[:, None, None]
    xp_new = tuple(x + tb * d for x, d in zip(st.xp, dxp))
    r_new = st.r + t[:, None] * Ad
    return FWState(xp=xp_new, r=r_new, f=Q.objective_from_residual(dp, r_new), gap=gap,
                   k=st.k + 1, qp=st.qp)
