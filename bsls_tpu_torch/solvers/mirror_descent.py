"""Entropic mirror descent / exponentiated gradient solver.

The EG update x <- x * exp(-t g), renormalised per block, needs no
projection kernel at all.  Modes:
  exact (default) — EG proposal, then closed-form quadratic step along the
                    segment d = x_eg - x (monotone descent)
  bb              — spectral mirror descent: the proposal's mirror step is
                    the Barzilai-Borwein length t_BB = (s.s)/(s.y) instead
                    of 1/L, with the same exact-segment safeguard.
  fixed           — classic EG with constant step (opts.step_size or 1/L)

No step policy makes EG competitive with pgd/bb on a general least-squares
quadratic: entropic MD is O(R_KL * L_inf / k) on smooth problems and
converges linearly only under relative strong convexity w.r.t. the entropy.
It stays in the suite as the mirror-descent configuration; for production
use pgd/bb.

Counterpart of ``bsls_tpu/solvers/mirror_descent.py``.  Every field has a
leading scenario axis S; step sizes are (S,) tensors.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import layout as L, quadratic as Q
from ..ops.simplex import eg_update
from .base import SolveOptions, fw_gap
from .pgd import _rhs as rhs

__all__ = ["EGState", "init", "step", "refresh"]


@dataclass(frozen=True)
class EGState:
    xp: tuple
    r: torch.Tensor
    f: torch.Tensor
    gap: torch.Tensor
    k: torch.Tensor  # (S,)
    x_prev: torch.Tensor  # (S, n_pf) previous iterate (BB spectral step)
    g_prev: torch.Tensor  # (S, n_pf) previous gradient


def init(dp: L.DeviceProblem, L_est, opts: SolveOptions, xp0=None) -> EGState:
    b = rhs(dp)
    xp = xp0 if xp0 is not None else L.feasible_init(dp, scenarios=b.shape[0])
    x_flat = L.padded_to_flat(dp, xp)
    r = Q.residual(dp, x_flat, b)
    f = Q.objective_from_residual(dp, r)
    return EGState(
        xp=xp, r=r, f=f, gap=torch.full_like(f, float("inf")),
        k=torch.zeros(f.shape, dtype=torch.int32, device=f.device),
        x_prev=x_flat, g_prev=torch.zeros_like(x_flat),
    )


def refresh(dp, st: EGState, L_est, opts: SolveOptions) -> EGState:
    r = Q.residual(dp, L.padded_to_flat(dp, st.xp), rhs(dp))
    return EGState(xp=st.xp, r=r, f=Q.objective_from_residual(dp, r), gap=st.gap, k=st.k,
                   x_prev=st.x_prev, g_prev=st.g_prev)


def step(dp, st: EGState, L_est, opts: SolveOptions) -> EGState:
    x_flat = L.padded_to_flat(dp, st.xp)
    g_flat = Q.grad_flat(dp, st.r)
    gp = L.flat_to_padded(dp, g_flat)
    gap = fw_gap(dp, g_flat, x_flat, gp)

    inv_l = torch.full_like(st.f, 1.0 / float(L_est))
    if opts.step_size > 0:
        t0 = torch.full_like(st.f, opts.step_size)
    elif opts.line_search == "bb":
        # spectral (BB1) mirror step, safeguarded: fall back to 1/L on the
        # first iteration or when curvature along s is non-positive; cap at
        # 1e6/L so the log-domain proposal saturates at the block argmin
        # vertex (an FW-like probe) instead of overflowing the exponent
        s = x_flat - st.x_prev
        y = g_flat - st.g_prev
        ss = L.xdot(dp, s, s)
        sy = L.xdot(dp, s, y)
        t_bb = torch.where(sy > 0, ss / torch.clamp(sy, min=1e-30), inv_l)
        cap = torch.full_like(st.f, 1e6 / float(L_est))
        t_bb = torch.minimum(torch.clamp(t_bb, min=0.0), cap)
        t0 = torch.where(st.k > 0, t_bb, inv_l)
    else:
        t0 = inv_l
    x_eg = eg_update(st.xp, gp, t0, dp.buckets)
    dxp = tuple(xe - x for xe, x in zip(x_eg, st.xp))
    d_flat = L.padded_to_flat(dp, dxp)
    Ad = L.matvec(dp.A, d_flat)
    if opts.line_search == "fixed":
        t = torch.ones_like(st.f)
    else:
        t = Q.exact_step(dp, L.xdot(dp, g_flat, d_flat), Ad, 0.0, 1.0)

    tb = t[:, None, None]
    xp_new = tuple(x + tb * d for x, d in zip(st.xp, dxp))
    r_new = st.r + t[:, None] * Ad
    return EGState(
        xp=xp_new, r=r_new, f=Q.objective_from_residual(dp, r_new), gap=gap,
        k=st.k + 1, x_prev=x_flat, g_prev=g_flat,
    )
