"""Quadratic objective helpers and line searches.

The objective 0.5||Ax-b||^2 admits a closed-form exact step along any
direction d:  t* = -(g.d)/||A d||^2, clipped to the feasible segment.
Counterpart of ``bsls_tpu/ops/quadratic.py``; with a leading scenario axis
every scalar here is an (S,) tensor, one value per scenario.
"""
from __future__ import annotations

import torch

from .layout import DeviceProblem, matvec, rdot, rmatvec

__all__ = [
    "residual",
    "objective_from_residual",
    "grad_flat",
    "exact_step",
    "bb_step",
]


def residual(dp: DeviceProblem, x_flat: torch.Tensor, b=None) -> torch.Tensor:
    """r = A x - b."""
    return matvec(dp.A, x_flat) - (dp.b if b is None else b)


def objective_from_residual(dp: DeviceProblem, r: torch.Tensor) -> torch.Tensor:
    return 0.5 * rdot(dp, r, r)


def grad_flat(dp: DeviceProblem, r: torch.Tensor) -> torch.Tensor:
    return rmatvec(dp.A, r)


def exact_step(dp: DeviceProblem, g_dot_d: torch.Tensor, Ad: torch.Tensor,
               t_lo=0.0, t_hi=1.0) -> torch.Tensor:
    """Exact minimiser of f(x + t d) over [t_lo, t_hi].

    f(x+td) = f(x) + t g.d + t^2/2 ||Ad||^2  =>  t* = -g.d / ||Ad||^2.
    """
    den = rdot(dp, Ad, Ad)
    t = -g_dot_d / torch.clamp(den, min=1e-30)
    return torch.clamp(t, t_lo, t_hi)


def bb_step(dx_dot_dx, dx_dot_dg, fallback, t_lo=1e-12, t_hi=1e12):
    """Barzilai-Borwein step t = (dx.dx)/(dx.dg), guarded for non-positive curvature."""
    t = dx_dot_dx / torch.where(dx_dot_dg > 0, dx_dot_dg, torch.ones_like(dx_dot_dg))
    ok = (dx_dot_dg > 1e-30) & torch.isfinite(t)
    return torch.clamp(torch.where(ok, t, fallback), t_lo, t_hi)
