"""Quadratic objective helpers and line searches.

The objective 0.5||Ax-b||^2 admits a closed-form exact step along any
direction d:  t* = -(g.d)/||A d||^2, clipped to the feasible segment.
Counterpart of ``bsls_tpu/ops/quadratic.py``; with a leading scenario axis
every scalar here is an (S,) tensor, one value per scenario.
"""
from __future__ import annotations

import torch

from .layout import (
    DeviceBanded, DeviceDense, DeviceEll, DeviceProblem, DeviceVStack, flat_to_padded, matvec,
    rdot, rmatvec,
)

__all__ = [
    "residual",
    "objective_from_residual",
    "grad_flat",
    "exact_step",
    "bb_step",
    "diag_quad",
]


def _diag_flat(A) -> torch.Tensor:
    if isinstance(A, DeviceBanded):
        # the band holds each fitting column densely: its squared norm is a
        # sum over the window axis; non-fitting columns live in the residual
        d = torch.cat([(band * band).sum(dim=-1).reshape(-1) for band in A.bands])
        return d if A.resid is None else d + _diag_flat(A.resid)
    if isinstance(A, DeviceDense):
        return (A.data * A.data).sum(dim=0)
    if isinstance(A, DeviceEll):
        return (A.vals * A.vals).sum(dim=-1)
    if isinstance(A, DeviceVStack):
        return _diag_flat(A.top) + A.bottom_scale**2 * _diag_flat(A.bottom)
    raise TypeError(f"unsupported device matrix {type(A)}")


def diag_quad(dp: DeviceProblem) -> tuple:
    """diag(A^T A) as padded buckets (squared column norms in the PF layout;
    the per-block diagonal curvature)."""
    return flat_to_padded(dp, _diag_flat(dp.A))


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
