"""x <-> z change of variable (block simplex <-> order simplex), padded layout.

Per block of width n:  z_k = sum_{j<=k} x_j  (k = 1..n-1)  maps the simplex
bijectively onto the order simplex {0 <= z_1 <= ... <= z_{n-1} <= 1}, whose
Euclidean projection is [0,1]-bounded isotonic regression.

Padded representation: z uses the same (B, w) rectangles as x, with valid
width n_i - 1 per block (the last valid x-slot has no z entry).  The adjoint
of x(z) is Dt: (Dt g)_k = g_k - g_{k+1}.  Counterpart of
``bsls_tpu/ops/ztransform.py``; inputs may carry leading scenario axes.
"""
from __future__ import annotations

import torch

__all__ = [
    "zmask", "x_to_z_padded", "z_to_x_padded", "dz_adjoint_padded",
    "dz_forward_padded",
]


def _shift_left(a: torch.Tensor) -> torch.Tensor:
    """a[..., k+1] at slot k, 0 in the last slot."""
    return torch.cat([a[..., 1:], torch.zeros_like(a[..., :1])], dim=-1)


def _shift_right(a: torch.Tensor) -> torch.Tensor:
    """a[..., k-1] at slot k, 0 in the first slot."""
    return torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], dim=-1)


def _zero(a: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=a.dtype, device=a.device)


def _cumsum_last(a: torch.Tensor) -> torch.Tensor:
    """Running sum over the last axis.  For the narrow rows of a bucket this
    is w - 1 column additions: ``torch.cumsum`` over an innermost axis of 4 or
    8 entries took 3.7 ms a call at (128, 6670, 8) on an H100, 70% of a whole
    pava iteration."""
    w = a.shape[-1]
    if w > 32:
        return torch.cumsum(a, dim=-1)
    cols = [a[..., 0]]
    for k in range(1, w):
        cols.append(cols[-1] + a[..., k])
    return torch.stack(cols, dim=-1)


def zmask(mask: torch.Tensor) -> torch.Tensor:
    """Validity mask for z given the x mask: width n-1 instead of n."""
    # slot k valid for z iff slot k+1 valid for x
    return _shift_left(mask)


def x_to_z_padded(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """z_k = cumsum(x)_k for k < n-1 (padded slots -> 0)."""
    zm = zmask(mask)
    z = _cumsum_last(x * (mask > 0))
    return torch.where(zm > 0, z, _zero(z))


def z_to_x_padded(z: torch.Tensor, mask: torch.Tensor, radius=1.0) -> torch.Tensor:
    """x_1 = z_1, x_j = z_j - z_{j-1}, x_n = radius - z_{n-1};
    width-1 blocks -> radius."""
    zm = zmask(mask)
    zc = torch.where(zm > 0, z, _zero(z))
    rad = torch.as_tensor(radius, dtype=z.dtype, device=z.device)
    if rad.ndim >= 1:
        rad = rad[..., None]
    # z extended with an implicit `radius` at position n-1 (last valid x slot)
    sizes = (mask > 0).sum(dim=-1, keepdim=True)
    idx = torch.arange(mask.shape[-1], device=z.device)
    is_last = (idx == sizes - 1) & (mask > 0)
    z_ext = torch.where(is_last, rad, zc)
    x = z_ext - _shift_right(z_ext)
    return torch.where(mask > 0, x, _zero(x))


def dz_adjoint_padded(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(D^T g)_k = g_k - g_{k+1} on valid z slots (adjoint of x = D z + e_n)."""
    zm = zmask(mask)
    return torch.where(zm > 0, g - _shift_left(g), _zero(g))


def dz_forward_padded(dz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Linear part of z->x: (D dz)_j = dz_j - dz_{j-1} on valid z slots; the
    last valid x slot (which has no z of its own) gets -dz_{n-2}.  True
    adjoint of ``dz_adjoint_padded``."""
    zm = zmask(mask)
    dzc = torch.where(zm > 0, dz, _zero(dz))
    prev = _shift_right(dzc)
    dx = torch.where(zm > 0, dzc - prev, -prev)
    return torch.where(mask > 0, dx, _zero(dx))
