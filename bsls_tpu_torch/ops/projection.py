"""Batched block-simplex projection.

Per block, the Euclidean projection of the first ``sizes[b]`` slots of a
padded ``(..., B, w)`` array onto {x >= 0, sum x = radius[b]}; padding slots
and all-padding dummy rows give zeros.

Two versions of the same function live here:

* ``proj_simplex_padded`` — the plain PyTorch version: the sort-based
  algorithm of arXiv:1101.6081 (sort descending, pivot
  rho = max{k : u_k - (cumsum_k - radius)/k > 0}, threshold
  tau = (cumsum_rho - radius)/rho, return max(v - tau, 0)).  It runs on any
  device and is what the CUDA kernel is held against.
* ``proj_blocks`` — what the solvers call.  On a CUDA tensor it launches the
  hand-written kernel ``proj_simplex_rows`` (``csrc/proj_simplex_rows.cu``,
  wrapper in ``ops/rowkernels.py``) once per bucket, or raises; it takes the
  plain version only for a tensor that lies on the CPU.

Replaces the TPU kernel ``proj_simplex_pallas_tw``
(``bsls_tpu/ops/pallas/projection_kernel.py:132``) and its dispatch
``bsls_tpu/ops/projection.py::proj_blocks``.  The reference's size gate on
the kernel has no counterpart: the ``(S, Bk, w)`` tensor is contiguous, the
scenario fold is a reshape, and the kernel indexes ``sizes``/``radius`` by
``row % Bk``.
"""
from __future__ import annotations

import torch

from .rowkernels import proj_simplex_rows

__all__ = ["proj_simplex_padded", "proj_blocks"]


def proj_simplex_padded(v: torch.Tensor, mask: torch.Tensor, radius=1.0) -> torch.Tensor:
    """Project each row of ``v`` (..., B, w) onto the radius-scaled simplex of
    its valid slots: {x >= 0 on valid slots, sum x = radius}.

    mask: (B, w) (or broadcastable) with 1.0 on real slots.  ``radius`` is a
    scalar or a per-row (B,) tensor (block equilibration).  Rows whose mask is
    all zero (dummy blocks) return all zeros.
    """
    dt = v.dtype
    neg = torch.finfo(dt).min  # finite: inf - inf would give NaN below
    w = v.shape[-1]
    rad = torch.as_tensor(radius, dtype=dt, device=v.device)
    if rad.ndim >= 1:
        rad = rad[..., None]  # (B, 1) broadcast over slots
    valid = mask > 0
    zero = torch.zeros((), dtype=dt, device=v.device)
    vm = torch.where(valid, v, torch.full((), neg, dtype=dt, device=v.device))
    u = torch.sort(vm, dim=-1, descending=True).values
    css = torch.cumsum(torch.where(u > neg, u, zero), dim=-1)
    k = torch.arange(1, w + 1, device=v.device)
    widths = valid.sum(dim=-1, keepdim=True)  # (B, 1) int
    cond = (u * k.to(dt) > (css - rad)) & (k <= widths)
    idx = torch.arange(w, device=v.device)
    rho = torch.where(cond, idx, idx.new_full((), -1)).amax(dim=-1)  # (..., B)
    rho_c = torch.clamp(rho, min=0)
    css_rho = torch.gather(css, -1, rho_c[..., None])
    tau = (css_rho - rad) / (rho_c + 1)[..., None].to(dt)
    out = torch.clamp(v - tau, min=0.0)
    return torch.where(valid, out, zero)


def proj_blocks(xp, buckets):
    """Apply the projection to every bucket of a padded tuple (per-bucket
    radii from equilibration).  One kernel launch per bucket on the card."""
    return tuple(
        proj_simplex_rows(x, bk.sizes, bk.radius) if x.is_cuda
        else proj_simplex_padded(x, bk.mask, bk.radius)
        for x, bk in zip(xp, buckets)
    )
