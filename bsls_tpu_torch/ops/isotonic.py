"""Batched bounded isotonic regression (PAVA-equivalent).

Per block, the [lo, hi]-bounded nondecreasing least-squares fit of the first
``widths[b]`` slots of a padded ``(..., B, w)`` array — the Euclidean
projection onto the (radius-scaled) order simplex that z-space PGD needs.

Two versions of the same function live here:

* ``pava_padded`` — the plain PyTorch version.  It evaluates the exact
  *minimax characterisation* of L2 isotonic regression,

      yhat_i = min_{k >= i} max_{j <= i} mean(y[j..k]),

  as an O(w^2) dense computation per block (exactly the PAVA output), then
  clips: uniform box bounds commute with the monotone-cone projection.  The
  means tensor is (chunk, w, w); ``chunk`` bounds peak memory for large B.
* ``pava_blocks`` — what the solvers call, the z-space projection of every
  bucket of a padded tuple.  On CUDA tensors it launches the hand-written
  kernel ``pava_rows`` (``csrc/pava_rows.cu``, wrapper
  ``ops/rowkernels.py::pava_buckets``) once for all buckets, or raises; it
  takes the plain version only for tensors that lie on the CPU.
  ``pava_bounded`` is the same for one bucket.

Replaces the TPU kernel ``pava_pallas_tw``
(``bsls_tpu/ops/pallas/pava_kernel.py:132``) and its dispatch
``bsls_tpu/ops/isotonic.py::pava_bounded``.
"""
from __future__ import annotations

import torch

from .rowkernels import pava_buckets, pava_rows

__all__ = ["pava_padded", "pava_bounded", "pava_blocks"]


def _pava_minimax(y: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Nondecreasing isotonic fit of each row's first ``sizes`` entries.

    y: (B, w); sizes: (B,) int. Entries past the width are ignored/garbage.
    """
    B, w = y.shape
    dt, dev = y.dtype, y.device
    big = torch.full((), torch.finfo(dt).max, dtype=dt, device=dev)
    ar = torch.arange(w, device=dev)
    # prefix sums with leading zero: P[:, k] = sum(y[:, :k])
    ym = torch.where(ar < sizes[:, None], y, torch.zeros((), dtype=dt, device=dev))
    P = torch.cat([torch.zeros((B, 1), dtype=dt, device=dev), torch.cumsum(ym, dim=-1)], dim=-1)
    j = ar[:, None]  # segment start
    k = ar[None, :]  # segment end, inclusive
    seg_len = torch.clamp(k - j + 1, min=1).to(dt)
    # mean over y[j..k]: (B, w, w) from the prefix sums
    M = (P[:, None, 1:] - P[:, :w, None]) / seg_len
    M = torch.where(j <= k, M, -big)
    A = torch.cummax(M, dim=1).values  # A[:, i, k] = max_{j<=i} M[j, k]
    valid_k = (k >= j)[None] & (ar[None, None, :] < sizes[:, None, None])
    return torch.where(valid_k, A, big).amin(dim=-1)


def pava_padded(
    y: torch.Tensor,
    mask: torch.Tensor,
    lo=0.0,
    hi=1.0,
    increasing: bool = True,
    chunk: int = 4096,
) -> torch.Tensor:
    """Bounded isotonic regression on each row of a padded (..., B, w) array.

    Only the first ``width`` (from mask) entries of each row are fit; padding
    slots return 0.  ``lo``/``hi`` are None, scalars or per-row (B,) tensors.
    Leading scenario axes fold into the row axis.
    """
    w = y.shape[-1]
    B = mask.shape[0]
    valid = mask > 0
    sizes = valid.sum(dim=-1)
    sgn = 1.0 if increasing else -1.0
    yy = (sgn * y).reshape(-1, w)
    if w == 1:
        out = yy
    else:
        rows = yy.shape[0]
        sz = sizes.repeat(rows // B)
        out = torch.cat([
            _pava_minimax(yy[s:s + chunk], sz[s:s + chunk])
            for s in range(0, rows, chunk)
        ])
    out = (sgn * out).reshape(y.shape)

    def bound(a):
        if a is None:
            return None
        a = torch.as_tensor(a, dtype=y.dtype, device=y.device)
        return a[..., None] if a.ndim >= 1 else a  # per-row bound (B, 1)

    lo_a, hi_a = bound(lo), bound(hi)
    if lo_a is not None:
        out = torch.maximum(out, lo_a)
    if hi_a is not None:
        out = torch.minimum(out, hi_a)
    return torch.where(valid, out, torch.zeros((), dtype=y.dtype, device=y.device))


def pava_bounded(y: torch.Tensor, widths: torch.Tensor, radius) -> torch.Tensor:
    """[0, radius]-bounded nondecreasing fit of each row's first ``widths``
    slots of ``y`` (..., B, w); ``widths`` (B,) int32 may be 0 (all zeros).
    One kernel launch on the card."""
    rad = torch.as_tensor(radius, dtype=y.dtype, device=y.device).expand(widths.shape)
    if y.is_cuda:
        return pava_rows(y, widths, rad.contiguous())
    mask = (torch.arange(y.shape[-1], device=y.device) < widths[:, None]).to(y.dtype)
    return pava_padded(y, mask, 0.0, rad)


def pava_blocks(yp, buckets):
    """The z-space projection of every bucket of a padded tuple: the
    [0, radius]-bounded nondecreasing fit of each row's first ``zwidths``
    slots (block size - 1) onto the radius-scaled order simplex.  One kernel
    launch for all buckets on the card; a tuple with a CUDA tensor never
    reaches the plain version."""
    if any(y.is_cuda for y in yp):
        return pava_buckets(tuple(yp), tuple(bk.zwidths for bk in buckets),
                            tuple(bk.radius for bk in buckets))
    return tuple(pava_bounded(y, bk.zwidths, bk.radius) for y, bk in zip(yp, buckets))
