"""A whole chunk of PGD iterations with the exact line search as one function.

For a single right-hand side, a dense A of (m, B*w) in PF column order and one
bucket of B blocks of padded width w, ``steps`` times:

    g = A^T r;  xhat = P(x - t0 g) per block;  d = xhat - x;  Ad = A d
    t = clip(-(g.d) / max(||Ad||^2, 1e-30), 0, 1);  x += t d;  r += t Ad
    f[i] = 0.5 ||r||^2

starting from r = A x0 - b.  Returns the last x as (B, w) and the f-trace.

* ``pgd_chunk_plain`` — the plain PyTorch version: the same loop, step by
  step, with the sort-based projection of ``ops.projection``.  Any device.
* ``pgd_chunk`` — on CUDA tensors it launches the hand-written kernel of
  ``csrc/pgd_chunk.cu`` (one cooperative launch for the whole chunk) or
  raises; it takes the plain version only for tensors that lie on the CPU.

Replaces the TPU kernel ``pgd_chunk_fused``
(``bsls_tpu/ops/pallas/megastep_kernel.py:152``).  The kernel takes one copy
of A as it lies in ``DeviceDense``; the two per-slot tensors the reference
builds first answer a restriction of its compiler and have no counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from . import cudalib
from .projection import proj_simplex_padded
from .rowkernels import MAX_WIDTH

__all__ = ["pgd_chunk", "pgd_chunk_plain"]


def pgd_chunk_plain(A, b, x0_bw, widths, radius, t0: float, steps: int):
    B, w = x0_bw.shape
    mask = (torch.arange(w, device=A.device) < widths[:, None]).to(A.dtype)
    x = x0_bw.reshape(-1).clone()
    r = A @ x - b
    f = torch.empty(steps, dtype=A.dtype, device=A.device)
    for i in range(steps):
        g = r @ A
        xhat = proj_simplex_padded((x - t0 * g).view(B, w), mask, radius).reshape(-1)
        d = xhat - x
        Ad = A @ d
        den = torch.clamp((Ad * Ad).sum(), min=1e-30)
        t = torch.clamp(-(g * d).sum() / den, 0.0, 1.0)
        x = x + t * d
        r = r + t * Ad
        f[i] = 0.5 * (r * r).sum()
    return x.view(B, w), f


def _fns():
    lib = cudalib.load()
    fn = lib.bsls_pgd_chunk
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.bsls_pgd_chunk_blocks.restype = i32
        lib.bsls_pgd_chunk_blocks.argtypes = []
        fn.restype = i32
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_float, i32, i32, i32, i32,
                       ptr, ptr, ptr, i32, ptr]
    return fn, lib.bsls_pgd_chunk_blocks


def _check(A, b, x0_bw, widths, radius, steps):
    name = "pgd_chunk"
    tensors = (A, b, x0_bw, widths, radius)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors lie on different devices")
    if A.ndim != 2 or b.ndim != 1 or x0_bw.ndim != 2:
        raise ValueError(f"{name}: expected A (m, B*w), b (m,), x0 (B, w); got "
                         f"{tuple(A.shape)}, {tuple(b.shape)}, {tuple(x0_bw.shape)}")
    B, w = x0_bw.shape
    if A.shape != (b.shape[0], B * w) or widths.shape != (B,) or radius.shape != (B,):
        raise ValueError(f"{name}: shapes do not match: A {tuple(A.shape)}, b {tuple(b.shape)}, "
                         f"x0 {tuple(x0_bw.shape)}, widths {tuple(widths.shape)}, "
                         f"radius {tuple(radius.shape)}")
    if steps < 1:
        raise ValueError(f"{name}: steps must be >= 1, got {steps}")


def pgd_chunk(A: torch.Tensor, b: torch.Tensor, x0_bw: torch.Tensor, widths: torch.Tensor,
              radius: torch.Tensor, t0: float, steps: int):
    """``steps`` fused PGD/exact iterations: A (m, B*w), b (m,), x0_bw (B, w),
    widths (B,) int32, radius (B,), t0 the trial step 1/L.  Returns
    (x (B, w), f (steps,))."""
    _check(A, b, x0_bw, widths, radius, steps)
    if not A.is_cuda:
        return pgd_chunk_plain(A, b, x0_bw, widths, radius, t0, steps)
    name = "pgd_chunk"
    if not all(t.dtype == torch.float32 for t in (A, b, x0_bw, radius)):
        raise TypeError(f"{name}: the CUDA kernel takes float32 values")
    if widths.dtype != torch.int32:
        raise TypeError(f"{name}: widths must be int32, got {widths.dtype}")
    if not all(t.is_contiguous() for t in (A, b, x0_bw, widths, radius)):
        raise ValueError(f"{name}: tensors must be contiguous")
    m, (B, w) = b.shape[0], x0_bw.shape
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"{name}: width {w} outside 1..{MAX_WIDTH}")
    with torch.cuda.device(A.device):
        fn, blocks_fn = _fns()
        blocks = blocks_fn()
        if blocks < 1:
            raise RuntimeError(f"{name}: this device cannot launch the kernel cooperatively")
        x = torch.empty_like(x0_bw)
        f = torch.empty(steps, dtype=A.dtype, device=A.device)
        scratch = torch.empty(blocks * (B * w + 3) + B * w + 2 * m, dtype=A.dtype,
                              device=A.device)
        err = fn(A.data_ptr(), b.data_ptr(), x0_bw.data_ptr(), widths.data_ptr(),
                 radius.data_ptr(), float(t0), m, B, w, steps, x.data_ptr(), f.data_ptr(),
                 scratch.data_ptr(), blocks, torch.cuda.current_stream().cuda_stream)
    cudalib.launched(name, err)
    return x, f
