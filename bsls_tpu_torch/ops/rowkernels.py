"""Wrappers of the per-row CUDA kernels (``csrc/proj_simplex_rows.cu``,
``csrc/pava_rows.cu``); the library is built and loaded by ``ops.cudalib``.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take, allocates the output with ``torch.empty``, checks
the error code of the launch, does not synchronise, and adds one to its
launch count where it launches — and nowhere else.  Nothing here falls back.
The plain PyTorch versions of both functions are
``ops.projection.proj_simplex_padded`` and ``ops.isotonic.pava_padded``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cudalib

__all__ = ["proj_simplex_rows", "pava_rows", "MAX_WIDTH", "PAVA_FORMS"]

MAX_WIDTH = 128  # kMaxWidth in csrc/rows_common.cuh
# The fit that each templated width takes in csrc/pava_rows.cu (the switch of
# bsls_pava_rows); every other width up to MAX_WIDTH takes the generic kernel,
# which runs the stack on the row in device memory.
PAVA_FORMS = {1: "minimax", 2: "minimax", 4: "minimax", 8: "minimax", 16: "minimax",
              32: "minimax"}


def _fn(fn_name):
    fn = getattr(cudalib.load(), fn_name)
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ptr]
    return fn


def _check(name, v, widths, radius):
    if not (v.is_cuda and widths.is_cuda and radius.is_cuda):
        raise ValueError(f"{name}: all tensors must lie on a CUDA device")
    if not (v.device == widths.device == radius.device):
        raise ValueError(f"{name}: tensors lie on different devices")
    if v.dtype != torch.float32 or radius.dtype != torch.float32:
        raise TypeError(f"{name}: values and radius must be float32, got "
                        f"{v.dtype} and {radius.dtype}")
    if widths.dtype != torch.int32:
        raise TypeError(f"{name}: widths must be int32, got {widths.dtype}")
    if v.ndim < 2:
        raise ValueError(f"{name}: expected (..., Bk, w), got {tuple(v.shape)}")
    Bk, w = v.shape[-2], v.shape[-1]
    if widths.shape != (Bk,) or radius.shape != (Bk,):
        raise ValueError(f"{name}: widths/radius must be ({Bk},), got "
                         f"{tuple(widths.shape)} and {tuple(radius.shape)}")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"{name}: width {w} outside 1..{MAX_WIDTH}")
    if Bk >= 2 ** 31:
        raise ValueError(f"{name}: {Bk} blocks, the kernels take fewer than 2**31")
    if not (v.is_contiguous() and widths.is_contiguous() and radius.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    return Bk, w


def _launch(name, fn_name, v, widths, radius):
    Bk, w = _check(name, v, widths, radius)
    fn = _fn(fn_name)
    out = torch.empty_like(v)
    rows = v.numel() // w  # leading scenario axes fold into the row axis
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), widths.data_ptr(), radius.data_ptr(), out.data_ptr(),
                 rows, w, Bk, torch.cuda.current_stream().cuda_stream)
    cudalib.launched(name, err)
    return out


def proj_simplex_rows(v: torch.Tensor, widths: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Project each row of ``v`` (..., Bk, w) onto {x >= 0, sum x = radius[b]}
    over its first ``widths[b]`` slots; 0 elsewhere.  CUDA float32 only."""
    return _launch("proj_simplex_rows", "bsls_proj_simplex_rows", v, widths, radius)


def pava_rows(y: torch.Tensor, widths: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """[0, radius[b]]-bounded nondecreasing isotonic fit of the first
    ``widths[b]`` slots of each row of ``y`` (..., Bk, w); 0 elsewhere.  CUDA
    float32 only."""
    return _launch("pava_rows", "bsls_pava_rows", y, widths, radius)
