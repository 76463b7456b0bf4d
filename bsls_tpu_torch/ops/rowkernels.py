"""Wrappers of the per-row CUDA kernels (``csrc/proj_simplex_rows.cu``,
``csrc/pava_rows.cu``); the library is built and loaded by ``ops.cudalib``.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take, allocates the outputs with ``torch.empty``, checks
the error code of the launch, does not synchronise, and adds one to its
launch count where it launches — and nowhere else.  Nothing here falls back.
The plain PyTorch versions of both functions are
``ops.projection.proj_simplex_padded`` and ``ops.isotonic.pava_padded``.
Each kernel takes every bucket of a call in one launch
(``proj_simplex_buckets``, ``pava_buckets``); ``proj_simplex_rows`` and
``pava_rows`` are their one-bucket cases.
"""
from __future__ import annotations

import ctypes

import torch

from . import cudalib

__all__ = ["proj_simplex_rows", "proj_simplex_buckets", "pava_rows", "pava_buckets",
           "MAX_WIDTH", "MAX_BUCKETS", "MAX_ROWS", "PROJ_PLAN", "PAVA_PLAN"]

MAX_WIDTH = 128  # kMaxWidth in csrc/rows_common.cuh
# Buckets one launch of either kernel takes (kMaxBuckets in
# csrc/rows_common.cuh); a longer bucket list takes more launches.
MAX_BUCKETS = 8
# Rows a bucket may hold, S * Bk (kMaxRows in csrc/rows_common.cuh: a
# block's rows are indexed in 32 bits).
MAX_ROWS = 2 ** 32 - 2 ** 12
# The projection's form by width (BSLS_PROJ_FORMS in csrc/proj_simplex_rows.cu):
# (first width, last width, lanes a row, values a lane).  One lane a row is
# the "thread" form: the row in its registers, sorted by a network; more
# lanes a row is the "group" form, slot l + k * lanes on lane l, the
# sort-free threshold across the lanes.
_PROJ_FORMS = (*((w, w, 1, w) for w in range(1, 17)),
               (17, 24, 8, 3), (25, 32, 8, 4), (33, 48, 16, 3), (49, 64, 16, 4),
               (65, 96, 32, 3), (97, 128, 32, 4))
# width -> (form, lanes a row, values a lane), every width 1..MAX_WIDTH
PROJ_PLAN = {w: ("thread" if lanes == 1 else "group", lanes, values)
             for lo, hi, lanes, values in _PROJ_FORMS for w in range(lo, hi + 1)}
# PAVA's form by width (BSLS_PAVA_FORMS in csrc/pava_rows.cu): (first width,
# last width, rows a block of the stack form, 0 for the thread form).  The
# "thread" form fits one row a thread in its registers by the minimax formula
# (one entry a width); the "stack" form stages a block's rows in shared memory
# and runs pool-adjacent-violators there, one row a thread.
_PAVA_FORMS = (*((w, w, 0) for w in range(1, 17)), (17, 32, 128), (33, 64, 64), (65, 128, 32))
# width -> (form, lanes a row, values a lane in registers, rows a block),
# every width 1..MAX_WIDTH: one lane a row in either form
PAVA_PLAN = {w: ("thread", 1, w, 128) if rows == 0 else ("stack", 1, 0, rows)
             for lo, hi, rows in _PAVA_FORMS for w in range(lo, hi + 1)}


def _on_one_cuda_device(name, tensors):
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors lie on different devices")
    if devices.pop().type != "cuda":
        raise ValueError(f"{name}: all tensors must lie on a CUDA device")


def _check(name, v, widths, radius):
    """Dtypes, shapes and layout of one (v, widths, radius) triple; the
    devices are checked by the caller, over all its tensors at once."""
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
    if v.numel() // w > MAX_ROWS:
        raise ValueError(f"{name}: {v.numel() // w} rows in one bucket, the kernel takes "
                         f"at most {MAX_ROWS}")
    return Bk, w


def _entry(fn_name):
    """The C entry point of a grouped kernel, its argument types declared."""
    fn = getattr(cudalib.load(), fn_name)
    if fn.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        fn.restype = ctypes.c_int
        fn.argtypes = [ptrs, ptrs, ptrs, ptrs, ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int, ctypes.c_void_p]
    return fn


def _buckets_fn():
    return _entry("bsls_proj_simplex_buckets")


def _pava_fn():
    return _entry("bsls_pava_buckets")


def _grouped(name, entry, xs, sizes, radii):
    """Every bucket ``(xs[i], sizes[i], radii[i])`` through one launch of the
    entry point ``entry()`` (a launch per ``MAX_BUCKETS`` buckets); a fresh
    output tensor a bucket."""
    if not len(xs) == len(sizes) == len(radii):
        raise ValueError(f"{name}: {len(xs)} buckets, {len(sizes)} sizes, {len(radii)} radii")
    if not xs:
        return ()
    shapes = [_check(name, x, n, r) for x, n, r in zip(xs, sizes, radii)]
    _on_one_cuda_device(name, (*xs, *sizes, *radii))
    outs = tuple(torch.empty_like(x) for x in xs)
    live = [i for i, x in enumerate(xs) if x.numel()]  # an empty bucket needs no block
    for at in range(0, len(live), MAX_BUCKETS):
        idx = live[at:at + MAX_BUCKETS]
        nb = len(idx)
        ptrs = lambda ts: (ctypes.c_void_p * nb)(*(ts[i].data_ptr() for i in idx))
        ints = lambda typ, vals: (typ * nb)(*(vals[i] for i in idx))
        scen = {i: xs[i].numel() // (shapes[i][0] * shapes[i][1]) for i in idx}
        fn = entry()
        with torch.cuda.device(xs[idx[0]].device):
            err = fn(ptrs(xs), ptrs(outs), ptrs(sizes), ptrs(radii),
                     ints(ctypes.c_longlong, scen), ints(ctypes.c_int, [s[0] for s in shapes]),
                     ints(ctypes.c_int, [s[1] for s in shapes]), nb,
                     torch.cuda.current_stream().cuda_stream)
        cudalib.launched(name, err)
    return outs


def proj_simplex_buckets(xs, sizes, radii):
    """Project every bucket of a projection in one launch: each row of
    ``xs[i]`` (..., Bk_i, w_i) onto {x >= 0, sum x = radii[i][b]} over its
    first ``sizes[i][b]`` slots, 0 elsewhere.  Returns a tuple of fresh
    tensors, one a bucket.  CUDA float32 tensors on one device only; up to
    ``MAX_BUCKETS`` buckets a launch."""
    return _grouped("proj_simplex_rows", _buckets_fn, xs, sizes, radii)


def proj_simplex_rows(v: torch.Tensor, widths: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Project each row of ``v`` (..., Bk, w) onto {x >= 0, sum x = radius[b]}
    over its first ``widths[b]`` slots; 0 elsewhere.  CUDA float32 only: the
    one-bucket case of ``proj_simplex_buckets``."""
    return proj_simplex_buckets((v,), (widths,), (radius,))[0]


def pava_buckets(ys, widths, radii):
    """The [0, radii[i][b]]-bounded nondecreasing isotonic fit of the first
    ``widths[i][b]`` slots of each row of ``ys[i]`` (..., Bk_i, w_i), 0
    elsewhere, every bucket in one launch.  Returns a tuple of fresh tensors,
    one a bucket.  CUDA float32 tensors on one device only; up to
    ``MAX_BUCKETS`` buckets a launch."""
    return _grouped("pava_rows", _pava_fn, ys, widths, radii)


def pava_rows(y: torch.Tensor, widths: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """[0, radius[b]]-bounded nondecreasing isotonic fit of the first
    ``widths[b]`` slots of each row of ``y`` (..., Bk, w); 0 elsewhere.  CUDA
    float32 only: the one-bucket case of ``pava_buckets``."""
    return pava_buckets((y,), (widths,), (radius,))[0]
