"""Wrappers of the per-row CUDA kernels (``csrc/proj_simplex_rows.cu``,
``csrc/pava_rows.cu``); the library is built and loaded by ``ops.cudalib``.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take, allocates the outputs with ``torch.empty``, checks
the error code of the launch, does not synchronise, and adds one to its
launch count where it launches — and nowhere else.  Nothing here falls back.
The plain PyTorch versions of both functions are
``ops.projection.proj_simplex_padded`` and ``ops.isotonic.pava_padded``.
The projection takes every bucket of a projection in one launch
(``proj_simplex_buckets``); ``proj_simplex_rows`` is its one-bucket case.
"""
from __future__ import annotations

import ctypes

import torch

from . import cudalib

__all__ = ["proj_simplex_rows", "proj_simplex_buckets", "pava_rows", "MAX_WIDTH",
           "PROJ_PLAN", "PROJ_MAX_BUCKETS", "PROJ_MAX_ROWS", "PAVA_FORMS"]

MAX_WIDTH = 128  # kMaxWidth in csrc/rows_common.cuh
# Buckets one launch of the projection takes (kMaxBuckets in
# csrc/proj_simplex_rows.cu); a longer bucket list takes more launches.
PROJ_MAX_BUCKETS = 8
# Rows a bucket of the projection may hold, S * Bk (kMaxRows in
# csrc/proj_simplex_rows.cu: a block's rows are indexed in 32 bits).
PROJ_MAX_ROWS = 2 ** 32 - 2 ** 12
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
    return Bk, w


def _launch(name, fn_name, v, widths, radius):
    Bk, w = _check(name, v, widths, radius)
    _on_one_cuda_device(name, (v, widths, radius))
    fn = _fn(fn_name)
    out = torch.empty_like(v)
    rows = v.numel() // w  # leading scenario axes fold into the row axis
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), widths.data_ptr(), radius.data_ptr(), out.data_ptr(),
                 rows, w, Bk, torch.cuda.current_stream().cuda_stream)
    cudalib.launched(name, err)
    return out


def _buckets_fn():
    fn = cudalib.load().bsls_proj_simplex_buckets
    if fn.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        fn.restype = ctypes.c_int
        fn.argtypes = [ptrs, ptrs, ptrs, ptrs, ctypes.POINTER(ctypes.c_longlong),
                       ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int, ctypes.c_void_p]
    return fn


def proj_simplex_buckets(xs, sizes, radii):
    """Project every bucket of a projection in one launch: each row of
    ``xs[i]`` (..., Bk_i, w_i) onto {x >= 0, sum x = radii[i][b]} over its
    first ``sizes[i][b]`` slots, 0 elsewhere.  Returns a tuple of fresh
    tensors, one a bucket.  CUDA float32 tensors on one device only; up to
    ``PROJ_MAX_BUCKETS`` buckets a launch."""
    name = "proj_simplex_rows"
    if not len(xs) == len(sizes) == len(radii):
        raise ValueError(f"{name}: {len(xs)} buckets, {len(sizes)} sizes, {len(radii)} radii")
    if not xs:
        return ()
    shapes = [_check(name, x, n, r) for x, n, r in zip(xs, sizes, radii)]
    for x, (Bk, w) in zip(xs, shapes):
        if x.numel() // w > PROJ_MAX_ROWS:
            raise ValueError(f"{name}: {x.numel() // w} rows in one bucket, the kernel takes "
                             f"at most {PROJ_MAX_ROWS}")
    _on_one_cuda_device(name, (*xs, *sizes, *radii))
    outs = tuple(torch.empty_like(x) for x in xs)
    live = [i for i, x in enumerate(xs) if x.numel()]  # an empty bucket needs no block
    for at in range(0, len(live), PROJ_MAX_BUCKETS):
        idx = live[at:at + PROJ_MAX_BUCKETS]
        nb = len(idx)
        ptrs = lambda ts: (ctypes.c_void_p * nb)(*(ts[i].data_ptr() for i in idx))
        ints = lambda typ, vals: (typ * nb)(*(vals[i] for i in idx))
        scen = {i: xs[i].numel() // (shapes[i][0] * shapes[i][1]) for i in idx}
        fn = _buckets_fn()
        with torch.cuda.device(xs[idx[0]].device):
            err = fn(ptrs(xs), ptrs(outs), ptrs(sizes), ptrs(radii),
                     ints(ctypes.c_longlong, scen), ints(ctypes.c_int, [s[0] for s in shapes]),
                     ints(ctypes.c_int, [s[1] for s in shapes]), nb,
                     torch.cuda.current_stream().cuda_stream)
        cudalib.launched(name, err)
    return outs


def proj_simplex_rows(v: torch.Tensor, widths: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Project each row of ``v`` (..., Bk, w) onto {x >= 0, sum x = radius[b]}
    over its first ``widths[b]`` slots; 0 elsewhere.  CUDA float32 only: the
    one-bucket case of ``proj_simplex_buckets``."""
    return proj_simplex_buckets((v,), (widths,), (radius,))[0]


def pava_rows(y: torch.Tensor, widths: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """[0, radius[b]]-bounded nondecreasing isotonic fit of the first
    ``widths[b]`` slots of each row of ``y`` (..., Bk, w); 0 elsewhere.  CUDA
    float32 only."""
    return _launch("pava_rows", "bsls_pava_rows", y, widths, radius)
