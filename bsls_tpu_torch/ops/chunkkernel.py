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
* ``pgd_chunk_carried_plain`` — the recurrence the kernel follows, in plain
  PyTorch, for the tests: the gradient is formed once from r0 and then
  carried, g += t * A^T (A d), instead of being recomputed from r.
* ``chunk_plan`` — blocks, the resident or the streaming form, shared memory
  and scratch of a launch, from the shape: the rule of the C launcher restated
  so that it can be tested without a card.

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

__all__ = ["pgd_chunk", "pgd_chunk_plain", "pgd_chunk_carried_plain", "chunk_plan",
           "pgd_chunk_variant", "grid_barriers_ms", "RESIDENT_MAX_BYTES", "STATE_MAX_BYTES",
           "CLOCK_SLOTS"]

# Dynamic shared memory a launch may take: the 232,448 bytes a block may have
# on sm_90 less 42 KB for the kernel's static buffers; and how much of it the
# block's own vectors may take before they go to scratch instead
# (kResidentMaxBytes and kStateMaxBytes in csrc/pgd_chunk.cu; keep them alike).
RESIDENT_MAX_BYTES = 232448 - 43008
STATE_MAX_BYTES = 48 * 1024
# what the clock sums of pgd_chunk_variant(clocks=True) were spent on
CLOCK_SLOTS = ("barriers", "gradient_from_r", "projection", "A_d", "At_Ad", "shares_and_t",
               "gather", "update")


def chunk_plan(m: int, B: int, w: int, blocks: int) -> dict:
    """The launch of an (m, B*w) chunk with ``blocks`` blocks, as
    ``chunk_plan`` of ``csrc/pgd_chunk.cu`` decides it: ``local_state`` (the
    block's r and Ad on its ceil(m / blocks) rows and x, g, d on its
    ceil(B / blocks) * w columns live in shared memory), ``resident`` (and so
    do its rows of A, for the whole launch; else the streaming form),
    ``smem_bytes`` of dynamic shared memory, and ``scratch_floats``: the
    (blocks, n) partial gradients, d, five shares per block, and room for the
    state (n + 2 m)."""
    if m < 1 or B < 1 or w < 1 or blocks < 1:
        raise ValueError(f"chunk_plan: bad shape m={m}, B={B}, w={w}, blocks={blocks}")
    n = B * w
    rows, cols = -(-m // blocks), -(-B // blocks) * w
    state = (2 * rows + 3 * cols) * 4
    local_state = state <= STATE_MAX_BYTES
    base = state if local_state else 0
    resident = base + rows * n * 4 <= RESIDENT_MAX_BYTES
    return dict(blocks=blocks, local_state=local_state, resident=resident,
                rows_per_block=rows, cols_per_block=cols,
                smem_bytes=base + (rows * n * 4 if resident else 0),
                scratch_floats=blocks * (n + 5) + 2 * n + 2 * m)


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


def pgd_chunk_carried_plain(A, b, x0_bw, widths, radius, t0: float, steps: int):
    """The same chunk with the gradient carried from step to step, as the
    kernel computes it: g0 = A^T r0 once, then g += t * A^T (A d).  Used by the
    tests only."""
    B, w = x0_bw.shape
    mask = (torch.arange(w, device=A.device) < widths[:, None]).to(A.dtype)
    x = x0_bw.reshape(-1).clone()
    r = A @ x - b
    g = r @ A
    f = torch.empty(steps, dtype=A.dtype, device=A.device)
    for i in range(steps):
        xhat = proj_simplex_padded((x - t0 * g).view(B, w), mask, radius).reshape(-1)
        d = xhat - x
        Ad = A @ d
        h = Ad @ A
        den = torch.clamp((Ad * Ad).sum(), min=1e-30)
        t = torch.clamp(-(g * d).sum() / den, 0.0, 1.0)
        x = x + t * d
        r = r + t * Ad
        g = g + t * h
        f[i] = 0.5 * (r * r).sum()
    return x.view(B, w), f


def _fns():
    lib = cudalib.load()
    fn = lib.bsls_pgd_chunk
    if fn.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.bsls_pgd_chunk_blocks.restype = i32
        lib.bsls_pgd_chunk_blocks.argtypes = [i32, i32, i32]
        fn.restype = i32
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ctypes.c_float, i32, i32, i32, i32,
                       ptr, ptr, ptr, i32, ptr]
        lib.bsls_pgd_chunk_variant.restype = i32
        lib.bsls_pgd_chunk_variant.argtypes = fn.argtypes[:-1] + [i32, ptr, ptr]
        lib.bsls_grid_barriers.restype = i32
        lib.bsls_grid_barriers.argtypes = [i32, i32, ptr]
    return lib


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


def _launch(A, b, x0_bw, widths, radius, t0, steps, blocks=None, resident=None, clocks=None):
    """Checks what the kernel does not take, sizes the launch by ``chunk_plan``
    and launches: the solver's entry point (``resident`` None) or the
    measurement entry point."""
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
        lib = _fns()
        if blocks is None:
            blocks = lib.bsls_pgd_chunk_blocks(m, B, w)
        if blocks < 1:
            raise RuntimeError(f"{name}: this device cannot launch the kernel cooperatively")
        plan = chunk_plan(m, B, w, blocks)
        x = torch.empty_like(x0_bw)
        f = torch.empty(steps, dtype=A.dtype, device=A.device)
        scratch = torch.empty(plan["scratch_floats"], dtype=A.dtype, device=A.device)
        args = (A.data_ptr(), b.data_ptr(), x0_bw.data_ptr(), widths.data_ptr(),
                radius.data_ptr(), float(t0), m, B, w, steps, x.data_ptr(), f.data_ptr(),
                scratch.data_ptr(), blocks)
        stream = torch.cuda.current_stream().cuda_stream
        if resident is None:
            err = lib.bsls_pgd_chunk(*args, stream)
        else:
            err = lib.bsls_pgd_chunk_variant(
                *args, int(bool(resident)), None if clocks is None else clocks.data_ptr(), stream)
            if err == -2:
                raise ValueError(f"{name}: the resident form does not fit m={m}, B={B}, w={w}")
    cudalib.launched(name, err)
    return x, f


def pgd_chunk(A: torch.Tensor, b: torch.Tensor, x0_bw: torch.Tensor, widths: torch.Tensor,
              radius: torch.Tensor, t0: float, steps: int):
    """``steps`` fused PGD/exact iterations: A (m, B*w), b (m,), x0_bw (B, w),
    widths (B,) int32, radius (B,), t0 the trial step 1/L.  Returns
    (x (B, w), f (steps,))."""
    _check(A, b, x0_bw, widths, radius, steps)
    if not A.is_cuda:
        return pgd_chunk_plain(A, b, x0_bw, widths, radius, t0, steps)
    return _launch(A, b, x0_bw, widths, radius, t0, steps)


def pgd_chunk_variant(A, b, x0_bw, widths, radius, t0: float, steps: int, resident: bool,
                      blocks=None, clocks: bool = False):
    """For measurements: the chunk in the resident or the streaming form of
    the kernel whatever ``chunk_plan`` would pick, with another number of
    blocks, or with the per-phase clock sums of block 0 (returned as a third
    value, in the order of ``CLOCK_SLOTS``).  CUDA tensors only; the solver
    never calls this."""
    _check(A, b, x0_bw, widths, radius, steps)
    if not A.is_cuda:
        raise ValueError("pgd_chunk_variant: CUDA tensors only")
    clk = torch.zeros(len(CLOCK_SLOTS), dtype=torch.int64, device=A.device) if clocks else None
    x, f = _launch(A, b, x0_bw, widths, radius, t0, steps, blocks=blocks, resident=resident,
                   clocks=clk)
    return (x, f, clk) if clocks else (x, f)


def grid_barriers_ms(count: int, blocks: int, device) -> float:
    """For measurements: device time in ms of one cooperative launch that does
    nothing but ``count`` ``grid.sync()`` with ``blocks`` blocks of the chunk
    kernel's size."""
    with torch.cuda.device(device):
        lib = _fns()
        stream = torch.cuda.current_stream().cuda_stream
        run = lambda: lib.bsls_grid_barriers(count, blocks, stream)
        if run() != 0:
            raise RuntimeError("grid_barriers_ms: launch failed")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        err = run()
        end.record()
        torch.cuda.synchronize()
        if err != 0:
            raise RuntimeError(f"grid_barriers_ms: launch failed with CUDA error {err}")
        return start.elapsed_time(end)
