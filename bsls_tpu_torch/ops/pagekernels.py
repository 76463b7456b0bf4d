"""The two per-page contractions of the banded layout, and their wrappers.

For a band tensor ``band`` of shape (Mp, C, W) — page g holds a dense (C, W)
tile, see ``ops/banded.py`` —

    band_zmv (band, X):  Z[s, g, :] = X[s, g, :] @ band[g]      (S, Mp, C) -> (S, Mp, W)
    band_grmv(band, R):  G[s, g, :] = R[s, g, :] @ band[g]^T    (S, Mp, W) -> (S, Mp, C)

in fp32 with fp32 accumulation.  Two versions of each live here:

* ``band_zmv_plain`` / ``band_grmv_plain`` — the plain PyTorch versions (one
  einsum each).  They run on any device; the CPU tests use them and the CUDA
  kernels are held against them.  Nothing on the solve path calls them when a
  card is there.
* ``band_zmv`` / ``band_grmv`` — what ``ops/banded.py`` calls.  On CUDA
  tensors they launch the hand-written kernels of ``csrc/band_pages.cu`` (built
  and loaded by ``ops.cudalib``) or raise; they take the plain version only for
  tensors that lie on the CPU.

Replace the TPU kernels ``band_zmv_pallas`` and ``band_grmv_pallas``
(``bsls_tpu/ops/pallas/banded_kernels.py:63`` and ``:86``).  The scenario axis
is an explicit leading axis here; the reference's custom-vmap fold has no
counterpart.

The second operand may be a view: any strides on the scenario and page axes
and a unit stride on the last.  That is what lets ``banded_rmatvec`` hand the
kernel the sliding page windows of the padded residual without copying them.

``band_grmv`` has two kernels behind one entry point (``grmv_path`` below
states the rule by which the C launcher picks): a persistent kernel fed by a
ring of bulk asynchronous copies, and a scalar kernel for any W and any base
address.  ``band_grmv_last_path`` says which one the last call took.
"""
from __future__ import annotations

import ctypes

import torch

from . import cudalib

__all__ = ["band_zmv", "band_grmv", "band_zmv_plain", "band_grmv_plain", "grmv_path",
           "band_grmv_last_path", "band_grmv_on_path", "GRMV_PATHS"]

# the kernels of band_grmv, by the number the C launcher reports
GRMV_PATHS = ("scalar", "ring")
# the constants of csrc/band_pages.cu (grmv_plan); keep the two alike
_GRMV_WARPS = 8
_MAX_TILE_ROWS = 32
_MAX_STAGES = 4
_WINDOW_SLOTS = 2
_RING_IN_FLIGHT = 96 * 1024
_RING_BARRIER_BYTES = 128
_RING_BUDGET = 200 * 1024


def grmv_path(band_ptr: int, r_ptr: int, S: int, Mp: int, W: int, r_stride_s: int,
              r_stride_g: int) -> dict:
    """How ``bsls_band_grmv`` runs a shape: the rule of ``grmv_plan`` in
    ``csrc/band_pages.cu``, restated in Python so that it can be tested without
    a card.  Pointers in bytes, strides in floats.  Returns ``path`` (0 scalar,
    1 ring), ``tile_rows``, ``stages`` and ``smem`` (bytes of dynamic shared
    memory)."""
    aligned = (W % 4 == 0 and band_ptr % 16 == 0 and r_ptr % 16 == 0
               and (S == 1 or r_stride_s % 4 == 0) and (Mp == 1 or r_stride_g % 4 == 0))
    plan = dict(path=0, tile_rows=32, stages=0, smem=0)
    if not aligned:
        return plan
    ns = 1
    while ns < S and ns < 16:
        ns *= 2
    windows = _WINDOW_SLOTS * ns * W * 4
    rows = _MAX_TILE_ROWS
    while rows >= _GRMV_WARPS:
        stage = rows * W * 4
        if windows + 2 * stage <= _RING_BUDGET:
            want = min(max(-(-_RING_IN_FLIGHT // stage), 2), _MAX_STAGES)
            stages = min((_RING_BUDGET - windows) // stage, want)
            return dict(path=1, tile_rows=rows, stages=stages,
                        smem=stages * stage + windows + _RING_BARRIER_BYTES)
        rows //= 2
    return plan  # W too large for a ring of two stages


def band_zmv_plain(band: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    return torch.einsum("gcw,sgc->sgw", band, xg)


def band_grmv_plain(band: torch.Tensor, rw: torch.Tensor) -> torch.Tensor:
    return torch.einsum("gcw,sgw->sgc", band, rw)


def _fn(fn_name):
    fn = getattr(cudalib.load(), fn_name)
    if fn.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.restype = ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, ptr]
        if fn_name == "bsls_band_grmv_on_path":
            fn.argtypes = fn.argtypes[:-1] + [i32, ptr]
    return fn


def _check(name, band, v, contracted: int):
    """``v`` is (S, Mp, K) with K = band.shape[contracted]."""
    if band.ndim != 3 or v.ndim != 3:
        raise ValueError(f"{name}: expected band (Mp, C, W) and a (S, Mp, .) operand, got "
                         f"{tuple(band.shape)} and {tuple(v.shape)}")
    if v.shape[1] != band.shape[0] or v.shape[2] != band.shape[contracted]:
        raise ValueError(f"{name}: operand {tuple(v.shape)} does not match band "
                         f"{tuple(band.shape)}")
    if band.device != v.device:
        raise ValueError(f"{name}: tensors lie on different devices")
    if band.dtype != v.dtype:
        raise TypeError(f"{name}: band is {band.dtype}, operand {v.dtype}")


def _launch(name, fn_name, band, v, contracted, out_width, *extra):
    if band.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got {band.dtype}")
    if not band.is_contiguous():
        raise ValueError(f"{name}: band must be contiguous")
    if 0 in band.shape or v.shape[0] == 0:
        raise ValueError(f"{name}: empty operand {tuple(band.shape)}, {tuple(v.shape)}")
    if v.stride(2) != 1 or v.stride(0) < 0 or v.stride(1) < 0:
        v = v.contiguous()  # once for the whole call, not per page
    S, Mp = v.shape[0], v.shape[1]
    out = torch.empty((S, Mp, out_width), dtype=band.dtype, device=band.device)
    with torch.cuda.device(band.device):
        err = _fn(fn_name)(
            band.data_ptr(), v.data_ptr(), out.data_ptr(), S, Mp, band.shape[1],
            band.shape[2], v.stride(0), v.stride(1), *extra,
            torch.cuda.current_stream().cuda_stream)
    if extra and err == -2:
        return None
    cudalib.launched(name, err)
    return out


def band_zmv(band: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    """Z = X @ band per page: band (Mp, C, W), xg (S, Mp, C) -> (S, Mp, W)."""
    _check("band_zmv", band, xg, contracted=1)
    if not band.is_cuda:
        return band_zmv_plain(band, xg)
    return _launch("band_zmv", "bsls_band_zmv", band, xg, 1, band.shape[2])


def band_grmv(band: torch.Tensor, rw: torch.Tensor) -> torch.Tensor:
    """G = R @ band^T per page: band (Mp, C, W), rw (S, Mp, W) -> (S, Mp, C)."""
    _check("band_grmv", band, rw, contracted=2)
    if not band.is_cuda:
        return band_grmv_plain(band, rw)
    return _launch("band_grmv", "bsls_band_grmv", band, rw, 2, band.shape[1])


def band_grmv_last_path() -> int:
    """The kernel the last ``band_grmv`` on a CUDA tensor took (an index into
    ``GRMV_PATHS``); -1 before the first."""
    fn = cudalib.load().bsls_band_grmv_last_path
    fn.restype = ctypes.c_int
    return int(fn())


def band_grmv_on_path(band: torch.Tensor, rw: torch.Tensor, path: int):
    """For measurements: ``band_grmv`` through kernel ``path`` of ``GRMV_PATHS``,
    or None where the shape does not admit it.  CUDA tensors only; the solver
    never calls this."""
    _check("band_grmv", band, rw, contracted=2)
    if not band.is_cuda:
        raise ValueError("band_grmv_on_path: CUDA tensors only")
    return _launch("band_grmv", "bsls_band_grmv_on_path", band, rw, 2, band.shape[1], int(path))
