"""Wrapper of the ELL product kernel (``csrc/ell_products.cu``); the library
is built and loaded by ``ops.cudalib``.

``ell_gather_dot`` computes one product of the gather layout: every width
group ``(cols[i], vals[i])`` of it, in sorted row order after ``zeros`` zero
rows, through the optional ``rank`` map to the output's order, against the
(n, S) operand, into a fresh (S, rows) tensor.  Its plain PyTorch version is
``ops.layout._ell_product_plain`` (``_gather_dot_t`` and the cat and
index_select around it), which CPU tensors take.  The wrapper checks dtypes,
shapes, contiguity and devices and raises on what the kernel does not take,
allocates the output with ``torch.empty``, checks the error code of each
launch, does not synchronise, and adds one to the ``ell_gather_dot`` launch
count a launch.  Nothing here falls back.

``ell_plan`` and ``ell_launches`` restate in Python the rules by which the C
launcher maps threads and the wrapper splits a product into launches, so
that the CPU tests hold them.
"""
from __future__ import annotations

import ctypes

import torch

from . import cudalib

__all__ = ["ell_gather_dot", "ell_plan", "ell_launches", "MAX_GROUPS", "THREADS"]

# kEllMaxGroups and kEllThreads in csrc/ell_products.cu
MAX_GROUPS = 8
THREADS = 256
_MAX_LANES = 32


def ell_plan(S: int, align: int = 16) -> tuple:
    """How the kernel maps S scenarios over an operand whose address is a
    multiple of ``align`` bytes (a fresh PyTorch allocation: 16 or more):
    (lanes a row, rows a warp, floats a lane, rows a tile).  The rule of
    ``ell_form`` in ``csrc/ell_products.cu``: floats a lane, the widest of 4,
    2, 1 that divides S and the alignment; lanes a row, the power of two that
    covers S / floats, at most 32; rows a tile, max(32, 256 / lanes)."""
    floats = next(f for f in (4, 2, 1) if S % f == 0 and align % (4 * f) == 0)
    lanes = min(_MAX_LANES, 1 << (-(-S // floats) - 1).bit_length())
    return lanes, 32 // lanes, floats, max(32, THREADS // lanes)


def ell_launches(rows, zeros: int = 0) -> list:
    """The launches of one product whose groups hold ``rows[i]`` rows each,
    in sorted order after ``zeros`` zero rows: a list of (group indices,
    first sorted row, end, starts), up to ``MAX_GROUPS`` groups a launch
    (empty groups left out), each launch computing the sorted rows
    [first, end) and the first launch the zero rows too."""
    starts, at = [], zeros
    for r in rows:
        starts.append(at)
        at += r
    live = [i for i, r in enumerate(rows) if r > 0]
    if not live:
        return [([], 0, zeros, [])] if zeros else []
    out = []
    for k in range(0, len(live), MAX_GROUPS):
        idx = live[k:k + MAX_GROUPS]
        lo = 0 if k == 0 else starts[idx[0]]
        out.append((idx, lo, starts[idx[-1]] + rows[idx[-1]], [starts[i] for i in idx]))
    return out


def _entry():
    fn = cudalib.load().bsls_ell_gather_dot
    if fn.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        ll = ctypes.c_longlong
        fn.restype = ctypes.c_int
        fn.argtypes = [ptrs, ptrs, ctypes.POINTER(ll), ctypes.POINTER(ctypes.c_int),
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ll,
                       ctypes.c_void_p, ll, ll, ll, ctypes.c_void_p]
    return fn


def _check(cols, vals, vt, zeros, rank):
    """Dtypes, shapes and layout; returns the output's rows."""
    name = "ell_gather_dot"
    if len(cols) != len(vals):
        raise ValueError(f"{name}: {len(cols)} index groups, {len(vals)} value groups")
    if vt.dtype != torch.float32 or any(v.dtype != torch.float32 for v in vals):
        raise TypeError(f"{name}: the operand and the values must be float32, got "
                        f"{vt.dtype} and {sorted({str(v.dtype) for v in vals})}")
    if any(c.dtype != torch.int32 for c in cols):
        raise TypeError(f"{name}: indices must be int32")
    if vt.ndim != 2:
        raise ValueError(f"{name}: the operand must be (n, S), got {tuple(vt.shape)}")
    for c, v in zip(cols, vals):
        if c.ndim != 2 or c.shape != v.shape or c.shape[1] < 1:
            raise ValueError(f"{name}: a group must be (rows, w >= 1) indices and values, got "
                             f"{tuple(c.shape)} and {tuple(v.shape)}")
    if zeros < 0:
        raise ValueError(f"{name}: {zeros} zero rows")
    rows_out = zeros + sum(c.shape[0] for c in cols)
    if rank is not None and (rank.dtype != torch.int32 or rank.shape != (rows_out,)):
        raise ValueError(f"{name}: rank must be ({rows_out},) int32, got "
                         f"{tuple(rank.shape)} {rank.dtype}")
    if rows_out >= 2 ** 31 or vt.shape[1] >= 2 ** 31:
        raise ValueError(f"{name}: {rows_out} rows of {vt.shape[1]} scenarios, the kernel "
                         "takes fewer than 2**31 of each")
    tensors = (*cols, *vals, vt) + (() if rank is None else (rank,))
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors lie on different devices")
    if devices.pop().type != "cuda":
        raise ValueError(f"{name}: all tensors must lie on a CUDA device")
    return rows_out


def ell_gather_dot(cols, vals, vt: torch.Tensor, zeros: int = 0, rank=None) -> torch.Tensor:
    """One ELL product on the card: ``out[s, p] = sum_k vals_g[r, k] *
    vt[cols_g[r, k], s]`` for output row p holding sorted row ``rank[p]``
    (``p`` without ``rank``), which lies in group g as its row r after the
    ``zeros`` zero rows (0 below them).  ``cols``/``vals``: sequences of
    (rows_i, w_i) int32/float32 groups; ``vt``: the (n, S) float32 operand.
    Returns a fresh (S, rows) tensor.  CUDA tensors on one device only,
    contiguous; up to ``MAX_GROUPS`` groups a launch."""
    rows_out = _check(cols, vals, vt, zeros, rank)
    S = vt.shape[1]
    out = torch.empty((S, rows_out), dtype=torch.float32, device=vt.device)
    if S == 0 or rows_out == 0:
        return out
    launches = ell_launches([c.shape[0] for c in cols], zeros)
    fn = _entry()
    with torch.cuda.device(vt.device):
        stream = torch.cuda.current_stream().cuda_stream
        for idx, lo, hi, starts in launches:
            nb = len(idx)
            err = fn((ctypes.c_void_p * nb)(*(cols[i].data_ptr() for i in idx)),
                     (ctypes.c_void_p * nb)(*(vals[i].data_ptr() for i in idx)),
                     (ctypes.c_longlong * nb)(*starts),
                     (ctypes.c_int * nb)(*(cols[i].shape[1] for i in idx)), nb,
                     vt.data_ptr(), S, out.data_ptr(), rows_out,
                     None if rank is None else rank.data_ptr(), lo, hi, zeros, stream)
            cudalib.launched("ell_gather_dot", err)
    return out
