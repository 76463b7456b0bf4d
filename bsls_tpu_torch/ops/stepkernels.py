"""The exact-line-search x-space PGD step's passes around its products and
its projection: wrappers of the three kernels of ``csrc/pgd_step.cu`` and
their plain versions.  The library is built and loaded by ``ops.cudalib``.

``solvers/pgd.py::step`` makes an exact x-space step of

    g = A^T r;  prep;  xhat = proj(cand);  dir;  Ad = A d;  update

* prep: the candidate ``x - t0 g`` (t0 = 1 / L, or the fixed step), the flat
  copy of x (the state's ``x_prev``) and the Frank-Wolfe gap;
* dir: d = xhat - x, flat, with its (n, S) copy where the operator's product
  gathers from one (``layout.takes_operand``), and g.d;
* update: t = clamp(-g.d / max(Ad.Ad, 1e-30), 0, 1) per scenario, x + t d,
  r + t Ad and f = 0.5 r.r.

``step_prep``, ``step_dir`` and ``step_update`` launch the kernels (one
launch each, every bucket in it; ``step_update`` two: "dots", then "apply")
on CUDA tensors and raise on anything else: nothing here falls back.  The
kernels sum across blocks in a fixed order with no float atomics: the gap and
g.d leave ``step_prep`` and ``step_dir`` as per-block parts, which
``step_update`` folds.  A wrapper checks dtypes, shapes, contiguity and
devices, allocates with ``torch.empty``, checks each launch's error code,
does not synchronise, and counts its launches under ``step_prep``,
``step_dir`` and ``step_update`` in ``cudalib.launch_counts()``.

``prep_plain``, ``dir_plain`` and ``update_plain`` take the same arguments
and are the step's plain version on any device, wherever the kernels are not
taken (``pgd.fused_step``: the CPU, a mesh, float64): the chain of PyTorch
passes, whose dots are (S,) values summed over the ranks of a mesh.

``prep_plan``, ``dir_plan`` and ``update_plan`` restate in Python the rules
by which the kernels split the work into tiles and blocks, so that the CPU
tests hold them and restate the kernels' order of summation.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import torch

from . import cudalib
from . import layout as L
from . import quadratic as Q
from .simplex import fw_gap

__all__ = ["Direction", "step_prep", "step_dir", "step_update", "prep_plain", "dir_plain",
           "update_plain", "prep_plan", "dir_plan", "update_plan", "THREADS", "TILE", "BLOCKS",
           "MAX_BUCKETS", "MAX_GROUP"]

# kStepThreads, kStepTile, kStepBlocks, kStepMaxBuckets and kStepMaxGroup in
# csrc/pgd_step.cu
THREADS = 256
TILE = 2048
BLOCKS = 1024
MAX_BUCKETS = 8
MAX_GROUP = 32
_MAX_WIDTH = 128  # the projection's widest bucket (rowkernels.MAX_WIDTH)


def _blocks(groups: int, tiles: int) -> int:
    """Blocks a launch gives each scenario (or scenario group): about
    ``BLOCKS`` in all, at most one a tile."""
    return min(tiles, max(1, -(-BLOCKS // groups)))


def prep_plan(S: int, shapes) -> tuple:
    """``step_prep``'s split of buckets of ``shapes`` [(Bk, w), ...]: (rows a
    tile of each bucket, tiles a scenario, blocks a scenario).  A tile is
    max(1, TILE // w) whole rows of one bucket."""
    rows = [max(1, TILE // w) for _, w in shapes]
    tiles = sum(-(-Bk // r) for (Bk, _), r in zip(shapes, rows))
    return rows, tiles, _blocks(S, tiles)


def dir_plan(S: int, shapes) -> tuple:
    """``step_dir``'s tiles: (TS scenarios, TP columns, scenario groups,
    tiles a group, blocks a group).  TS is the power of two that covers S,
    at most MAX_GROUP; TS * TP = TILE; a tile lies in one bucket."""
    ts = min(MAX_GROUP, 1 << (S - 1).bit_length())
    tp = TILE // ts
    tiles = sum(-(-(Bk * w) // tp) for Bk, w in shapes)
    groups = -(-S // ts)
    return ts, tp, groups, tiles, _blocks(groups, tiles)


def update_plan(S: int, shapes, m: int) -> tuple:
    """``step_update``'s launches: (tiles of "dots" a scenario (r's length m
    in tiles of TILE), its blocks a scenario, tiles of x a scenario (each
    bucket's own), all of "apply"'s tiles a scenario (x's, then r's), its
    blocks a scenario, lanes a scenario in its last block)."""
    r_tiles = -(-m // TILE)
    x_tiles = sum(-(-(Bk * w) // TILE) for Bk, w in shapes)
    tiles = x_tiles + r_tiles
    lanes = min(32, 1 << (max(1, THREADS // S).bit_length() - 1))
    return r_tiles, _blocks(S, r_tiles), x_tiles, tiles, _blocks(S, tiles), lanes


@dataclass(frozen=True)
class Direction:
    """What ``step_dir`` or ``dir_plain`` hands on: ``flat`` d (S, n_pf);
    ``operand`` its (n_pf, S) copy, or None; ``dot`` g.d, the kernel's (S,
    blocks) parts or the plain version's (S,) values; ``buckets``, the
    buffers that the update writes x + t d into: xhat's for the kernel (which
    reads d flat), d's own for the plain version (which reads d from them)."""

    flat: torch.Tensor
    operand: Optional[torch.Tensor]
    dot: torch.Tensor
    buckets: tuple


# ---------------------------------------------------------------- the plain versions


def prep_plain(dp, xp, g_flat, f, L_est, step_size):
    """``step_prep``'s plain version: the gap as (S,) values."""
    x_flat = L.padded_to_flat(dp, xp)
    gp = L.flat_to_padded(dp, g_flat)
    gap = fw_gap(dp, g_flat, x_flat, gp)
    t0 = torch.full_like(f, step_size) if step_size > 0 else Q.inv_lipschitz(L_est, f)
    t0b = t0[:, None, None]
    return tuple(x - t0b * g for x, g in zip(xp, gp)), x_flat, gap


def dir_plain(dp, xhat, xp, x_flat, g_flat) -> Direction:
    """``step_dir``'s plain version: d subtracted in place into xhat's
    buckets (fresh from the projection), no operand, g.d as (S,) values."""
    dxp = tuple(xh.sub_(x) for xh, x in zip(xhat, xp))
    d_flat = L.padded_to_flat(dp, dxp)
    return Direction(d_flat, None, L.xdot(dp, g_flat, d_flat), dxp)


def update_plain(dp, xp, x_flat, r, d: Direction, Ad, gap):
    """``step_update``'s plain version, from ``dir_plain``'s direction."""
    t = Q.exact_step(dp, d.dot, Ad, 0.0, 1.0)
    # x + t d and r + t Ad are written into the buffers of d and Ad, which
    # the step owns (every dot product that reads them is taken above)
    tb = t[:, None, None]
    xp_new = tuple(dd.mul_(tb).add_(x) for x, dd in zip(xp, d.buckets))
    r_new = Ad.mul_(t[:, None]).add_(r)
    return xp_new, r_new, Q.objective_from_residual(dp, r_new), gap


# ---------------------------------------------------------------- the kernels


def _entry(name, argtypes):
    fn = getattr(cudalib.load(), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


_P = ctypes.c_void_p
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)
_I, _LL = ctypes.c_int, ctypes.c_longlong
_PREP_ARGS = [_PP, _PP, _PP, _PP, _PI, _PI, _I, _P, _P, _P, _P, ctypes.c_double, _I, _LL, _I, _P]
_DIR_ARGS = [_PP, _PI, _PI, _I, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _P]
_DOTS_ARGS = [_P, _P, _P, _P, _P, _I, _LL, _I, _I, _P]
_APPLY_ARGS = [_PP, _PI, _PI, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _LL, _LL, _I, _I,
               _I, _I, _P]


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))


def _ints(vals):
    return (ctypes.c_int * len(vals))(*vals)


def _check(name, tensors, flat=(), buckets=()):
    """1 to MAX_BUCKETS buckets (S, Bk, w) with w <= 128; float32 (int32 for
    ``sizes``), contiguous, one CUDA device; each flat tensor (S, n)."""
    if not 1 <= len(buckets) <= MAX_BUCKETS:
        raise ValueError(f"{name}: {len(buckets)} buckets, the kernel takes 1 to {MAX_BUCKETS}")
    if any(t.ndim != 2 for t in flat) or any(b.ndim != 3 for b in buckets):
        raise ValueError(f"{name}: flat vectors must be (S, n) and buckets (S, Bk, w)")
    if any(b.shape[-1] > _MAX_WIDTH for b in buckets):
        raise ValueError(f"{name}: buckets wider than {_MAX_WIDTH}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: tensors must be contiguous")
    devices = {t.device for t in tensors}
    if len(devices) > 1:
        raise ValueError(f"{name}: tensors lie on different devices")
    if devices.pop().type != "cuda":
        raise ValueError(f"{name}: all tensors must lie on a CUDA device")
    for t in (*flat, *buckets):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 only, got {t.dtype}")
    S = flat[0].shape[0]
    if any(t.shape[0] != S for t in (*flat, *buckets)):
        raise ValueError(f"{name}: every tensor must hold the same {S} scenarios")
    if any(t.shape != flat[0].shape for t in flat[1:]):
        raise ValueError(f"{name}: flat vectors of different lengths")
    if sum(b.shape[1] * b.shape[2] for b in buckets) != flat[0].shape[1]:
        raise ValueError(f"{name}: the buckets do not tile the flat vector")
    return S, flat[0].shape[1]


def _shapes(buckets):
    return [(b.shape[1], b.shape[2]) for b in buckets]


def _stream():
    return torch.cuda.current_stream().cuda_stream


def step_prep(dp, xp, g_flat: torch.Tensor, f: torch.Tensor, L_est, step_size: float):
    """(cand, x_flat, gap) of the step from x (``xp``, the state's buckets),
    g (S, n_pf) and t0: ``step_size`` if positive, else 1 / ``L_est`` (a
    float or a 0-d tensor) rounded once to float32, as
    ``quadratic.inv_lipschitz`` gives it (``f`` lends its shape and dtype).
    ``cand``: fresh buckets of x - t0 g; ``x_flat``: x as one (S, n_pf)
    vector; ``gap``: the kernel's (2, S, blocks) parts of the Frank-Wolfe
    gap, which ``step_update`` finishes."""
    # a warm start's buckets may be views of one flat vector
    xp = tuple(x.contiguous() for x in xp)
    g_flat = g_flat.contiguous()
    sizes = [bk.sizes for bk in dp.buckets]
    radius = [bk.radius for bk in dp.buckets]
    S, n = _check("step_prep", (g_flat, *xp, *sizes, *radius), flat=(g_flat,), buckets=xp)
    if any(s.dtype != torch.int32 for s in sizes) or any(r.dtype != torch.float32
                                                         for r in radius):
        raise TypeError("step_prep: sizes must be int32 and radii float32")
    Lt = (L_est.to(device=g_flat.device, dtype=torch.float64) if isinstance(L_est, torch.Tensor)
          else torch.full((), float(L_est), dtype=torch.float64, device=g_flat.device))
    _, _, C = prep_plan(S, _shapes(xp))
    cand = tuple(torch.empty_like(x) for x in xp)
    x_flat = torch.empty_like(g_flat)
    parts = torch.empty((2, S, C), dtype=torch.float32, device=g_flat.device)
    fn = _entry("bsls_step_prep", _PREP_ARGS)
    with torch.cuda.device(g_flat.device):
        err = fn(_ptrs(xp), _ptrs(cand), _ptrs(sizes), _ptrs(radius),
                 _ints([x.shape[1] for x in xp]), _ints([x.shape[2] for x in xp]), len(xp),
                 g_flat.data_ptr(), x_flat.data_ptr(), parts.data_ptr(), Lt.data_ptr(),
                 float(step_size), S, n, C, _stream())
    cudalib.launched("step_prep", err)
    return cand, x_flat, parts


def step_dir(dp, xhat, xp, x_flat: torch.Tensor, g_flat: torch.Tensor) -> Direction:
    """The step's direction d = xhat - x (``Direction``): one pass over
    xhat, x_flat and g writes d flat, its (n_pf, S) copy where
    ``layout.takes_operand(dp.A)``, and the (S, blocks) parts of g.d; xhat
    is left as it is, for ``step_update`` to overwrite (``xp``, x's buckets,
    is read by the plain version alone)."""
    xhat = tuple(xhat)
    g_flat = g_flat.contiguous()
    S, n = _check("step_dir", (x_flat, g_flat, *xhat), flat=(x_flat, g_flat), buckets=xhat)
    ts, _, _, _, C = dir_plan(S, _shapes(xhat))
    d_flat = torch.empty_like(g_flat)
    d_op = torch.empty((n, S), dtype=torch.float32, device=g_flat.device) \
        if L.takes_operand(dp.A) else None
    parts = torch.empty((S, C), dtype=torch.float32, device=g_flat.device)
    fn = _entry("bsls_step_dir", _DIR_ARGS)
    with torch.cuda.device(g_flat.device):
        err = fn(_ptrs(xhat), _ints([x.shape[1] for x in xhat]), _ints([x.shape[2] for x in xhat]),
                 len(xhat), x_flat.data_ptr(), g_flat.data_ptr(), d_flat.data_ptr(),
                 None if d_op is None else d_op.data_ptr(), parts.data_ptr(), S, n, C,
                 ts.bit_length() - 1, _stream())
    cudalib.launched("step_dir", err)
    return Direction(d_flat, d_op, parts, xhat)


def step_update(dp, xp, x_flat: torch.Tensor, r: torch.Tensor, d: Direction, Ad: torch.Tensor,
                gap: torch.Tensor):
    """(x + t d as buckets, r + t Ad, f, gap) with the exact step t per
    scenario (``quadratic.exact_step`` on [0, 1]) from d's ``dot`` and
    Ad.Ad; f = 0.5 r.r of the new r; ``gap`` as ``step_prep`` gave it,
    finished.  The new x is written into ``d.buckets`` and the new r into
    ``Ad``, both the step's own.  Two launches: "dots" (Ad.Ad's parts, the
    gap finished), "apply" (t, x, r, r.r's parts; its last block finishes
    f).  ``xp`` is read by the plain version alone."""
    xnew = tuple(d.buckets)
    # a banded product leaves Ad strided: its contiguous copy is the step's too
    r, Ad = r.contiguous(), Ad.contiguous()
    S, n = _check("step_update", (x_flat, d.flat, r, Ad, d.dot, gap, *xnew),
                  flat=(x_flat, d.flat), buckets=xnew)
    m = r.shape[-1]
    if r.shape != (S, m) or Ad.shape != (S, m) or r.dtype != torch.float32 \
            or Ad.dtype != torch.float32:
        raise ValueError(f"step_update: r and Ad must be float32 ({S}, {m}), got "
                         f"{tuple(r.shape)} and {tuple(Ad.shape)}")
    shapes = _shapes(xnew)
    _, C1 = prep_plan(S, shapes)[1:]
    C2 = dir_plan(S, shapes)[4]
    _, C3, _, _, C4, lanes = update_plan(S, shapes, m)
    if gap.shape != (2, S, C1) or d.dot.shape != (S, C2):
        raise ValueError("step_update: the parts of the gap and of g.d are not those of "
                         "step_prep and step_dir at these shapes")
    dev = r.device
    aparts = torch.empty((S, C3), dtype=torch.float32, device=dev)
    rparts = torch.empty((S, C4), dtype=torch.float32, device=dev)
    gap_out = torch.empty(S, dtype=torch.float32, device=dev)
    f = torch.empty(S, dtype=torch.float32, device=dev)
    done = torch.empty(1, dtype=torch.int32, device=dev)
    dots = _entry("bsls_step_dots", _DOTS_ARGS)
    apply = _entry("bsls_step_apply", _APPLY_ARGS)
    with torch.cuda.device(dev):
        stream = _stream()
        err = dots(Ad.data_ptr(), aparts.data_ptr(), gap.data_ptr(), gap_out.data_ptr(),
                   done.data_ptr(), S, m, C3, C1, stream)
        cudalib.launched("step_update", err)
        err = apply(_ptrs(xnew), _ints([x.shape[1] for x in xnew]),
                    _ints([x.shape[2] for x in xnew]), len(xnew), x_flat.data_ptr(),
                    d.flat.data_ptr(), r.data_ptr(), Ad.data_ptr(), Ad.data_ptr(),
                    d.dot.data_ptr(), aparts.data_ptr(), rparts.data_ptr(), f.data_ptr(),
                    done.data_ptr(), S, n, m, C4, C2, C3, lanes, stream)
    cudalib.launched("step_update", err)
    return xnew, Ad, f, gap_out
