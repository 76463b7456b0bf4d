"""Device-side problem layout: the padded-flat ("PF") data path, in the gather
and the banded layout.

The columns of A are permuted **once at prepare time** into bucket-major,
padded order — one (zero) column per padded slot.  Then

    padded buckets  <-> PF flat vector      is a reshape/concat,

so the hot loop moves between the flat vector that the matrix products want
and the ``(S, Bk, w)`` rectangles that the per-block kernels want without any
gather.  The cost is a bounded fraction of zero columns in A (padding waste
< 2x within a bucket).

Counterpart of ``bsls_tpu/ops/layout.py`` for one device.  Where the
reference vmaps over scenarios, every function here takes an explicit leading
scenario axis: a flat vector is ``(n,)`` or ``(S, n)``, a padded bucket
``(Bk, w)`` or ``(S, Bk, w)``.  ``prepare(layout="auto")`` tries the banded
layout (``ops/banded.py``) for a sparse A (an ``EllMatrix``) with fewer than
16 scenarios and keeps the gather layout otherwise.  The stacked operator
``[A; s C]`` of the equality-constrained path is a ``DeviceVStack`` of two
gather-layout parts whose scale ``s`` is a 0-d tensor, so the augmented
Lagrangian's penalty changes without a new ``prepare``.  The sharded
encodings are not ported yet.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ..models.partition import BlockPartition
from ..models.problem import DenseMatrix, EllMatrix, Problem, ScaledMatrix, VStackMatrix
from .banded import PAGE, DeviceBanded, banded_matvec, banded_rmatvec, build_banded_split

__all__ = [
    "DeviceDense",
    "DeviceEll",
    "DeviceBanded",
    "DeviceVStack",
    "DeviceBucket",
    "DeviceProblem",
    "build_pf_perm",
    "to_device_matrix",
    "block_scales",
    "prepare",
    "resolve_device",
    "flat_to_padded",
    "padded_to_flat",
    "extract_user_flat",
    "inject_user_flat",
    "inject_user_grad",
    "feasible_init",
    "gather_dot",
    "matvec",
    "rmatvec",
    "xdot",
    "rdot",
    "xmatdot",
]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` without a card raises:
    nothing in this package falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev


@dataclass(frozen=True)
class DeviceDense:
    data: torch.Tensor  # (m, n_pf)


@dataclass(frozen=True)
class DeviceEll:
    """Dual-ELL sparse matrix on device: gathers only, no scatters.

    Column-oriented arrays (rows/vals, from models.problem.EllMatrix) drive
    A^T r as a gather; a row-oriented copy (mv_cols/mv_vals, built at
    prepare time with PF column indices) drives A @ x as a gather.

    *Row-nnz bucketing*: padding every row to the max nnz would gather mostly
    padding.  At prepare time rows are permuted so nnz counts are ascending
    (b permuted to match — the row order of a least-squares system is
    arbitrary) and grouped into power-of-two widths; mv_cols/mv_vals are
    then TUPLES of (m_k, w_k) arrays whose partial results concatenate
    contiguously.  Without bucketing they are single (1, m, kr) arrays.  A
    pathological kr > ROW_ELL_MAX_K drops the row copy (None) -> index_add
    fallback.
    """

    rows: torch.Tensor  # (n_pf, k) int32 — column-oriented (for A^T r)
    vals: torch.Tensor  # (n_pf, k)
    mv_cols: Optional[object]  # tuple[(m_k, w_k)] or (1, m, kr) int32
    mv_vals: Optional[object]  # matching values
    num_rows: int
    # col-nnz-bucketed A^T r copy: columns sorted by nonzero count into a few
    # width groups so padding slots are never gathered; partials concatenate
    # in sorted-column order and one final (n_pf,)-row gather (rt_inv)
    # restores PF order.
    rt_rows: Optional[tuple] = None  # tuple[(n_g, w_g)] int32
    rt_vals: Optional[tuple] = None
    rt_inv: Optional[torch.Tensor] = None  # (n_pf,) int32 rank in sorted order
    rt_zeros: int = 0  # count of zero-nnz columns (emitted as zeros)


ROW_ELL_MAX_K = 512


@dataclass(frozen=True)
class DeviceVStack:
    """[top; scale * bottom] vertical stack (the augmented-Lagrangian operator
    [A; sqrt(rho) C]).  ``bottom_scale`` is a 0-d tensor on the device, so rho
    changes by swapping it, with no re-preparation; ``split`` is the number
    of rows of the top part."""

    top: "DeviceMatrix"
    bottom: "DeviceMatrix"
    bottom_scale: torch.Tensor  # 0-d
    split: int


DeviceMatrix = Union[DeviceDense, DeviceEll, DeviceBanded, DeviceVStack]


@dataclass(frozen=True)
class DeviceBucket:
    mask: torch.Tensor  # (Bk, w) 1.0 real / 0.0 padding
    sizes: torch.Tensor  # (Bk,) int32 true block sizes (0 for dummy rows)
    radius: torch.Tensor  # (Bk,) simplex radius per block (block equilibration)
    width: int


@dataclass(frozen=True)
class DeviceProblem:
    """Device-side problem, unsharded.  ``b`` keeps the shape the user gave:
    (m,) for one right-hand side or (S, m) for S scenarios.  ``perm`` follows
    the partition the layout solves under: the banded layout regroups the
    blocks by row window, and extraction maps back through ``perm`` alone."""

    A: DeviceMatrix
    b: torch.Tensor  # (m,) single scenario or (S, m)
    buckets: tuple  # tuple[DeviceBucket, ...]
    perm: torch.Tensor  # (n_pf,) int32: user-flat index per PF slot, -1 = pad
    n_user: int  # user flat length N
    num_rows: int
    row_perm: Optional[torch.Tensor] = None  # (m,) original row id per
    # device-row position (set when row-nnz bucketing permuted the rows)

    @property
    def n_pf(self) -> int:
        return self.perm.shape[0]

    @property
    def device(self) -> torch.device:
        return self.b.device


# ---------------- preparation (host side, numpy) ----------------


def build_pf_perm(part: BlockPartition) -> np.ndarray:
    """PF column order: bucket-major, row-major, slot-minor.

    Returns (n_pf,) int32: the user-flat column index of each PF slot, or -1
    for padding slots.
    """
    chunks = [
        np.where(b.mask > 0, b.pad_to_flat, -1).astype(np.int32).reshape(-1)
        for b in part.buckets
    ]
    perm = np.concatenate(chunks)
    assert perm.size == part.padded_size
    return perm


def _build_row_ell_bucketed(rows_pf, vals_pf, num_rows: int):
    """Row-nnz-bucketed row-ELL: returns (row_perm, mv_cols_tuple,
    mv_vals_tuple) where row_perm sorts rows by nonzero count ascending and
    the tuples hold (m_k, w_k) groups whose matvec partials concatenate to y
    in *permuted* row order.
    """
    n_pf, k = rows_pf.shape
    nz = vals_pf != 0
    counts = np.zeros(num_rows, np.int64)
    np.add.at(counts, rows_pf[nz], 1)
    if counts.max() > ROW_ELL_MAX_K:
        return None, None, None
    row_perm = np.argsort(counts, kind="stable")
    rank = np.empty(num_rows, np.int64)
    rank[row_perm] = np.arange(num_rows)
    counts_sorted = counts[row_perm]

    # nonzeros grouped by permuted row (native single-pass ELL encode),
    # position within row; groups then slice off the full-width encode
    from ..native import group_ell

    pf_pos = np.broadcast_to(np.arange(n_pf)[:, None], (n_pf, k))[nz].astype(np.int32)
    r_new = rank[rows_pf[nz]]
    v = vals_pf[nz]
    full_cols, full_vals = group_ell(r_new, pf_pos, v, num_rows)

    # power-of-two bucket widths over the sorted-row space; min width 4
    # bounds the number of gather groups (one launch sequence per group)
    # while keeping most of the row savings
    widths = []
    mx = max(int(counts_sorted.max()), 1)
    w = min(4, mx)
    while w < mx:
        widths.append(w)
        w *= 2
    widths.append(mx)
    widths = sorted(set(widths))
    mv_cols, mv_vals = [], []
    lo = 0
    for w in widths:
        hi = int(np.searchsorted(counts_sorted, w, side="right"))
        if hi <= lo:
            continue
        mv_cols.append(np.ascontiguousarray(full_cols[lo:hi, :w]))
        mv_vals.append(np.ascontiguousarray(full_vals[lo:hi, :w]))
        lo = hi
    assert lo == num_rows, (lo, num_rows)
    return row_perm, tuple(mv_cols), tuple(mv_vals)


def _build_row_ell(rows_pf, vals_pf, num_rows: int):
    """Build the row-oriented (gather) ELL copy from PF column-oriented data.

    rows_pf/vals_pf: (n_pf, k) with zeros on padding.  Returns
    (mv_cols, mv_vals) of shape (1, m, kr) with PF column indices, or
    (None, None) if kr would exceed ROW_ELL_MAX_K.  The leading axis of
    length 1 is the reference's shard axis at n_shards = 1.
    """
    from ..native import group_ell

    n_pf, k = rows_pf.shape
    nz = vals_pf != 0
    if not nz.any():
        return (
            np.zeros((1, num_rows, 1), np.int32),
            np.zeros((1, num_rows, 1), vals_pf.dtype),
        )
    pf_pos = np.broadcast_to(np.arange(n_pf)[:, None], (n_pf, k))[nz].astype(np.int32)
    key = rows_pf[nz].astype(np.int64)
    v = vals_pf[nz]
    # reject on the per-row width before group_ell allocates the (G, W) arrays
    if np.bincount(key, minlength=num_rows).max() > ROW_ELL_MAX_K:
        return None, None
    mv_cols, mv_vals = group_ell(key, pf_pos, v, num_rows)
    kr = mv_cols.shape[1]
    return mv_cols.reshape(1, num_rows, kr), mv_vals.reshape(1, num_rows, kr)


def _build_col_ell_bucketed(rows_pf, vals_pf, max_groups: int = 6):
    """Col-nnz-bucketed A^T r layout: sort PF columns by nonzero count into
    <= max_groups width groups (widths = count quantiles, so padding beyond
    a column's own count is bounded by the group spread).  Returns
    (rt_rows, rt_vals, rt_inv, n_zero): group tuples in ascending-count
    order, the PF->sorted-position rank, and the number of zero-nnz columns
    (those are never gathered — their g entries are emitted as zeros)."""
    n_pf, k = rows_pf.shape
    nz = vals_pf != 0
    counts = nz.sum(axis=1)
    # compact each column's nonzeros into the leading slots (interior zeros
    # would otherwise be dropped by the [:w] slice below)
    cidx = np.argsort(~nz, axis=1, kind="stable")
    rows_pf = np.take_along_axis(rows_pf, cidx, axis=1)
    vals_pf = np.take_along_axis(vals_pf, cidx, axis=1)
    order = np.argsort(counts, kind="stable")
    rank = np.empty(n_pf, np.int64)
    rank[order] = np.arange(n_pf)
    counts_sorted = counts[order]
    n_zero = int(np.searchsorted(counts_sorted, 1))
    pos = np.asarray(counts_sorted[n_zero:], np.int64)
    # group boundaries: up to max_groups distinct count levels (quantiles)
    if pos.size:
        qs = np.quantile(pos, np.linspace(1.0 / max_groups, 1.0, max_groups))
        levels = sorted(set(int(np.ceil(q)) for q in qs) | {int(pos[-1])})
    else:
        levels = []
    # only worth it if the grouped gather count (plus the n_pf-row inverse
    # rank gather) beats the plain (n_pf, k) gather; uniform-nnz instances
    # would only pay the extra rank gather
    grouped_rows = n_pf  # the rt_inv rank gather
    lo = n_zero
    group_spans = []
    for w in levels:
        hi = int(np.searchsorted(counts_sorted, w, side="right"))
        if hi <= lo:
            continue
        group_spans.append((lo, hi, w))
        grouped_rows += (hi - lo) * w
        lo = hi
    assert lo == n_pf, (lo, n_pf)
    if grouped_rows >= 0.9 * n_pf * k:
        return None, None, None, 0
    rt_rows, rt_vals = [], []
    for lo_g, hi_g, w in group_spans:
        sel = order[lo_g:hi_g]  # PF columns in this group (count <= w)
        rt_rows.append(np.ascontiguousarray(rows_pf[sel, :w]))
        rt_vals.append(np.ascontiguousarray(vals_pf[sel, :w]))
    return tuple(rt_rows), tuple(rt_vals), rank.astype(np.int32), n_zero


def _np_float(dtype: torch.dtype) -> np.dtype:
    """Host staging buffers match the requested device precision: staging
    through float32 would silently quantize a float64 prepare()."""
    return np.dtype(np.float64 if dtype == torch.float64 else np.float32)


def to_device_matrix(
    M, perm: np.ndarray, dtype=torch.float32, col_scale=None,
    row_bucket: bool = False, device="cuda", _out: Optional[dict] = None,
) -> "DeviceMatrix":
    """Move a host matrix to device with PF column permutation/padding.

    ``col_scale`` (N,) divides each user column (block equilibration).
    ``row_bucket=True`` (EllMatrix only) permutes rows by nnz count into
    power-of-two width groups — the caller must permute b with the
    ``row_perm`` stashed into ``_out``."""
    dev = resolve_device(device)
    np_dtype = _np_float(dtype)

    def fl(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def ix(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=dev)

    sel = perm >= 0
    cs = None if col_scale is None else np.asarray(col_scale)[perm[sel]]
    if isinstance(M, DenseMatrix):
        data = np.zeros((M.shape[0], perm.size), dtype=np_dtype)
        cols = np.asarray(M.data)[:, perm[sel]]
        data[:, sel] = cols if cs is None else cols / cs
        return DeviceDense(data=fl(data))
    if isinstance(M, EllMatrix):
        rows = np.zeros((perm.size, M.k), dtype=np.int32)
        vals = np.zeros((perm.size, M.k), dtype=np_dtype)
        rows[sel] = np.asarray(M.rows)[perm[sel]]
        v = np.asarray(M.vals)[perm[sel]]
        vals[sel] = v if cs is None else v / cs[:, None]
        if row_bucket:
            row_perm, mvc, mvv = _build_row_ell_bucketed(rows, vals, M.num_rows)
            if row_perm is not None:
                rank = np.empty(M.num_rows, np.int64)
                rank[row_perm] = np.arange(M.num_rows)
                rows = rank[rows].astype(np.int32)  # col-ELL in permuted space
                if _out is not None:
                    _out["row_perm"] = row_perm
                rt_r, rt_v, rt_inv, n_zero = _build_col_ell_bucketed(rows, vals)
                return DeviceEll(
                    rows=ix(rows),
                    vals=fl(vals),
                    mv_cols=tuple(ix(c) for c in mvc),
                    mv_vals=tuple(fl(v2) for v2 in mvv),
                    num_rows=M.num_rows,
                    rt_rows=None if rt_r is None else tuple(ix(c) for c in rt_r),
                    rt_vals=None if rt_v is None else tuple(fl(v2) for v2 in rt_v),
                    rt_inv=None if rt_inv is None else ix(rt_inv),
                    rt_zeros=n_zero,
                )
        mv_cols, mv_vals = _build_row_ell(rows, vals, M.num_rows)
        return DeviceEll(
            rows=ix(rows),
            vals=fl(vals),
            mv_cols=None if mv_cols is None else ix(mv_cols),
            mv_vals=None if mv_vals is None else fl(mv_vals),
            num_rows=M.num_rows,
        )
    if isinstance(M, VStackMatrix):
        # each part keeps its own row order (no row-nnz bucketing: the
        # stacked right-hand side is [b; b_bottom] as the caller builds it)
        scale, bottom = 1.0, M.bottom
        if isinstance(bottom, ScaledMatrix):
            scale, bottom = bottom.scale, bottom.inner
        return DeviceVStack(
            top=to_device_matrix(M.top, perm, dtype, col_scale, device=dev),
            bottom=to_device_matrix(bottom, perm, dtype, col_scale, device=dev),
            bottom_scale=torch.tensor(scale, dtype=dtype, device=dev),
            split=M.top.shape[0],
        )
    raise TypeError(f"unsupported host matrix type {type(M)}")


def _col_norms_sq(M) -> np.ndarray:
    """Host-side squared column norms (for equilibration)."""
    if isinstance(M, DenseMatrix):
        return (np.asarray(M.data) ** 2).sum(axis=0)
    if isinstance(M, EllMatrix):
        return (np.asarray(M.vals) ** 2).sum(axis=1)
    if isinstance(M, ScaledMatrix):
        return M.scale**2 * _col_norms_sq(M.inner)
    if isinstance(M, VStackMatrix):
        return _col_norms_sq(M.top) + _col_norms_sq(M.bottom)
    raise TypeError(f"unsupported host matrix type {type(M)}")


def block_scales(problem: Problem) -> np.ndarray:
    """Per-block equilibration scale c_b = RMS column norm of A over the block.

    Solving in u = c_b * x (simplex radius c_b, A columns divided by c_b)
    equalises block curvatures — demand-scaled traffic instances otherwise
    condition the problem by (max demand / min demand)^2.
    """
    part = problem.partition
    cn2 = _col_norms_sq(problem.A)
    sizes = part.sizes
    block_of_col = np.repeat(np.arange(part.num_blocks), sizes)
    sums = np.zeros(part.num_blocks)
    np.add.at(sums, block_of_col, cn2)
    c = np.sqrt(sums / np.maximum(sizes, 1))
    c[c <= 0] = 1.0
    return c


def _device_buckets(part: BlockPartition, c: np.ndarray, dtype, dev) -> tuple:
    """The partition's buckets on the device; ``c`` are the per-block scales."""
    return tuple(
        DeviceBucket(
            mask=torch.as_tensor(b.mask, dtype=dtype, device=dev),
            sizes=torch.as_tensor(b.sizes, dtype=torch.int32, device=dev),
            radius=torch.as_tensor(
                np.where(b.block_ids >= 0, c[np.maximum(b.block_ids, 0)], 1.0),
                dtype=dtype, device=dev,
            ),
            width=b.width,
        )
        for b in part.buckets
    )


def _scales(problem: Problem, equilibrate: bool):
    """(per-block scale c, per-user-column scale or None)."""
    part = problem.partition
    if equilibrate:
        c = block_scales(problem)
        return c, np.repeat(c, part.sizes)
    return np.ones(part.num_blocks), None


def _prepare_banded(
    problem: Problem, dtype, equilibrate: bool, force: bool, dev: torch.device,
    fit_threshold: float = 0.6, band_budget_bytes: int = 2 << 30,
) -> Optional[DeviceProblem]:
    """Try the banded-split layout (ops/banded.py): re-orders blocks by row
    window, builds per-bucket band tensors and a sparse residual.  Returns the
    DeviceProblem — whose ``perm`` and buckets follow the VALUE-GROUPED
    partition — or None when the instance is not bandable enough (fit
    fraction below threshold) or the band tensors would exceed the memory
    budget; the caller then falls back to the gather layout.  ``b`` stays in
    the user's row order: the row-nnz bucketing does not apply here."""
    part = problem.partition
    A0: EllMatrix = problem.A
    # per-block window page: min nonzero row page over the block's columns
    nzmask = np.asarray(A0.vals) != 0
    rows_h = np.asarray(A0.rows)
    col_min = np.where(nzmask, rows_h, np.iinfo(np.int32).max).min(axis=1)
    col_max = np.where(nzmask, rows_h, -1).max(axis=1)
    offsets = np.concatenate([[0], np.cumsum(part.sizes)])[:-1]
    Mp = -(-A0.num_rows // PAGE)
    block_page = np.clip(np.minimum.reduceat(col_min, offsets) // PAGE, 0, Mp - 1)

    # cheap pre-screens BEFORE building the grouped partition (the full
    # attempt is host work that instances which cannot qualify should not pay):
    # (a) nnz-weighted fraction of columns whose row span fits any window
    col_nnz = nzmask.sum(axis=1)
    span_ok = (col_max - col_min) <= 7 * PAGE  # max_pages=8 window
    frac_ok = float(col_nnz[span_ok & (col_nnz > 0)].sum()) / max(col_nnz.sum(), 1)
    if frac_ok < fit_threshold and not force:
        return None
    # (b) band memory at the value-grouped inflation (bpp = max page load)
    bpp = int(np.bincount(block_page, minlength=Mp).max())
    est_bytes = Mp * bpp * float(np.mean(part.sizes) + 2) * 1024 * 4
    if est_bytes > band_budget_bytes and not force:
        return None

    # value-grouped partition: a block's PF row exactly encodes its window
    # page, so the banded ladder is exact (groups padded to max page load).
    # BSLS_BAND_CAP=<q> caps the load at that quantile of the page loads
    # (overflow blocks carry forward a page and the window's `back` margin
    # absorbs the shift): less band memory, but the carried-forward blocks
    # widen the effective window of every later page.  Off by default, as in
    # the reference; for when device memory, not throughput, binds.
    cap_env = os.environ.get("BSLS_BAND_CAP", "none")
    cap_q = None if cap_env.lower() == "none" else float(cap_env)
    part2 = BlockPartition.from_sizes(part.sizes, order_key=block_page, groups=Mp,
                                      group_cap_quantile=cap_q)

    perm = build_pf_perm(part2)
    c, col_scale = _scales(problem, equilibrate)
    np_dtype = _np_float(dtype)
    sel = perm >= 0
    rows_pf = np.zeros((perm.size, A0.k), dtype=np.int32)
    vals_pf = np.zeros((perm.size, A0.k), dtype=np_dtype)
    rows_pf[sel] = rows_h[perm[sel]]
    v = np.asarray(A0.vals)[perm[sel]]
    cs = None if col_scale is None else col_scale[perm[sel]]
    vals_pf[sel] = v if cs is None else v / cs[:, None]

    seg_lens = [b.num_blocks * b.width for b in part2.buckets]
    bands, back, wpages, fit, (res_rows, res_vals) = build_banded_split(
        rows_pf, vals_pf, A0.num_rows, seg_lens, dtype=np_dtype, pages=Mp
    )
    if fit < fit_threshold and not force:
        return None

    def fl(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def ix(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=dev)

    resid = None
    if (res_vals != 0).any():
        mv_cols, mv_vals = _build_row_ell(res_rows, res_vals, A0.num_rows)
        rt_r, rt_v, rt_inv, n_zero = _build_col_ell_bucketed(res_rows, res_vals)
        resid = DeviceEll(
            rows=ix(res_rows),
            vals=fl(res_vals),
            mv_cols=None if mv_cols is None else ix(mv_cols),
            mv_vals=None if mv_vals is None else fl(mv_vals),
            num_rows=A0.num_rows,
            rt_rows=None if rt_r is None else tuple(ix(x) for x in rt_r),
            rt_vals=None if rt_v is None else tuple(fl(x) for x in rt_v),
            rt_inv=None if rt_inv is None else ix(rt_inv),
            rt_zeros=n_zero,
        )
    A = DeviceBanded(
        bands=tuple(fl(bd) for bd in bands),
        resid=resid,
        num_rows=A0.num_rows,
        wpages=wpages,
        back=back,
        n_pf=int(perm.size),
        seg_lens=tuple(seg_lens),
        pages=Mp,
    )
    return DeviceProblem(
        A=A,
        b=fl(np.asarray(problem.b)),
        buckets=_device_buckets(part2, c, dtype, dev),
        perm=ix(perm),
        n_user=part.n_flat,
        num_rows=A0.num_rows,
    )


def prepare(
    problem: Problem,
    dtype=torch.float32,
    equilibrate: bool = True,
    layout: str = "auto",  # auto | banded | gather
    device="cuda",
) -> DeviceProblem:
    """Move a host Problem into the device-side PF layout.

    ``layout="auto"`` tries the banded layout for an ``EllMatrix`` with fewer
    than 16 scenarios and falls back to the gather layout when the instance
    is not bandable; with more scenarios it keeps the gather layout (the band
    tensors stream the same bytes whatever S is, while scenario batching
    amortises the gathers — the reference's crossover, kept as its
    behaviour).  ``layout="banded"`` forces the band at any S and raises on
    any other A; ``layout="gather"`` never tries it.  A stacked
    ``VStackMatrix`` always takes the gather layout.

    A ``Problem`` with equality constraints (``C``) is not prepared here:
    ``solve()`` runs it through the augmented-Lagrangian loop, which prepares
    the stacked problem ``[A; sqrt(rho) C]`` (whose ``C`` is ``None``)."""
    if layout not in ("auto", "banded", "gather"):
        raise ValueError(f"unknown layout {layout!r}")
    if problem.C is not None:
        raise ValueError(
            "prepare() takes no equality-constrained Problem (Problem.C is set): "
            "pass it to solve(), which runs the augmented-Lagrangian loop "
            "(solvers.eq_constrained) on the stacked operator [A; sqrt(rho) C]")
    dev = resolve_device(device)
    b_host = np.asarray(problem.b)
    num_scenarios = int(b_host.shape[0]) if b_host.ndim == 2 else 1
    if layout == "banded" or (layout == "auto" and num_scenarios < 16):
        if isinstance(problem.A, EllMatrix):
            dp = _prepare_banded(problem, dtype, equilibrate, force=(layout == "banded"),
                                 dev=dev)
            if dp is not None:
                return dp
        elif layout == "banded":
            raise ValueError("layout='banded' requires an EllMatrix instance")
    part = problem.partition
    perm = build_pf_perm(part)
    c, col_scale = _scales(problem, equilibrate)
    buckets = _device_buckets(part, c, dtype, dev)
    out_info: dict = {}
    A = to_device_matrix(
        problem.A, perm, dtype, col_scale,
        row_bucket=isinstance(problem.A, EllMatrix), device=dev, _out=out_info,
    )
    b = b_host
    if "row_perm" in out_info:
        # r lives in the nnz-sorted row order from here on
        b = b[..., out_info["row_perm"]]
    return DeviceProblem(
        A=A,
        b=torch.as_tensor(np.ascontiguousarray(b), dtype=dtype, device=dev),
        buckets=buckets,
        perm=torch.as_tensor(perm, dtype=torch.int32, device=dev),
        n_user=part.n_flat,
        num_rows=problem.A.shape[0],
        row_perm=(
            torch.as_tensor(out_info["row_perm"], dtype=torch.int32, device=dev)
            if "row_perm" in out_info
            else None
        ),
    )


# ---------------- layout conversions (device, shape-driven) ----------------


def padded_to_flat(dp: DeviceProblem, xp) -> torch.Tensor:
    """Padded buckets -> PF flat vector: reshape/concat."""
    parts = [x.reshape(*x.shape[:-2], -1) for x in xp]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def flat_to_padded(dp: DeviceProblem, x_flat: torch.Tensor):
    """PF flat vector -> padded buckets: split + reshape (views, no copy)."""
    out = []
    off = 0
    lead = x_flat.shape[:-1]
    for bk in dp.buckets:
        rows, w = bk.mask.shape
        size = rows * w
        out.append(x_flat[..., off:off + size].reshape(*lead, rows, w))
        off += size
    return tuple(out)


def _user_index(dp: DeviceProblem):
    sel = dp.perm >= 0
    return sel, torch.clamp(dp.perm, min=0).long()


def extract_user_flat(dp: DeviceProblem, xp) -> torch.Tensor:
    """Map padded buckets back to the user's flat ordering (N,) or (S, N),
    undoing the equilibration scaling (u -> x = u / c_b).  Not a hot-path op
    — used once at result extraction."""
    xs = tuple(
        x / torch.clamp(bk.radius, min=1e-30)[:, None] for x, bk in zip(xp, dp.buckets)
    )
    x_pf = padded_to_flat(dp, xs)
    sel, idx = _user_index(dp)
    src = torch.where(sel, x_pf, torch.zeros((), dtype=x_pf.dtype, device=x_pf.device))
    out = torch.zeros(*x_pf.shape[:-1], dp.n_user, dtype=x_pf.dtype, device=x_pf.device)
    # padding slots all add 0 into user index 0; real slots are a bijection
    return out.index_add_(-1, idx, src)


def _scale_pf(dp: DeviceProblem) -> torch.Tensor:
    rad_p = tuple(bk.radius[:, None] * bk.mask for bk in dp.buckets)
    return padded_to_flat(dp, rad_p)


def inject_user_flat(dp: DeviceProblem, x_user: torch.Tensor):
    """Inverse of extract_user_flat: user-flat x (N,) or (S, N) -> padded
    equilibrated buckets (u = c_b * x).  Used for warm starts."""
    sel, idx = _user_index(dp)
    u_pf = torch.where(
        sel, x_user[..., idx] * _scale_pf(dp),
        torch.zeros((), dtype=x_user.dtype, device=x_user.device),
    )
    return flat_to_padded(dp, u_pf)


def inject_user_grad(dp: DeviceProblem, g_user: torch.Tensor) -> torch.Tensor:
    """User-flat GRADIENT (N,) or (S, N) -> PF flat in the equilibrated
    coordinates.  The device solves in u = c_b * x (block equilibration), so
    gradients transform inversely: g_dev = g_user / c_b.  Used by the
    iterative-refinement anchor (solvers/base.py refine_polish)."""
    sel, idx = _user_index(dp)
    return torch.where(
        sel, g_user[..., idx] / torch.clamp(_scale_pf(dp), min=1e-30),
        torch.zeros((), dtype=g_user.dtype, device=g_user.device),
    )


def feasible_init(dp: DeviceProblem, dtype=None, scenarios: Optional[int] = None):
    """Uniform feasible start: radius/n_i on each real block, 0 on padding
    and on dummy rows (sizes = 0).  ``scenarios=S`` gives each bucket a
    leading S axis."""
    xp = []
    for bk in dp.buckets:
        d = dtype or bk.mask.dtype
        inv = torch.where(
            bk.sizes > 0, bk.radius / torch.clamp(bk.sizes, min=1).to(d),
            torch.zeros((), dtype=d, device=bk.mask.device),
        )
        x = bk.mask.to(d) * inv[:, None]
        if scenarios is not None:
            x = x.unsqueeze(0).repeat(scenarios, 1, 1)
        xp.append(x)
    return tuple(xp)


# ---------------- matvec ----------------

# A batched gather materialises one (rows, k, S) buffer and its product with
# the values; above this many elements the rows are processed in segments so
# that the two temporaries stay bounded (256 MiB each in fp32).
_GATHER_CHUNK_ELEMS = 64 * 1024 * 1024


def _gather_dot_t(vals: torch.Tensor, idx: torch.Tensor, vec_t: torch.Tensor) -> torch.Tensor:
    """``vec_t`` is (n, S): every index pulls S contiguous floats.  Returns
    (rows, S)."""
    rows, k = idx.shape
    S = vec_t.shape[1]

    def seg(lo, hi):
        g = vec_t.index_select(0, idx[lo:hi].reshape(-1)).view(hi - lo, k, S)
        return g.mul_(vals[lo:hi, :, None]).sum(dim=1)  # g is a fresh buffer

    per = max(_GATHER_CHUNK_ELEMS // max(k * S, 1), 1)
    if rows <= per:
        return seg(0, rows)
    return torch.cat([seg(lo, min(lo + per, rows)) for lo in range(0, rows, per)])


def _batched(fn, vec: torch.Tensor) -> torch.Tensor:
    """Run ``fn`` on the (n, S) transpose of ``vec`` ((n,) or (S, n)) and
    return its (rows, S) result as (rows,) or (S, rows): the public functions
    keep (S, .) while the gathers see S contiguous floats per index."""
    if vec.ndim == 1:
        return fn(vec[:, None])[:, 0]
    return fn(vec.t().contiguous()).t().contiguous()


def gather_dot(vals: torch.Tensor, idx: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """sum(vals * vec[..., idx], axis=-1) for (rows, k) vals/idx and ``vec``
    of shape (n,) or (S, n); returns (rows,) or (S, rows).

    The batched form gathers from the transposed (n, S) vector and walks the
    rows in segments that bound the (rows, k, S) temporary."""
    return _batched(lambda vt: _gather_dot_t(vals, idx, vt), vec)


def matvec(A: DeviceMatrix, x: torch.Tensor) -> torch.Tensor:
    """A @ x for PF flat x of shape (n_pf,) or (S, n_pf)."""
    if isinstance(A, DeviceBanded):
        y = banded_matvec(A, x)
        return y if A.resid is None else y + matvec(A.resid, x)
    if isinstance(A, DeviceDense):
        # full fp32: TF32 is off package-wide (see bsls_tpu_torch/__init__.py)
        return x @ A.data.t()
    if isinstance(A, DeviceVStack):
        return torch.cat([matvec(A.top, x), A.bottom_scale * matvec(A.bottom, x)], dim=-1)
    if isinstance(A.mv_cols, tuple):
        # row-nnz-bucketed: per-width partials concatenate contiguously in
        # the (nnz-sorted) permuted row order — no scatter, minimal rows
        def run(xt):
            parts = [_gather_dot_t(v, c, xt) for c, v in zip(A.mv_cols, A.mv_vals)]
            return parts[0] if len(parts) == 1 else torch.cat(parts)

        return _batched(run, x)
    if A.mv_cols is not None:
        return _batched(lambda xt: _gather_dot_t(A.mv_vals[0], A.mv_cols[0], xt), x)
    # no row copy (a row wider than ROW_ELL_MAX_K): scatter-add fallback
    contrib = A.vals * x[..., :, None]  # (..., n, k)
    out = torch.zeros(*x.shape[:-1], A.num_rows, dtype=contrib.dtype, device=x.device)
    return out.index_add_(-1, A.rows.reshape(-1), contrib.reshape(*x.shape[:-1], -1))


def rmatvec(A: DeviceMatrix, r: torch.Tensor) -> torch.Tensor:
    """A^T @ r -> PF flat, for r of shape (m,) or (S, m)."""
    if isinstance(A, DeviceBanded):
        g = banded_rmatvec(A, r)
        return g if A.resid is None else g + rmatvec(A.resid, r)
    if isinstance(A, DeviceDense):
        return r @ A.data
    if isinstance(A, DeviceVStack):
        # one device holds all rows, so the top/bottom boundary is the static
        # split (the reference's _vstack_top_rows for unsharded rows)
        return (rmatvec(A.top, r[..., :A.split])
                + A.bottom_scale * rmatvec(A.bottom, r[..., A.split:]))
    if A.rt_rows is not None:
        # col-nnz-bucketed: gather only real nonzeros (grouped widths),
        # zero-nnz columns emitted directly, one rank gather to PF order
        def run(rt):
            parts = [_gather_dot_t(v, rw, rt) for rw, v in zip(A.rt_rows, A.rt_vals)]
            if A.rt_zeros:
                parts = [rt.new_zeros((A.rt_zeros, rt.shape[1]))] + parts
            g_sorted = parts[0] if len(parts) == 1 else torch.cat(parts)
            return g_sorted.index_select(0, A.rt_inv)

        return _batched(run, r)
    return _batched(lambda rt: _gather_dot_t(A.vals, A.rows, rt), r)


def xdot(dp: DeviceProblem, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product of x-space (PF flat) vectors over the last axis: a
    scalar for (n,) inputs, (S,) for (S, n)."""
    return (a * b).sum(dim=-1)


def rdot(dp: DeviceProblem, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product of r-space vectors over the last axis."""
    return (a * b).sum(dim=-1)


def xmatdot(dp: DeviceProblem, M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched x-space dots: (K, n) @ (n,) -> (K,), or per scenario
    (S, K, n) @ (S, n) -> (S, K).  One batched product instead of K serial
    dots (the L-BFGS compact form's history products), at full fp32: TF32 is
    off package-wide, and reduced-precision passes break 1e-6 convergence."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)
