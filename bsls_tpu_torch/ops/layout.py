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
Lagrangian's penalty changes without a new ``prepare``.

**Sharded encodings.**  ``prepare(n_shards=, row_shards=, shard=)`` lays A's
columns out device-major (every bucket's rows split evenly over the column
shards) and returns ONE rank's slice, the tile ``shard = (row shard, column
shard)``: the rank uploads only that.  Column-sharded ELL keeps the column
orientation of its own columns and a row copy with local column ids; a
row-sharded or 2-D ELL is re-encoded per tile with local row ids (and local
column ids on the 2-D grid).  A stacked ``DeviceVStack`` shards each part
alike: column-sharded, both take the rank's columns (A x partials of full
height); row-sharded, each part its own rows, so a rank holds the locally
stacked [top_k; s bottom_k].  ``col_group``/``row_group`` are the process
groups the columns and the rows are split over; ``matvec_ps``,
``rmatvec_ps``, ``psum_if_sharded``, ``xdot``, ``rdot`` and ``xmatdot``
all-reduce over them (``quadratic.diag_quad`` too, over the row group), and
with the sharded solve's gathers in ``parallel/sharding.py`` these are the only
collectives.  A group of size 1 still gets its collective: there is one
code path.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field, fields, replace
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models.partition import BlockPartition
from ..models.problem import DenseMatrix, EllMatrix, Problem, ScaledMatrix, VStackMatrix
from ..utils.profiling import span
from . import ellkernels
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
    "gather_counts",
    "block_scales",
    "prepare",
    "check_dtype",
    "resolve_device",
    "flat_to_padded",
    "padded_to_flat",
    "extract_user_flat",
    "inject_user_flat",
    "inject_user_grad",
    "feasible_init",
    "gather_dot",
    "takes_operand",
    "matvec",
    "rmatvec",
    "matvec_ps",
    "rmatvec_ps",
    "psum_if_sharded",
    "xdot",
    "rdot",
    "xmatdot",
]


def check_dtype(dtype, device) -> None:
    """The CUDA kernels (``proj_simplex_rows``, ``pava_rows``,
    ``band_zmv``/``band_grmv``, ``pgd_chunk``, ``ell_gather_dot``,
    ``step_prep``/``step_dir``/``step_update``) take float32 only, so a CUDA
    device takes no other dtype: refused here, from the device's type alone,
    before any upload or CUDA call.  Every other device takes any dtype."""
    if torch.device(device).type == "cuda" and dtype != torch.float32:
        raise ValueError(
            f"dtype={dtype} on a CUDA device: the CUDA kernels proj_simplex_rows, pava_rows, "
            "band_zmv/band_grmv, pgd_chunk, ell_gather_dot and pgd_step's "
            "step_prep/step_dir/step_update take float32 only; pass dtype=torch.float32 (the "
            "default) or device='cpu'")


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
    # nonzeros of this matrix (a rank's tile), counted on the host where the
    # layout is built; None where nobody counted them
    nnz: Optional[int] = None
    # slots that one A x and one A^T r read, padding included: derived from
    # the groups the products launch over once here (also by
    # dataclasses.replace), never in a step
    gather_slots: int = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "gather_slots", _product_slots(self))


def _product_slots(A: "DeviceEll") -> int:
    """Slots of one A x (the row copy's groups; without one, the scatter
    over every column slot) plus one A^T r (the column groups, or the plain
    column-ELL)."""
    mv = A.mv_cols if isinstance(A.mv_cols, tuple) else (A.mv_cols,)
    ax = math.prod(A.rows.shape) if A.mv_cols is None else sum(math.prod(c.shape) for c in mv)
    atr = (math.prod(A.rows.shape) if A.rt_rows is None
           else sum(math.prod(r.shape) for r in A.rt_rows))
    return ax + atr


def gather_counts(A) -> dict:
    """``gather_slots`` and ``gather_nnz`` of a gather-layout A: the slots
    that one A x and one A^T r read, padding included, and the nonzeros they
    cover (twice A's).  Empty for another layout or uncounted nonzeros."""
    if not isinstance(A, DeviceEll) or A.nnz is None:
        return {}
    return {"gather_slots": A.gather_slots, "gather_nnz": 2 * A.nnz}


ROW_ELL_MAX_K = 512


@dataclass(frozen=True)
class DeviceVStack:
    """[top; scale * bottom] vertical stack (the augmented-Lagrangian operator
    [A; sqrt(rho) C]).  ``bottom_scale`` is a 0-d tensor on the device, so rho
    changes by swapping it, with no re-preparation; ``split`` is the number
    of rows of the top part in this rank's view (its local height under row
    sharding, where each rank holds the locally stacked [top_k; s
    bottom_k])."""

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
    # (Bk,) int32 slots of the z-space fit, max(sizes - 1, 0): derived from
    # sizes once here (also by dataclasses.replace), not in every step
    zwidths: torch.Tensor = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "zwidths", torch.clamp(self.sizes - 1, min=0))


@dataclass(frozen=True)
class DeviceProblem:
    """Device-side problem.  ``b`` keeps the shape the user gave: (m,) for
    one right-hand side or (S, m) for S scenarios.  ``perm`` follows the
    partition the layout solves under: the banded layout regroups the blocks
    by row window, and extraction maps back through ``perm`` alone.

    A sharded problem is one rank's slice, and two optional process groups
    say how it is split (the counterparts of the reference's ``col_axis`` and
    ``row_axis``):

      col_group — A's columns (and x) split by block: A x partials and
                  x-space inner products are summed over it;
      row_group — A's rows (and r) split: A^T r partials and r-space inner
                  products are summed over it.

    Either, both or neither may be set; every collective of a solver step
    goes through ``matvec_ps``/``rmatvec_ps``/``xdot``/``rdot``/``xmatdot``/
    ``psum_if_sharded``.  ``n_user`` and ``num_rows`` are global."""

    A: DeviceMatrix
    b: torch.Tensor  # (m,) single scenario or (S, m)
    buckets: tuple  # tuple[DeviceBucket, ...]
    perm: torch.Tensor  # (n_pf,) int32: user-flat index per PF slot, -1 = pad
    n_user: int  # user flat length N
    num_rows: int
    row_perm: Optional[torch.Tensor] = None  # (m,) original row id per
    # device-row position (set when row-nnz bucketing permuted the rows)
    col_group: Optional[object] = None  # process group over A's column shards
    row_group: Optional[object] = None  # process group over A's row shards

    @property
    def sharded(self) -> bool:
        return self.col_group is not None or self.row_group is not None

    @property
    def n_pf(self) -> int:
        return self.perm.shape[0]

    @property
    def device(self) -> torch.device:
        return self.b.device


# ---------------- preparation (host side, numpy) ----------------


def build_pf_perm(part: BlockPartition, n_shards: int = 1) -> np.ndarray:
    """PF column order: device-major, bucket-minor, row-major, slot-minor.

    Returns (n_pf,) int32: the user-flat column index of each PF slot, or -1
    for padding slots.  Requires every bucket's row count to divide n_shards.
    """
    chunks = []
    for d in range(n_shards):
        for b in part.buckets:
            Bk = b.num_blocks
            if Bk % n_shards:
                raise ValueError(
                    f"bucket with {Bk} rows not divisible by n_shards={n_shards}; "
                    f"rebuild the partition with block_multiple={n_shards}")
            lo, hi = d * Bk // n_shards, (d + 1) * Bk // n_shards
            real = b.mask[lo:hi] > 0
            chunks.append(np.where(real, b.pad_to_flat[lo:hi], -1).astype(np.int32).reshape(-1))
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


def _ell_groups(keys, idx, vals, num_groups: int, width: int):
    """``group_ell`` padded to ``width`` slots: one shard's slice of an encode
    whose width is set by every shard."""
    from ..native import group_ell

    cols, out = group_ell(keys, idx, vals, num_groups)
    pad = width - cols.shape[1]
    if pad > 0:
        cols = np.pad(cols, ((0, 0), (0, pad)))
        out = np.pad(out, ((0, 0), (0, pad)))
    return cols, out


def _build_row_ell(rows_pf, vals_pf, num_rows: int, n_shards: int = 1, shard: int = 0):
    """Build the row-oriented (gather) ELL copy from PF column-oriented data.

    rows_pf/vals_pf: (n_pf, k) with zeros on padding.  Returns the copy of
    column shard ``shard`` of ``n_shards`` as (mv_cols, mv_vals) of shape
    (1, m, kr), with column indices LOCAL to the shard, or (None, None) if
    any (shard, row) would exceed ROW_ELL_MAX_K (a popular row split across
    shards is still fine).  kr is the widest (shard, row) of all shards, so
    the slice equals the reference's (n_shards, m, kr) array at ``shard``.
    """
    n_pf, k = rows_pf.shape
    n_loc = n_pf // n_shards
    nz = vals_pf != 0
    if not nz.any():
        return (
            np.zeros((1, num_rows, 1), np.int32),
            np.zeros((1, num_rows, 1), vals_pf.dtype),
        )
    pf_pos = np.broadcast_to(np.arange(n_pf)[:, None], (n_pf, k))[nz]
    r = rows_pf[nz].astype(np.int64)
    v = vals_pf[nz]
    sh = pf_pos // n_loc
    # reject on the per-(shard, row) width before group_ell allocates (G, W)
    width = int(np.bincount(sh * num_rows + r, minlength=n_shards * num_rows).max())
    if width > ROW_ELL_MAX_K:
        return None, None
    mine = sh == shard
    local = (pf_pos[mine] - shard * n_loc).astype(np.int32)
    mv_cols, mv_vals = _ell_groups(r[mine], local, v[mine], num_rows, width)
    return mv_cols.reshape(1, num_rows, width), mv_vals.reshape(1, num_rows, width)


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


def _nonzeros(rows_pf, vals_pf):
    """(pf position int64, row int64, value) of every nonzero, column-major."""
    n_pf, k = rows_pf.shape
    nz = vals_pf != 0
    pf_pos = np.broadcast_to(np.arange(n_pf)[:, None], (n_pf, k))[nz].astype(np.int64)
    return pf_pos, rows_pf[nz].astype(np.int64), vals_pf[nz]


def _width(keys, num_groups: int) -> int:
    return max(int(np.bincount(keys, minlength=num_groups).max()) if keys.size else 0, 1)


def _build_ell_row_sharded(rows_pf, vals_pf, num_rows: int, nr: int, shard: int):
    """Row shard ``shard`` of a PF column-ELL re-encoded into ``nr`` row
    shards (both orientations); ``num_rows`` must divide ``nr``.  Returns

      rows/vals:       (n_pf, ks) — the shard's column-ELL, LOCAL row ids
      mv_cols/mv_vals: (1, m_loc, kr) — its row-ELL, global PF columns

    with ks and kr the widths of the whole encode (the reference's
    ``(nr, ...)`` arrays sliced at ``shard``)."""
    n_pf = rows_pf.shape[0]
    assert num_rows % nr == 0
    m_loc = num_rows // nr
    pf_pos, r, v = _nonzeros(rows_pf, vals_pf)
    sh, local_r = r // m_loc, r % m_loc
    ks = _width(sh * n_pf + pf_pos, nr * n_pf)
    kr = _width(sh * m_loc + local_r, nr * m_loc)
    mine = sh == shard
    rows, vals = _ell_groups(pf_pos[mine], local_r[mine].astype(np.int32), v[mine], n_pf, ks)
    mv_cols, mv_vals = _ell_groups(local_r[mine], pf_pos[mine].astype(np.int32), v[mine],
                                   m_loc, kr)
    return rows, vals, mv_cols[None], mv_vals[None]


def _build_ell_2d(rows_pf, vals_pf, num_rows: int, nr: int, nc: int, shard: tuple):
    """Tile ``shard = (row shard, column shard)`` of a PF column-ELL
    re-encoded into an (nr x nc) shard grid — the 2-D sharded product: each
    rank owns one tile of A and computes its partial of both products
    locally; A x partials are summed over the column shards, A^T r partials
    over the row shards.  Returns

      rows/vals:       (n_loc, ks) — column orientation, LOCAL rows
      mv_cols/mv_vals: (1, m_loc, kr) — row orientation, LOCAL columns
    """
    n_pf = rows_pf.shape[0]
    assert n_pf % nc == 0 and num_rows % nr == 0
    n_loc, m_loc = n_pf // nc, num_rows // nr
    pf_pos, r, v = _nonzeros(rows_pf, vals_pf)
    tile = (r // m_loc) * nc + pf_pos // n_loc
    local_r, local_c = r % m_loc, pf_pos % n_loc
    ks = _width(tile * n_loc + local_c, nr * nc * n_loc)
    kr = _width(tile * m_loc + local_r, nr * nc * m_loc)
    mine = tile == shard[0] * nc + shard[1]
    rows, vals = _ell_groups(local_c[mine], local_r[mine].astype(np.int32), v[mine], n_loc, ks)
    mv_cols, mv_vals = _ell_groups(local_r[mine], local_c[mine].astype(np.int32), v[mine],
                                   m_loc, kr)
    return rows, vals, mv_cols[None], mv_vals[None]


def _np_float(dtype: torch.dtype) -> np.dtype:
    """Host staging buffers match the requested device precision: staging
    through float32 would silently quantize a float64 prepare()."""
    return np.dtype(np.float64 if dtype == torch.float64 else np.float32)


def to_device_matrix(
    M, perm: np.ndarray, dtype=torch.float32, col_scale=None,
    row_bucket: bool = False, device="cuda", _out: Optional[dict] = None,
    n_shards: int = 1, row_shards: int = 1, shard: tuple = (0, 0),
) -> "DeviceMatrix":
    """Move a host matrix to device with PF column permutation/padding.

    ``col_scale`` (N,) divides each user column (block equilibration).
    ``row_bucket=True`` (unsharded EllMatrix only) permutes rows by nnz count
    into power-of-two width groups — the caller must permute b with the
    ``row_perm`` stashed into ``_out``.

    Sharded (``n_shards`` column shards of the device-major ``perm``,
    ``row_shards`` row shards): only the tile ``shard = (row shard, column
    shard)`` is built and uploaded.  ELL A is re-encoded per tile when its
    rows are sharded; the rows must divide ``row_shards`` (the caller pads)."""
    host = _host_matrix(M, perm, _np_float(dtype), col_scale, row_bucket, _out, n_shards,
                        row_shards, shard)
    return _upload(host, dtype, resolve_device(device))


def _upload(M, dtype, dev: torch.device) -> "DeviceMatrix":
    """A matrix built on the host by ``_host_matrix`` (numpy arrays in its
    fields) on the device: integer arrays as int32, the others in ``dtype``."""
    def put(v):
        if isinstance(v, np.ndarray):
            kind = torch.int32 if v.dtype.kind in "iu" else dtype
            # (ascontiguousarray alone makes a 0-d array 1-d)
            return torch.as_tensor(np.ascontiguousarray(v).reshape(v.shape), dtype=kind,
                                   device=dev)
        if isinstance(v, tuple):
            return tuple(put(x) for x in v)
        if isinstance(v, (DeviceDense, DeviceEll, DeviceVStack)):
            return _upload(v, dtype, dev)
        return v

    return replace(M, **{f.name: put(getattr(M, f.name)) for f in fields(M) if f.init})


def _host_matrix(M, perm: np.ndarray, np_dtype, col_scale, row_bucket: bool, _out,
                 n_shards: int, row_shards: int, shard: tuple):
    """``to_device_matrix``'s layout on the host: the device matrix with
    numpy arrays in its fields (``_upload`` moves them)."""
    rsh, csh = shard
    if row_shards > 1 and M.shape[0] % row_shards:
        raise ValueError(f"num_rows={M.shape[0]} not divisible by row_shards={row_shards}; "
                         "pad the instance rows first")
    if isinstance(M, DenseMatrix):
        n_loc, m_loc = perm.size // n_shards, M.shape[0] // row_shards
        perm_loc = perm[csh * n_loc:(csh + 1) * n_loc]
        sel = perm_loc >= 0
        data = np.zeros((m_loc, n_loc), dtype=np_dtype)
        cols = np.asarray(M.data)[rsh * m_loc:(rsh + 1) * m_loc][:, perm_loc[sel]]
        data[:, sel] = cols if col_scale is None else cols / np.asarray(col_scale)[perm_loc[sel]]
        return DeviceDense(data=data)
    sel = perm >= 0
    cs = None if col_scale is None else np.asarray(col_scale)[perm[sel]]
    if isinstance(M, EllMatrix):
        rows = np.zeros((perm.size, M.k), dtype=np.int32)
        vals = np.zeros((perm.size, M.k), dtype=np_dtype)
        rows[sel] = np.asarray(M.rows)[perm[sel]]
        v = np.asarray(M.vals)[perm[sel]]
        vals[sel] = v if cs is None else v / cs[:, None]
        if row_shards > 1:
            if n_shards > 1:  # 2-D (row x col) shard grid
                r, v2, mc, mv = _build_ell_2d(rows, vals, M.num_rows, row_shards, n_shards,
                                              shard)
            else:
                r, v2, mc, mv = _build_ell_row_sharded(rows, vals, M.num_rows, row_shards, rsh)
            return DeviceEll(rows=r, vals=v2, mv_cols=mc, mv_vals=mv,
                             num_rows=M.num_rows // row_shards, nnz=int(np.count_nonzero(v2)))
        if row_bucket and n_shards == 1:
            row_perm, mvc, mvv = _build_row_ell_bucketed(rows, vals, M.num_rows)
            if row_perm is not None:
                rank = np.empty(M.num_rows, np.int64)
                rank[row_perm] = np.arange(M.num_rows)
                rows = rank[rows].astype(np.int32)  # col-ELL in permuted space
                if _out is not None:
                    _out["row_perm"] = row_perm
                rt_r, rt_v, rt_inv, n_zero = _build_col_ell_bucketed(rows, vals)
                return DeviceEll(rows=rows, vals=vals, mv_cols=mvc, mv_vals=mvv,
                                 num_rows=M.num_rows, rt_rows=rt_r, rt_vals=rt_v, rt_inv=rt_inv,
                                 rt_zeros=n_zero, nnz=int(np.count_nonzero(vals)))
        mv_cols, mv_vals = _build_row_ell(rows, vals, M.num_rows, n_shards, csh)
        n_loc = perm.size // n_shards
        mine = slice(csh * n_loc, (csh + 1) * n_loc)
        return DeviceEll(rows=rows[mine], vals=vals[mine], mv_cols=mv_cols, mv_vals=mv_vals,
                         num_rows=M.num_rows, nnz=int(np.count_nonzero(vals[mine])))
    if isinstance(M, VStackMatrix):
        # each part keeps its own row order (no row-nnz bucketing: the
        # stacked right-hand side is [b; b_bottom] as the caller builds it).
        # Sharded, each part takes the same tile: the rank's columns of the
        # one device-major perm (and col_scale), and under row sharding its
        # own row segment of each part, so that the rank holds the locally
        # stacked [top_k; s bottom_k] (the caller pads each part to the row
        # shards and interleaves b to match) and ``split`` is the top's
        # LOCAL height, where rmatvec divides r.
        scale, bottom = 1.0, M.bottom
        if isinstance(bottom, ScaledMatrix):
            scale, bottom = bottom.scale, bottom.inner
        part = dict(np_dtype=np_dtype, col_scale=col_scale, row_bucket=False, _out=None,
                    n_shards=n_shards, row_shards=row_shards, shard=shard)
        return DeviceVStack(
            top=_host_matrix(M.top, perm, **part),
            bottom=_host_matrix(bottom, perm, **part),
            bottom_scale=np.asarray(scale, np.float64),
            split=M.top.shape[0] // row_shards,
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


def _device_buckets(part: BlockPartition, c: np.ndarray, dtype, dev, n_shards: int = 1,
                    shard: int = 0) -> tuple:
    """The partition's buckets on the device (column shard ``shard`` of
    ``n_shards``: its rows of every bucket); ``c`` are the per-block scales."""
    out = []
    for b in part.buckets:
        lo, hi = shard * b.num_blocks // n_shards, (shard + 1) * b.num_blocks // n_shards
        ids = b.block_ids[lo:hi]
        out.append(DeviceBucket(
            mask=torch.as_tensor(b.mask[lo:hi], dtype=dtype, device=dev),
            sizes=torch.as_tensor(b.sizes[lo:hi], dtype=torch.int32, device=dev),
            radius=torch.as_tensor(np.where(ids >= 0, c[np.maximum(ids, 0)], 1.0),
                                   dtype=dtype, device=dev),
            width=b.width,
        ))
    return tuple(out)


def _scales(problem: Problem, equilibrate: bool):
    """(per-block scale c, per-user-column scale or None)."""
    part = problem.partition
    if equilibrate:
        c = block_scales(problem)
        return c, np.repeat(c, part.sizes)
    return np.ones(part.num_blocks), None


def _local_b(b: np.ndarray, scenarios, row_shards: int = 1, rsh: int = 0) -> np.ndarray:
    """This rank's right-hand sides: its scenarios and its row segment."""
    if scenarios is not None:
        b = b[scenarios]
    if row_shards > 1:
        m_loc = b.shape[-1] // row_shards
        b = b[..., rsh * m_loc:(rsh + 1) * m_loc]
    return np.ascontiguousarray(b)


def _prepare_banded(
    problem: Problem, dtype, equilibrate: bool, force: bool, dev: torch.device,
    fit_threshold: float = 0.6, band_budget_bytes: int = 2 << 30,
    n_shards: int = 1, shard: int = 0, col_group=None, scenarios=None,
    _out: Optional[dict] = None,
) -> Optional[DeviceProblem]:
    """Try the banded-split layout (ops/banded.py): re-orders blocks by row
    window, builds per-bucket band tensors and a sparse residual.  Returns the
    DeviceProblem — whose ``perm`` and buckets follow the VALUE-GROUPED
    partition, stashed in ``_out["partition"]`` — or None when the instance is
    not bandable enough (fit fraction below threshold) or the band tensors
    would exceed the memory budget; the caller then falls back to the gather
    layout.  ``b`` stays in the user's row order: the row-nnz bucketing does
    not apply here.

    ``n_shards > 1`` shards the band tensors along the group axis: the
    ladder page count pads to a multiple of n_shards, so shard d owns
    gl = pages/n_shards contiguous groups = a contiguous block range = a
    contiguous row window, starting at ladder page d * gl.  Its products
    return full-m partials, summed over ``col_group``; the residual rides the
    column-sharded dual-ELL."""
    part = problem.partition
    A0: EllMatrix = problem.A
    # per-block window page: min nonzero row page over the block's columns
    nzmask = np.asarray(A0.vals) != 0
    rows_h = np.asarray(A0.rows)
    col_min = np.where(nzmask, rows_h, np.iinfo(np.int32).max).min(axis=1)
    col_max = np.where(nzmask, rows_h, -1).max(axis=1)
    offsets = np.concatenate([[0], np.cumsum(part.sizes)])[:-1]
    Mp_real = -(-A0.num_rows // PAGE)
    Mp = n_shards * (-(-Mp_real // n_shards))  # pad the ladder to the shard count
    block_page = np.clip(np.minimum.reduceat(col_min, offsets) // PAGE, 0, Mp_real - 1)

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

    # bucket-major perm for the band build (groups ascending per bucket)
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
    if n_shards > 1:
        # device-major reindex of the residual/perm: device d's chunk is
        # [bucket0 rows d*L0/n..(d+1)*L0/n, bucket1 rows ..., ...]
        seg_off = np.concatenate([[0], np.cumsum(seg_lens)])
        bm_of_dm = np.concatenate([
            np.arange(seg_off[i] + d * (L // n_shards), seg_off[i] + (d + 1) * (L // n_shards))
            for d in range(n_shards) for i, L in enumerate(seg_lens)])
        perm, res_rows, res_vals = perm[bm_of_dm], res_rows[bm_of_dm], res_vals[bm_of_dm]
    n_loc, gl = perm.size // n_shards, Mp // n_shards
    mine = slice(shard * n_loc, (shard + 1) * n_loc)

    def fl(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    def ix(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32, device=dev)

    resid = None
    if (res_vals != 0).any():
        mv_cols, mv_vals = _build_row_ell(res_rows, res_vals, A0.num_rows, n_shards, shard)
        if n_shards == 1:
            rt_r, rt_v, rt_inv, n_zero = _build_col_ell_bucketed(res_rows, res_vals)
        else:
            # col-nnz bucketing reorders PF columns globally: the sharded
            # residual's A^T r takes the plain local (n_loc, k) gather
            rt_r = rt_v = rt_inv = None
            n_zero = 0
        resid = _upload(DeviceEll(
            rows=res_rows[mine], vals=res_vals[mine], mv_cols=mv_cols, mv_vals=mv_vals,
            num_rows=A0.num_rows, rt_rows=rt_r, rt_vals=rt_v, rt_inv=rt_inv, rt_zeros=n_zero,
            nnz=int(np.count_nonzero(res_vals[mine]))), dtype, dev)
    A = DeviceBanded(
        bands=tuple(fl(bd[shard * gl:(shard + 1) * gl]) for bd in bands),
        resid=resid,
        num_rows=A0.num_rows,
        wpages=wpages,
        back=back,
        n_pf=n_loc,
        seg_lens=tuple(L // n_shards for L in seg_lens),
        pages=Mp,
        page_off=shard * gl,
    )
    if _out is not None:
        _out["partition"] = part2
    return DeviceProblem(
        A=A,
        b=fl(_local_b(np.asarray(problem.b), scenarios)),
        buckets=_device_buckets(part2, c, dtype, dev, n_shards, shard),
        perm=ix(perm[mine]),
        n_user=part.n_flat,
        num_rows=A0.num_rows,
        col_group=col_group,
    )


def prepare(
    problem: Problem,
    dtype=torch.float32,
    equilibrate: bool = True,
    layout: str = "auto",  # auto | banded | gather
    device="cuda",
    n_shards: int = 1,
    row_shards: int = 1,
    shard: tuple = (0, 0),
    col_group=None,
    row_group=None,
    scenarios: Optional[slice] = None,
    _out: Optional[dict] = None,
    phases: Optional[dict] = None,
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

    Sharded (``parallel/sharding.py`` calls this): ``n_shards`` column shards
    (every bucket's rows must divide it: rebuild the partition with
    ``block_multiple``), ``row_shards`` row shards (A's rows must divide it),
    and the tile ``shard = (row shard, column shard)`` this rank holds;
    ``scenarios`` slices b's scenario axis; ``col_group``/``row_group`` go
    into the DeviceProblem for its collectives.  The routing is the
    reference's: no row-nnz bucketing under any sharding, and the banded
    attempt only without row sharding.  When the band is taken, the
    value-grouped partition it solves under is stashed in
    ``_out["partition"]``.

    A ``Problem`` with equality constraints (``C``) is not prepared here:
    ``solve()`` runs it through the augmented-Lagrangian loop, which prepares
    the stacked problem ``[A; sqrt(rho) C]`` (whose ``C`` is ``None``).

    The build is the span ``bsls.prepare`` (``utils/profiling.py::span``)
    around ``prepare.band`` (the banded attempt, its upload too where it is
    taken), ``prepare.layout`` (the gather layout's permutation, scales and
    ELL encodes on the host) and ``prepare.upload``; ``phases``, where given,
    gets their host seconds."""
    if layout not in ("auto", "banded", "gather"):
        raise ValueError(f"unknown layout {layout!r}")
    check_dtype(dtype, device)
    if problem.C is not None:
        raise ValueError(
            "prepare() takes no equality-constrained Problem (Problem.C is set): "
            "pass it to solve(), which runs the augmented-Lagrangian loop "
            "(solvers.eq_constrained) on the stacked operator [A; sqrt(rho) C]")
    dev = resolve_device(device)
    with span("prepare", phases):
        col_sharded = n_shards > 1 or col_group is not None
        row_sharded = row_shards > 1 or row_group is not None
        rsh, csh = shard
        b_host = np.asarray(problem.b)
        num_scenarios = int(b_host.shape[0]) if b_host.ndim == 2 else 1
        if layout == "banded" or (layout == "auto" and num_scenarios < 16):
            if isinstance(problem.A, EllMatrix) and not row_sharded:
                with span("prepare.band", phases):
                    dp = _prepare_banded(problem, dtype, equilibrate, force=(layout == "banded"),
                                         dev=dev, n_shards=n_shards, shard=csh,
                                         col_group=col_group, scenarios=scenarios, _out=_out)
                if dp is not None:
                    return dp
            elif layout == "banded":
                raise ValueError("layout='banded' requires an EllMatrix instance and column "
                                 "(block) or no sharding: row sharding has no banded form")
        part = problem.partition
        out_info: dict = {}
        with span("prepare.layout", phases):
            perm = build_pf_perm(part, n_shards)
            c, col_scale = _scales(problem, equilibrate)
            A = _host_matrix(
                problem.A, perm, _np_float(dtype), col_scale,
                isinstance(problem.A, EllMatrix) and not (col_sharded or row_sharded), out_info,
                n_shards, row_shards, shard)
            b = _local_b(b_host, scenarios, row_shards, rsh)
            if "row_perm" in out_info:
                # r lives in the nnz-sorted row order from here on
                b = b[..., out_info["row_perm"]]
        n_loc = perm.size // n_shards
        with span("prepare.upload", phases):
            return DeviceProblem(
                A=_upload(A, dtype, dev),
                b=torch.as_tensor(np.ascontiguousarray(b), dtype=dtype, device=dev),
                buckets=_device_buckets(part, c, dtype, dev, n_shards, csh),
                perm=torch.as_tensor(perm[csh * n_loc:(csh + 1) * n_loc], dtype=torch.int32,
                                     device=dev),
                n_user=part.n_flat,
                num_rows=problem.A.shape[0],
                row_perm=(
                    torch.as_tensor(out_info["row_perm"], dtype=torch.int32, device=dev)
                    if "row_perm" in out_info
                    else None
                ),
                col_group=col_group,
                row_group=row_group,
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


def _ell_product_plain(cols, vals, vec: torch.Tensor, zeros: int = 0, rank=None,
                       vt=None) -> torch.Tensor:
    """The plain version of ``_ell_product``, on any device: a gather
    product a group over the (n, S) transpose (``vt`` where given), a cat,
    the rank gather."""
    def run(vt):
        parts = [_gather_dot_t(v, c, vt) for c, v in zip(cols, vals)]
        if zeros:
            parts = [vt.new_zeros((zeros, vt.shape[1]))] + parts
        out = parts[0] if len(parts) == 1 else torch.cat(parts)
        return out if rank is None else out.index_select(0, rank)

    if vt is not None and vec.ndim == 2:
        return run(vt).t().contiguous()
    return _batched(run, vec)


def _ell_product(cols, vals, vec: torch.Tensor, zeros: int = 0, rank=None,
                 vt=None) -> torch.Tensor:
    """One ELL product of ``vec`` ((n,) or (S, n)): the groups ``(cols[i],
    vals[i])`` give the rows in sorted order after ``zeros`` zero rows, and
    ``rank`` (if given) maps each output row to its sorted row.  Returns
    (rows,) or (S, rows).  A CUDA tensor takes one launch of
    ``ellkernels.ell_gather_dot`` over the (n, S) transpose (every group at
    once, the result in (S, rows)): ``vt`` where the caller gives that
    transpose, made here otherwise; a CPU tensor the plain version."""
    if not vec.is_cuda:
        return _ell_product_plain(cols, vals, vec, zeros, rank, vt)
    if vt is None:
        vt = (vec[:, None] if vec.ndim == 1 else vec.t()).contiguous()
    out = ellkernels.ell_gather_dot(cols, vals, vt, zeros, rank)
    return out[0] if vec.ndim == 1 else out


def gather_dot(vals: torch.Tensor, idx: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """sum(vals * vec[..., idx], axis=-1) for (rows, k) vals/idx and ``vec``
    of shape (n,) or (S, n); returns (rows,) or (S, rows).

    The batched form gathers from the transposed (n, S) vector and walks the
    rows in segments that bound the (rows, k, S) temporary (on the CPU; on
    the card it is one kernel launch)."""
    return _ell_product((idx,), (vals,), vec)


def takes_operand(A: DeviceMatrix) -> bool:
    """Whether ``matvec(A, x, xt)`` reads an (n_pf, S) copy ``xt`` of x: a
    gather-layout row copy does (on the card), alone, as a stack's part or as
    a band's gather residual."""
    if isinstance(A, DeviceVStack):
        return takes_operand(A.top) or takes_operand(A.bottom)
    if isinstance(A, DeviceBanded):
        return A.resid is not None and takes_operand(A.resid)
    return isinstance(A, DeviceEll) and A.mv_cols is not None


def matvec(A: DeviceMatrix, x: torch.Tensor, xt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A @ x for PF flat x of shape (n_pf,) or (S, n_pf).  ``xt``, where
    given, is x's contiguous (n_pf, S) copy, which the ELL products on the
    card read in place of a transpose of their own (``takes_operand``)."""
    if isinstance(A, DeviceBanded):
        y = banded_matvec(A, x)
        return y if A.resid is None else y + matvec(A.resid, x, xt)
    if isinstance(A, DeviceDense):
        # full fp32: TF32 is off package-wide (see bsls_tpu_torch/__init__.py)
        return x @ A.data.t()
    if isinstance(A, DeviceVStack):
        return torch.cat([matvec(A.top, x, xt), A.bottom_scale * matvec(A.bottom, x, xt)],
                         dim=-1)
    if isinstance(A.mv_cols, tuple):
        # row-nnz-bucketed: per-width partials concatenate contiguously in
        # the (nnz-sorted) permuted row order — no scatter, minimal rows
        return _ell_product(A.mv_cols, A.mv_vals, x, vt=xt)
    if A.mv_cols is not None:
        return _ell_product((A.mv_cols[0],), (A.mv_vals[0],), x, vt=xt)
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
        # ``split`` is the top's height in this rank's view: all its rows,
        # or under row sharding its local segment (the reference's
        # _vstack_top_rows), never the global boundary
        return (rmatvec(A.top, r[..., :A.split])
                + A.bottom_scale * rmatvec(A.bottom, r[..., A.split:]))
    if A.rt_rows is not None:
        # col-nnz-bucketed: gather only real nonzeros (grouped widths),
        # zero-nnz columns emitted directly, the rank map to PF order
        return _ell_product(A.rt_rows, A.rt_vals, r, A.rt_zeros, A.rt_inv)
    return _ell_product((A.rows,), (A.vals,), r)


def _psum(v: torch.Tensor, group) -> torch.Tensor:
    """Sum ``v`` over the ranks of ``group`` (in place; a new contiguous
    tensor if ``v`` was a view), or ``v`` itself without a group."""
    if group is None:
        return v
    v = v.contiguous()
    dist.all_reduce(v, group=group)
    return v


def psum_if_sharded(dp: DeviceProblem, v: torch.Tensor) -> torch.Tensor:
    """Sum a per-rank partial over the column shards (no-op unsharded)."""
    return _psum(v, dp.col_group)


def matvec_ps(dp: DeviceProblem, x: torch.Tensor,
              xt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A @ x assembled across the column (block) shards: local partial +
    all-reduce over ``col_group``.  Under row sharding the result is this
    rank's row segment of r (no collective).  The residual collective of the
    sharded step.  ``xt``: as ``matvec``'s."""
    return _psum(matvec(dp.A, x, xt), dp.col_group)


def rmatvec_ps(dp: DeviceProblem, r: torch.Tensor) -> torch.Tensor:
    """A^T @ r assembled across the row shards: local partial + all-reduce
    over ``row_group``.  Under column-only sharding it is block-local (r is
    replicated)."""
    return _psum(rmatvec(dp.A, r), dp.row_group)


def xdot(dp: DeviceProblem, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product of x-space (PF flat) vectors over the last axis: a
    scalar for (n,) inputs, (S,) for (S, n); summed over the column shards."""
    return _psum((a * b).sum(dim=-1), dp.col_group)


def rdot(dp: DeviceProblem, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inner product of r-space vectors over the last axis; summed over the
    row shards."""
    return _psum((a * b).sum(dim=-1), dp.row_group)


def xmatdot(dp: DeviceProblem, M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched x-space dots: (K, n) @ (n,) -> (K,), or per scenario
    (S, K, n) @ (S, n) -> (S, K), summed over the column shards like xdot.
    One batched product instead of K serial dots (the L-BFGS compact form's
    history products), at full fp32: TF32 is off package-wide, and
    reduced-precision passes break 1e-6 convergence."""
    return _psum(torch.matmul(M, v.unsqueeze(-1)).squeeze(-1), dp.col_group)
