"""Sharded solve over a ``torch.distributed`` mesh: every rank runs the
solver's own steps on its slice of the problem.

Layout (``parallel/mesh.py`` axes; each rank holds and uploads one slice):

  column (block) sharding, ``shard_problem``:
    * bucket arrays (Bk, w)    rows split over 'block'   x, masks, radii
    * dense A (m, n_pf)        columns over 'block'
    * ELL rows/vals (n_pf, k)  columns over 'block', row copy with local ids
    * the banded layout        band groups over 'block' (``ops/banded.py``)
    * b (S, m)                 scenarios over 'scenario'
    * residual r               replicated over 'block' (assembled by an
                               all-reduce of the partial products)
  row sharding, ``shard_problem_rows``: A's rows and r split over 'block', x
    replicated; A^T r and r-space inner products all-reduce.
  2-D, ``shard_problem_2d``: tile (row shard, column shard) of A per rank; A x
    partials all-reduce over 'block', A^T r partials over 'row'.

Each rank computes its partial A_k x_k; the residual assembles with one
all-reduce over 'block' per product, and A^T r is then block-local.  Line
search and gap inner products all-reduce likewise: the process groups in the
DeviceProblem make ``matvec_ps``/``xdot``/... collective, so the SAME solver
step functions run sharded and unsharded, and ``solve_sharded`` runs the same
solve body as ``solve`` (``solvers/base.py::solve_on``) on a
``MeshPlacement``.  Its one readback per chunk is an all-gather of (f, gap)
over 'scenario', so every rank's stop rule sees every scenario and every
rank stops at the same chunk.

The stacked operator [A; s C] of the equality-constrained path shards like
any other A: by column, each part takes the rank's columns; by row
(``shard_rows``), each part is padded to the block axis on its own and a rank
holds the locally stacked [A_k; s C_k], its b segment ``[b_top_k; b_bot_k]``
(``interleave_stacked_rows``).  ``solve_sharded`` of a ``Problem`` with ``C``
runs the augmented-Lagrangian loop of ``solvers/eq_constrained.py`` on the
mesh.

Counterpart of ``bsls_tpu/parallel/sharding.py``, where one controller
``shard_map``s the steps over a ``jax.sharding.Mesh``.  What it does not
take: its second chunk loop with an adaptive sync cadence (a workaround for
that platform's readback latency).
"""
from __future__ import annotations

import dataclasses
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

from ..models.partition import BlockPartition
from ..models.problem import DenseMatrix, EllMatrix, Problem, ScaledMatrix, VStackMatrix
from ..ops import layout as L
from ..solvers.base import route
from .mesh import BLOCK_AXIS, ROW_AXIS, SCENARIO_AXIS

__all__ = ["shard_problem", "shard_problem_rows", "shard_problem_2d", "interleave_stacked_rows",
           "with_rank_rhs", "inject_sharded", "to_host", "extract_sharded", "leaf_layout",
           "MeshPlacement", "placement", "solve_sharded"]


# ---------------- problem sharding ----------------


def _rhs_2d(problem: Problem, mesh) -> np.ndarray:
    b = np.asarray(problem.b)
    if b.ndim == 1:
        b = b[None, :]
    ns = mesh.shape[SCENARIO_AXIS]
    if b.shape[0] % ns:
        raise ValueError(f"num scenarios {b.shape[0]} not divisible by scenario axis {ns}")
    return b


def _my_scenarios(b: np.ndarray, mesh) -> slice:
    per = b.shape[0] // mesh.shape[SCENARIO_AXIS]
    s = mesh.coords[SCENARIO_AXIS]
    return slice(s * per, (s + 1) * per)


def _block_partition(problem: Problem, nb: int) -> Problem:
    """Rebuild the partition so every bucket's rows divide ``nb`` (dummy
    blocks pad it); a user-flat x is unchanged by this."""
    part = problem.partition
    if any(bk.num_blocks % nb for bk in part.buckets):
        part = BlockPartition.from_sizes(part.sizes, block_multiple=nb)
        problem = replace(problem, partition=part)
    return problem


def interleave_stacked_rows(b_top: np.ndarray, b_bot: np.ndarray, nr: int) -> np.ndarray:
    """Arrange a stacked RHS [b_top; b_bot] ((S, m) and (S, p)) into the
    row-sharded stacked layout, where shard k owns the locally stacked rows
    [top_k; bottom_k]: pad each part to a multiple of ``nr``, split it into
    ``nr`` row segments, and concatenate segment-wise."""
    S = b_top.shape[0]
    bt = np.concatenate([b_top, np.zeros((S, (-b_top.shape[1]) % nr), b_top.dtype)], axis=1)
    bb = np.concatenate([b_bot, np.zeros((S, (-b_bot.shape[1]) % nr), b_bot.dtype)], axis=1)
    return np.concatenate([bt.reshape(S, nr, -1), bb.reshape(S, nr, -1)], axis=2).reshape(S, -1)


def _pad_matrix_rows(M, pad: int, what: str):
    """``M`` with ``pad`` zero rows below (zero rows add nothing to a
    least-squares residual)."""
    if isinstance(M, DenseMatrix):
        if not pad:
            return M
        return DenseMatrix(np.concatenate(
            [M.data, np.zeros((pad, M.data.shape[1]), M.data.dtype)], axis=0))
    if isinstance(M, EllMatrix):
        return EllMatrix(rows=M.rows, vals=M.vals, num_rows=M.num_rows + pad) if pad else M
    raise NotImplementedError(
        f"{what} supports dense and ELL A, got {type(M)}. For bandable (corridor) "
        "instances use block sharding with layout='banded': band groups own "
        "advancing row windows, so a group shard already touches only its own "
        "row pages")


def _pad_rows(problem: Problem, nr: int, b: np.ndarray, what: str) -> Problem:
    """Zero-pad A's rows and b so that ``nr`` divides them.  A stacked
    ``VStackMatrix`` pads each part on its own (p < nr included) and its b
    is interleaved so that each row shard's segment is its locally stacked
    ``[b_top_k; b_bot_k]``."""
    A = problem.A
    if isinstance(A, VStackMatrix):
        bottom, scale = A.bottom, None
        if isinstance(bottom, ScaledMatrix):
            bottom, scale = bottom.inner, bottom.scale
        mt, p = A.top.shape[0], bottom.shape[0]
        bottom = _pad_matrix_rows(bottom, (-p) % nr, what)
        A = VStackMatrix(top=_pad_matrix_rows(A.top, (-mt) % nr, what),
                         bottom=bottom if scale is None else ScaledMatrix(bottom, scale))
        return replace(problem, A=A, b=interleave_stacked_rows(b[:, :mt], b[:, mt:], nr))
    pad = (-A.shape[0]) % nr
    A = _pad_matrix_rows(A, pad, what)
    if pad:
        b = np.concatenate([b, np.zeros((b.shape[0], pad), b.dtype)], axis=1)
    return replace(problem, A=A, b=b)


def shard_problem(problem: Problem, mesh, dtype=torch.float32, equilibrate: bool = True,
                  layout: str = "auto"):
    """Prepare this rank's slice of a Problem, columns split over 'block'.

    Rebuilds the partition so every bucket's rows divide the block axis and
    lays A's columns out device-major.  Returns (dp, part) where
    ``dp.col_group`` is the block group.  When the banded layout is
    selected (``layout`` as in ``prepare``), ``part`` is the value-grouped
    partition the band ladder solves under: extraction maps through it.  A
    stacked ``VStackMatrix`` takes the gather layout under ``"auto"``, as
    ``prepare`` gives it."""
    nb = mesh.shape[BLOCK_AXIS]
    problem = _block_partition(problem, nb)
    b = _rhs_2d(problem, mesh)
    problem = replace(problem, b=b)
    out: dict = {}
    dp = L.prepare(problem, dtype=dtype, equilibrate=equilibrate, layout=layout,
                   device=mesh.device, n_shards=nb, shard=(0, mesh.coords[BLOCK_AXIS]),
                   col_group=mesh.groups[BLOCK_AXIS], scenarios=_my_scenarios(b, mesh),
                   _out=out)
    return dp, out.get("partition", problem.partition)


def shard_problem_rows(problem: Problem, mesh, dtype=torch.float32):
    """Row-sharded preparation (tall A): A's ROWS and r are split over the
    block axis, x is replicated.  Dense A is sliced by rows; ELL A is
    re-encoded per shard in both orientations with local row ids, so each
    rank gathers only from its own r segment and the A^T r partials
    all-reduce.  Rows are zero-padded so the axis divides m.  A stacked
    ``VStackMatrix`` (the equality-constrained operator) shards the rows of
    BOTH parts: rank k holds the locally stacked [A_k; s C_k], each part
    padded on its own, and b is interleaved to match
    (``interleave_stacked_rows``)."""
    nr = mesh.shape[BLOCK_AXIS]
    b = _rhs_2d(problem, mesh)
    problem = _pad_rows(problem, nr, b, "row sharding")
    b = np.asarray(problem.b)
    dp = L.prepare(problem, dtype=dtype, layout="gather", device=mesh.device,
                   row_shards=nr, shard=(mesh.coords[BLOCK_AXIS], 0),
                   row_group=mesh.groups[BLOCK_AXIS], scenarios=_my_scenarios(b, mesh))
    return dp, problem.partition


def shard_problem_2d(problem: Problem, mesh, dtype=torch.float32):
    """2-D (row x column) sharded preparation: every rank owns one tile of A
    (ELL re-encoded per tile with local row AND local column ids; dense A
    sliced).  Rows pad to the row axis; the partition pads to the block
    axis."""
    nr, nc = mesh.shape[ROW_AXIS], mesh.shape[BLOCK_AXIS]
    problem = _block_partition(problem, nc)
    b = _rhs_2d(problem, mesh)
    problem = _pad_rows(problem, nr, b, "2-D sharding")
    b = np.asarray(problem.b)
    dp = L.prepare(problem, dtype=dtype, layout="gather", device=mesh.device,
                   n_shards=nc, row_shards=nr,
                   shard=(mesh.coords[ROW_AXIS], mesh.coords[BLOCK_AXIS]),
                   col_group=mesh.groups[BLOCK_AXIS], row_group=mesh.groups[ROW_AXIS],
                   scenarios=_my_scenarios(b, mesh))
    return dp, problem.partition


def with_rank_rhs(dp, b: np.ndarray, mesh):
    """``dp`` with this rank's slice of the right-hand sides ``b`` uploaded:
    ``b`` is (S, m) in the row layout of the prepare (rows padded to the row
    shards, or interleaved for a row-sharded stacked operator); the rank takes
    its scenarios and, under row sharding, its row segment.  Uploaded as
    given and cast on the device."""
    row_shards, rsh = 1, 0
    if dp.row_group is not None:
        ax = ROW_AXIS if dp.col_group is not None else BLOCK_AXIS
        row_shards, rsh = mesh.shape[ax], mesh.coords[ax]
    local = L._local_b(np.asarray(b), _my_scenarios(b, mesh), row_shards, rsh)
    return replace(dp, b=torch.from_numpy(local).to(dp.device).to(dp.b.dtype))


# ---------------- host side of the sharded solve ----------------


def to_host(x: torch.Tensor, group=None, dim: int = 0) -> np.ndarray:
    """A tensor split over ``group`` along ``dim`` -> the whole array, as
    numpy, on every rank of the group.  Gathers CPU copies over the group's
    CPU backend (gloo), so a gloo world on CUDA tensors works too; the
    slices must have equal shapes (the layouts split evenly)."""
    a = x.detach().cpu().contiguous()
    if group is None:
        return a.numpy()
    parts = [torch.empty_like(a) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, a, group=group)
    return torch.cat(parts, dim=dim).numpy()


def _block_rows(b, bk, dp, mesh) -> slice:
    """This rank's rows of bucket ``b``: split over 'block' unless A's rows
    are what is split there (row sharding, x replicated)."""
    n_loc = bk.mask.shape[0]
    c = mesh.coords[BLOCK_AXIS] if dp.col_group is not None else 0
    assert n_loc * (mesh.shape[BLOCK_AXIS] if dp.col_group is not None else 1) == b.num_blocks
    return slice(c * n_loc, (c + 1) * n_loc)


def inject_sharded(dp, part, x_user: np.ndarray, mesh):
    """Inverse of ``extract_sharded``: (S, N) or (N,) user-flat x -> this
    rank's padded bucket slices (equilibration-scaled), on its device."""
    x_user = np.asarray(x_user, np.float64)
    if x_user.ndim == 1:
        x_user = x_user[None, :]
    x_user = x_user[_my_scenarios(x_user, mesh)]
    out = []
    for b, bk in zip(part.buckets, dp.buckets):
        rows = _block_rows(b, bk, dp, mesh)
        radius = bk.radius.detach().cpu().numpy().astype(np.float64)
        m = b.mask[rows].astype(bool)
        vals = x_user[:, b.pad_to_flat[rows]] * radius[None, :, None]
        arr = np.zeros((x_user.shape[0],) + m.shape)
        arr[:, m] = vals[:, m]
        out.append(torch.as_tensor(arr, dtype=dp.b.dtype, device=dp.device))
    return tuple(out)


def extract_sharded(dp, part, xp, mesh) -> np.ndarray:
    """Host-side extraction for the sharded path: the (S, N) user-flat
    solution, on every rank.

    Uses the partition's own bucket->flat maps (bucket row order is
    unchanged by sharding), NOT ``dp.perm``: the PF perm is device-major
    while a bucket-wise concatenation is bucket-major, so a perm-based
    extraction would scramble multi-bucket (ragged) problems."""
    sgroup = mesh.groups[SCENARIO_AXIS]
    out = None
    for b, bk, x in zip(part.buckets, dp.buckets, xp):
        local = x / torch.clamp(bk.radius, min=1e-30)[:, None]
        if dp.col_group is not None:
            local = torch.as_tensor(to_host(local, dp.col_group, dim=1))
        vals = to_host(local, sgroup, dim=0)  # (S, Bk, w)
        if out is None:
            out = np.zeros((vals.shape[0], part.n_flat), vals.dtype)
        m = b.mask.astype(bool)
        out[:, b.pad_to_flat[m]] = vals[:, m]
    return out


def leaf_layout(state, dp, mesh) -> list:
    """[global offset, global shape] of every leaf of a rank's solver state,
    in the checkpoint's leaf order, from the state class's ``SHARD_KINDS``
    (x: padded buckets, xflat: PF flat, xflat_hist: (S, M, n_pf) history,
    r: residual, hist/gram/scalar: per scenario, bucket: (Bk, w) with no
    scenario axis)."""
    kinds = type(state).SHARD_KINDS
    col = dp.col_group is not None
    cols = (mesh.shape[BLOCK_AXIS], mesh.coords[BLOCK_AXIS]) if col else (1, 0)
    if dp.row_group is None:
        rows = (1, 0)
    else:
        ax = ROW_AXIS if col else BLOCK_AXIS
        rows = (mesh.shape[ax], mesh.coords[ax])
    scen = (mesh.shape[SCENARIO_AXIS], mesh.coords[SCENARIO_AXIS])
    split_dims = {"x": {0: scen, 1: cols}, "xflat": {0: scen, 1: cols},
                  "xflat_hist": {0: scen, 2: cols}, "r": {0: scen, 1: rows},
                  "bucket": {0: cols}}
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        for leaf in v if isinstance(v, tuple) else (v,):
            shape = list(leaf.shape) if isinstance(leaf, torch.Tensor) else []
            off, full = [0] * len(shape), list(shape)
            if shape:
                for d, (n, c) in split_dims.get(kinds[f.name], {0: scen}).items():
                    off[d], full[d] = c * shape[d], n * shape[d]
            out.append([off, full])
    return out


# ---------------- the sharded solve ----------------


@dataclasses.dataclass
class MeshPlacement:
    """Where a solve runs, a mesh: this rank's slice of the problem (``dp``,
    ``part``) and the answers ``solvers/base.py::solve_on`` asks of its
    placement, as ``OneCard`` gives them for one device.  x0 goes in through
    ``inject_sharded``; per-scenario tensors come back gathered over
    'scenario' on every rank, and x through ``extract_sharded``; a
    single-RHS result keeps its traces' scenario axis, as in the reference;
    checkpoints are per rank; rank 0 alone writes the records; refine
    polishes the gathered result with the host float64 PCG."""

    dp: L.DeviceProblem
    part: BlockPartition
    mesh: object
    single_rhs: bool
    refine_dp = None
    squeeze = False
    keep_x = False

    @property
    def multi(self) -> bool:
        return not self.single_rhs

    @property
    def leader(self) -> bool:
        return self.mesh.rank == 0

    def check(self, callback, space: str, certify: int) -> None:
        """The options of ``solve`` that a mesh does not run."""
        if callback is not None:
            raise ValueError("callback is not supported for mesh-sharded solves")
        if space != "x":
            raise ValueError("mesh-sharded solves support space='x' only")
        if certify > 0:
            raise ValueError("certify is not supported for mesh-sharded solves")

    def inject(self, x0) -> tuple:
        return inject_sharded(self.dp, self.part, x0, self.mesh)

    def host(self, t: torch.Tensor, dim: int = 0) -> np.ndarray:
        return to_host(t, self.mesh.groups[SCENARIO_AXIS], dim=dim)

    def extract(self, xp) -> np.ndarray:
        return extract_sharded(self.dp, self.part, xp, self.mesh)

    def shard(self, state) -> dict:
        return {"rank": dist.get_rank(), "world": dist.get_world_size(),
                "mesh": dict(self.mesh.shape), "leaves": leaf_layout(state, self.dp, self.mesh)}


def placement(problem, mesh, dtype=torch.float32, layout: str = "auto",
              shard_rows: bool = False) -> MeshPlacement:
    """This rank's slice of ``problem`` on ``mesh``: by column, by row
    (``shard_rows``) or by tile (a mesh with ``row > 1``); or a pre-sharded
    ``(dp, part, single_rhs)`` triple as it is."""
    grid = mesh.shape[ROW_AXIS] > 1
    if grid and shard_rows:
        raise ValueError("use either a row>1 mesh axis (2-D) or shard_rows, not both")
    if isinstance(problem, tuple):
        if grid:
            raise ValueError("pre-sharded solves do not support a 2-D grid")
        dp, part, single_rhs = problem
        return MeshPlacement(dp, part, mesh, single_rhs)
    if grid:
        dp, part = shard_problem_2d(problem, mesh, dtype=dtype)
    elif shard_rows:
        dp, part = shard_problem_rows(problem, mesh, dtype=dtype)
    else:
        dp, part = shard_problem(problem, mesh, dtype=dtype, layout=layout)
    return MeshPlacement(dp, part, mesh, np.asarray(problem.b).ndim == 1)


def solve_sharded(
    problem,
    mesh,
    method: str = "pgd",
    tol: float = 1e-6,
    max_iter: int = 10_000,
    chunk: int = 100,
    line_search: str = "exact",
    step_size: float = 0.0,
    dtype=torch.float32,
    verbose: bool = False,
    metrics=None,
    checkpoint_path=None,
    checkpoint_every: int = 0,
    checkpoint_keep: int = 0,
    resume: bool = False,
    shard_rows: bool = False,
    x0=None,
    stop_rule: str = "auto",
    lbfgs_mem: int = 8,
    lipschitz=None,
    layout: str = "auto",
    refine: int = 0,
    refine_tol=None,
):
    """Mesh-sharded solve: the same semantics as ``solve``; b is treated as
    (S, m) (S = 1 for a single right-hand side: x, objective and gap are
    squeezed again at the end, the traces keep their (1, iters) shape).
    Every rank of the mesh calls it with the same arguments and returns the
    same full result, with the same ``phases`` and ``counts`` as a solve on
    one device.

    ``problem`` may be a pre-sharded ``(dp, part, single_rhs)`` triple from
    ``shard_problem`` (prepare once, then solve); ``lipschitz`` skips the
    collective power iteration.  ``shard_rows=True`` shards A's ROWS over
    the block axis instead of its columns; a mesh with ``row > 1`` shards
    both (2-D).  ``metrics`` and ``verbose`` act on rank 0 only; checkpoints
    are per rank (``utils/checkpoint.py``).  ``refine``/``refine_tol``
    polish the gathered result with the host float64 PCG on every rank.

    A ``Problem`` with equality constraints (``C``) runs the
    augmented-Lagrangian loop on the mesh (``solve_equality_constrained``
    with ``mesh``): ``max_iter`` is then its total inner budget, and the
    options of ``solvers/base.py::EQ_REJECTS`` are rejected there."""
    return route(**locals())  # every option above, by name
