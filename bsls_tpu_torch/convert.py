"""State carried across from the JAX package, as plain numpy.

``bsls_tpu`` (the reference) and this package share no module and no type.
What crosses between them is a dictionary of numpy arrays under the field
names of the reference's ``DeviceProblem`` / ``PGDState``; the caller
flattens the reference's objects with ``np.asarray`` and this module never
sees a JAX type.  With it a test can run this package's ``step`` on exactly
the layout that the reference's ``prepare`` built.

``device_problem_from_numpy`` keys (tuples are numbered from 0):

    A.data                              dense A, (m, n_pf)           or
    A.rows, A.vals                      column-ELL, (n_pf, k)
    A.mv_cols[i], A.mv_vals[i]          row-nnz-bucketed row-ELL groups, or
    A.mv_cols, A.mv_vals                the single (1, m, kr) row-ELL
    A.rt_rows[i], A.rt_vals[i], A.rt_inv, A.rt_zeros   col-nnz-bucketed copy
    A.bands[i], A.back, A.wpages, A.seg_lens, A.pages   banded layout, with
    A.resid.rows, A.resid.vals, A.resid.mv_cols, ...    its residual ELL (the
                                                        ELL keys above under
                                                        the stem A.resid)
    A.top.*, A.bottom.*, A.bottom_scale, A.split        the stacked operator
                                                        [top; scale * bottom]
                                                        of the equality-
                                                        constrained path (each
                                                        part under the keys
                                                        above, stem A.top or
                                                        A.bottom)
    b, perm, row_perm, n_user, num_rows
    buckets[i].mask / .sizes / .radius / .width

A rank's tile of a sharded problem takes the same keys, each array sliced
at the rank in this package's local shapes (what ``parallel/sharding.py``
builds for that rank: buckets and ``perm`` at its columns, row-ELL as
``(1, m_loc, kr)``, ``b`` at its scenarios and row segment), with
``num_rows`` and ``A.split`` global as the reference stores them; pass
``row_shards`` (the local heights are ``num_rows / row_shards``, and so the
stacked top's ``split / row_shards``) and the process groups ``col_group`` /
``row_group`` the tile is summed over.

``state_from_numpy`` keys: ``xp[i]``, ``r``, ``f``, ``gap``, ``k``,
``x_prev``, ``g_prev``; arrays without a scenario axis get one of length 1.

``al_state_from_numpy`` keys: ``eq_lam``, ``eq_rho``, ``x`` (a result of the
augmented-Lagrangian loop); it returns the warm-start arguments of
``solve_equality_constrained``.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.layout import (
    DeviceBanded, DeviceBucket, DeviceDense, DeviceEll, DeviceProblem, DeviceVStack,
    resolve_device,
)
from .solvers.pgd import PGDState

__all__ = ["device_problem_from_numpy", "state_from_numpy", "al_state_from_numpy"]


def _numbered(d: dict, stem: str):
    """The arrays stored under ``stem[0]``, ``stem[1]``, ... as a list."""
    out = []
    while f"{stem}[{len(out)}]" in d:
        out.append(d[f"{stem}[{len(out)}]"])
    return out


def device_problem_from_numpy(d: dict, device="cuda", dtype=torch.float32, row_shards: int = 1,
                              col_group=None, row_group=None) -> DeviceProblem:
    dev = resolve_device(device)

    # torch.tensor copies: the arrays may be read-only views of foreign buffers
    def fl(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

    def ix(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=dev)

    def opt(key, conv):
        return conv(d[key]) if d.get(key) is not None else None

    def ell(stem, num_rows):
        mv_cols, mv_vals = _numbered(d, f"{stem}.mv_cols"), _numbered(d, f"{stem}.mv_vals")
        rt_rows, rt_vals = _numbered(d, f"{stem}.rt_rows"), _numbered(d, f"{stem}.rt_vals")
        return DeviceEll(
            rows=ix(d[f"{stem}.rows"]),
            vals=fl(d[f"{stem}.vals"]),
            mv_cols=tuple(ix(c) for c in mv_cols) if mv_cols else opt(f"{stem}.mv_cols", ix),
            mv_vals=tuple(fl(v) for v in mv_vals) if mv_vals else opt(f"{stem}.mv_vals", fl),
            num_rows=num_rows,
            rt_rows=tuple(ix(c) for c in rt_rows) if rt_rows else None,
            rt_vals=tuple(fl(v) for v in rt_vals) if rt_vals else None,
            rt_inv=opt(f"{stem}.rt_inv", ix),
            rt_zeros=int(d.get(f"{stem}.rt_zeros", 0)),
            nnz=int(np.count_nonzero(np.asarray(d[f"{stem}.vals"]))),
        )

    def matrix(stem, num_rows):
        if f"{stem}.data" in d:
            return DeviceDense(data=fl(d[f"{stem}.data"]))
        if f"{stem}.split" in d:
            split = int(d[f"{stem}.split"]) // row_shards  # the top's local height
            return DeviceVStack(
                top=matrix(f"{stem}.top", split),
                bottom=matrix(f"{stem}.bottom", num_rows - split),
                bottom_scale=fl(d[f"{stem}.bottom_scale"]).reshape(()),
                split=split,
            )
        if f"{stem}.bands[0]" in d:
            bands = tuple(fl(bd) for bd in _numbered(d, f"{stem}.bands"))
            return DeviceBanded(
                bands=bands,
                resid=ell(f"{stem}.resid", num_rows) if f"{stem}.resid.rows" in d else None,
                num_rows=num_rows,
                wpages=int(d[f"{stem}.wpages"]),
                back=int(d[f"{stem}.back"]),
                n_pf=int(np.asarray(d["perm"]).shape[0]),
                seg_lens=tuple(int(v) for v in d[f"{stem}.seg_lens"]),
                pages=int(d.get(f"{stem}.pages") or bands[0].shape[0]),
            )
        return ell(stem, num_rows)

    num_rows = int(d["num_rows"])
    A = matrix("A", num_rows // row_shards)
    buckets = []
    while f"buckets[{len(buckets)}].mask" in d:
        stem = f"buckets[{len(buckets)}]"
        buckets.append(DeviceBucket(
            mask=fl(d[f"{stem}.mask"]),
            sizes=ix(d[f"{stem}.sizes"]),
            radius=fl(d[f"{stem}.radius"]),
            width=int(d[f"{stem}.width"]),
        ))
    return DeviceProblem(
        A=A,
        b=fl(d["b"]),
        buckets=tuple(buckets),
        perm=ix(d["perm"]),
        n_user=int(d["n_user"]),
        num_rows=num_rows,
        row_perm=opt("row_perm", ix),
        col_group=col_group,
        row_group=row_group,
    )


def state_from_numpy(d: dict, device="cuda", dtype=torch.float32) -> PGDState:
    """A ``PGDState`` from numpy arrays; ``xp[i]`` of shape (Bk, w) and
    vectors of shape (n,) are taken as one scenario."""
    dev = resolve_device(device)

    def lead(a, ndim):
        t = torch.tensor(np.asarray(a), dtype=dtype, device=dev)  # a copy
        return t if t.ndim == ndim else t[None]

    f = lead(d["f"], 1)
    # the reference's k: a scalar for one right-hand side, (S,) under vmap
    k = torch.tensor(np.asarray(d["k"]), dtype=torch.int32, device=dev)
    return PGDState(
        xp=tuple(lead(x, 3) for x in _numbered(d, "xp")),
        r=lead(d["r"], 2),
        f=f,
        gap=lead(d["gap"], 1),
        k=k.expand(f.shape).clone(),
        x_prev=lead(d["x_prev"], 2),
        g_prev=lead(d["g_prev"], 2),
    )


def al_state_from_numpy(d: dict) -> dict:
    """The augmented-Lagrangian state ``eq_lam`` ((p,) or (S, p)), ``eq_rho``
    and ``x`` ((N,) or (S, N)) as the warm-start arguments ``lam0``,
    ``rho_init`` and ``x0`` of ``solve_equality_constrained``."""
    return {
        "lam0": np.array(d["eq_lam"], np.float64),
        "rho_init": float(d["eq_rho"]),
        "x0": np.array(d["x"], np.float64),
    }
