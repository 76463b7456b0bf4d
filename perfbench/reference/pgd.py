"""Plain reference of the served solve: projected gradient with the exact
line search on the block-equilibrated problem, written from its definition.

    minimize 0.5 ||A x - b||^2  over x in a product of unit simplices

Solved, as the program documents it, in u = c_b x with A's columns divided
by c_b (c_b the RMS column norm of A over block b), each block on the
simplex of radius c_b, from the uniform point.  A step: g = A_u^T r, the
candidate proj(u - g / L), d = candidate - u, t = -(g.d) / ||A_u d||^2
clipped to [0, 1], u += t d, r += t A_u d; the residual is recomputed
exactly every ``chunk`` steps.  L is 1.05 ||A_u||^2, the norm from a subspace
iteration of the reference's own (the program's power iteration can only
fall below it).

Plain PyTorch on the benchmark's raw arrays, in any dtype: float64 for the
reference, a lower precision for the control.  Products are gathers with a
sum over a padded axis (row-ELL for A u, column-ELL for A^T r); the
projection sorts.  Imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Operator", "Blocks", "project", "power_norm", "pgd_exact", "Objective",
           "simplex_error", "block_scales", "solve"]


def _row_ell(rows: np.ndarray, vals: np.ndarray, m: int):
    """(m, kr) column ids and values of A's rows, padded with (0, 0)."""
    mask = vals != 0
    cols = np.broadcast_to(np.arange(rows.shape[0])[:, None], rows.shape)[mask]
    r, v = rows[mask], vals[mask]
    order = np.argsort(r, kind="stable")
    r, cols, v = r[order], cols[order], v[order]
    counts = np.bincount(r, minlength=m)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(r.size) - starts[r]
    kr = max(int(counts.max()), 1)
    out_c = np.zeros((m, kr), np.int64)
    out_v = np.zeros((m, kr))
    out_c[r, slot] = cols
    out_v[r, slot] = v
    return out_c, out_v


class Operator:
    """[A; s C] diag(1 / col_scale) as plain gathers and one dense product,
    in ``dtype`` on ``device``.  ``s`` (the bottom's scale) is set per use;
    ``tf32`` lets the dense product round its inputs to TF32."""

    def __init__(self, rows, vals, m, col_scale, dtype, device, C=None, tf32=False):
        self.dtype, self.device, self.m, self.tf32 = dtype, device, m, tf32
        t = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=device)  # noqa: E731
        inv = 1.0 / np.asarray(col_scale, np.float64)
        self.col_rows = t(rows, torch.int64)
        self.col_vals = t(vals * inv[:, None])
        rc, rv = _row_ell(rows, vals, m)
        self.row_cols = t(rc, torch.int64)
        self.row_vals = t(rv * inv[rc])
        self.C = None if C is None else t(np.asarray(C) * inv[None, :])
        self.scale = 0.0  # the bottom's scale s

    def _dense(self, a, b):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.tf32
        try:
            return a @ b
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old

    def matvec(self, U: torch.Tensor, chunk: int = 16) -> torch.Tensor:
        """(S, n) -> (S, m [+ p])."""
        top = torch.cat([(U[s:s + chunk][:, self.row_cols] * self.row_vals).sum(-1)
                         for s in range(0, U.shape[0], chunk)])
        if self.C is None:
            return top
        return torch.cat([top, self.scale * self._dense(U, self.C.T)], dim=1)

    def rmatvec(self, R: torch.Tensor, chunk: int = 16) -> torch.Tensor:
        """(S, m [+ p]) -> (S, n)."""
        Rt = R[:, :self.m]
        g = torch.cat([(Rt[s:s + chunk][:, self.col_rows] * self.col_vals).sum(-1)
                       for s in range(0, R.shape[0], chunk)])
        if self.C is not None:
            g = g + self.scale * self._dense(R[:, self.m:], self.C)
        return g


class Blocks:
    """The columns of each block size as (B_w, w) index arrays, and each
    block's radius there."""

    def __init__(self, sizes: np.ndarray, radius: np.ndarray, device, dtype):
        offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self.groups = []
        for w in np.unique(sizes):
            ids = np.flatnonzero(sizes == w)
            idx = offsets[ids][:, None] + np.arange(w)[None, :]
            self.groups.append((torch.as_tensor(idx, device=device),
                                torch.as_tensor(radius[ids], dtype=dtype, device=device)))


def project(V: torch.Tensor, blocks: Blocks) -> torch.Tensor:
    """Each block of each row of V (S, n) onto its simplex {v >= 0, sum v = c_b}
    (sort, cumulative sum, the largest support that stays positive)."""
    out = torch.empty_like(V)
    for idx, c in blocks.groups:
        v = V[:, idx]  # (S, B_w, w)
        s, _ = torch.sort(v, dim=-1, descending=True)
        css = torch.cumsum(s, dim=-1) - c[None, :, None]
        k = torch.arange(1, v.shape[-1] + 1, dtype=v.dtype, device=v.device)
        support = (s - css / k > 0).sum(-1, keepdim=True).clamp(min=1)
        tau = css.gather(-1, support - 1) / support.to(v.dtype)
        out[:, idx] = torch.clamp(v - tau, min=0)
    return out


def _dot(a, b):
    return (a * b).sum(-1)


def power_norm(op: Operator, n: int, iters: int, block: int = 64, seed: int = 12345) -> float:
    """||op||^2, the largest eigenvalue of op^T op, by subspace iteration on
    ``block`` seeded vectors and a Rayleigh-Ritz step: close to exact where
    the top of the spectrum is a cluster, which slows a single vector."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    V = torch.randn((min(block, n), n), generator=gen, dtype=torch.float64)
    V = torch.linalg.qr(V.T)[0].T.to(op.device)
    for _ in range(iters):
        W = op.rmatvec(op.matvec(V.to(op.dtype))).to(torch.float64)
        V = torch.linalg.qr(W.T)[0].T
    W = op.rmatvec(op.matvec(V.to(op.dtype))).to(torch.float64)
    return float(torch.linalg.eigvalsh(V @ W.T).max())


def pgd_exact(op: Operator, blocks: Blocks, B: torch.Tensor, U0: torch.Tensor, L: float,
              iters: int, chunk: int) -> tuple:
    """``iters`` exact-line-search PGD steps from U0 (S, n) against B (S, m'),
    in the operator's dtype; returns the final iterate U (unprojected) and
    its running residual."""
    U = U0.clone()
    R = None
    for k in range(iters):
        if k % chunk == 0:
            R = op.matvec(U) - B
        G = op.rmatvec(R)
        D = project(U - G / L, blocks) - U
        AD = op.matvec(D)
        t = torch.clamp(-_dot(G, D) / torch.clamp(_dot(AD, AD), min=1e-30), 0.0, 1.0)[:, None]
        U = U + t * D
        R = R + t * AD
    return U, R


class Objective:
    """0.5 ||A x - b||^2 per row of X, in float64 (A unscaled)."""

    def __init__(self, rows, vals, m, device):
        self.op = Operator(rows, vals, m, np.ones(rows.shape[0]), torch.float64, device)

    def __call__(self, X: np.ndarray, B: np.ndarray) -> np.ndarray:
        dev = self.op.device
        X = torch.as_tensor(np.atleast_2d(X), dtype=torch.float64, device=dev)
        R = self.op.matvec(X) - torch.as_tensor(np.atleast_2d(B), dtype=torch.float64, device=dev)
        return (0.5 * _dot(R, R)).cpu().numpy()


def simplex_error(X: np.ndarray, sizes: np.ndarray) -> float:
    """The largest distance of any block of X (S, n) from its unit simplex:
    the block sum's distance from 1 or the most negative entry; inf where X
    is not finite."""
    X = np.atleast_2d(np.asarray(X, np.float64))
    if not np.isfinite(X).all():
        return math.inf
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    sums = np.add.reduceat(X, offs, axis=1)
    return float(max(np.abs(sums - 1.0).max(), -min(X.min(), 0.0)))


def block_scales(col_norms_sq: np.ndarray, sizes: np.ndarray) -> np.ndarray:
    """c_b = sqrt(mean of the block's squared column norms), 1 where 0."""
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    c = np.sqrt(np.add.reduceat(col_norms_sq, offs) / sizes)
    c[c <= 0] = 1.0
    return c


def solve(rows, vals, m, sizes, B: np.ndarray, iters: int, chunk: int, device,
          dtype=torch.float64, power_iters: int = 30) -> tuple:
    """The served unconstrained solve of each row of B: (S, n) float64 x, and
    the objective as the solve reports it, 0.5 ||r||^2 of its running
    residual in ``dtype``."""
    cn2 = (vals * vals).sum(1)
    c = block_scales(cn2, sizes)
    c_col = np.repeat(c, sizes)
    op = Operator(rows, vals, m, c_col, dtype, device)
    blocks = Blocks(sizes, c, device, dtype)
    n = int(sizes.sum())
    L = 1.05 * power_norm(op, n, power_iters)
    Bt = torch.as_tensor(np.atleast_2d(B), dtype=dtype, device=device)
    U0 = torch.as_tensor(np.tile(c_col / np.repeat(sizes, sizes), (Bt.shape[0], 1)),
                         dtype=dtype, device=device)
    U, R = pgd_exact(op, blocks, Bt, U0, L, iters, chunk)
    X = project(U, blocks).to(torch.float64) / torch.as_tensor(c_col, device=device)
    return X.cpu().numpy(), (0.5 * _dot(R, R)).double().cpu().numpy()
