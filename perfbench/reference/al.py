"""Plain reference of the served equality-constrained solve: the augmented
Lagrangian loop around the reference's PGD, written from its definition.

    minimize 0.5 ||A x - b||^2  over x in a product of unit simplices,  C x = d

With multipliers lam (S, p) and one penalty rho for all scenarios, each
outer solves min 0.5 ||[A; sqrt(rho) C] x - [b; sqrt(rho) (d - lam / rho)]||^2
by ``inner_iters`` PGD steps (``pgd.pgd_exact``), warm from the last outer's
x (the uniform point at the first), then lam += rho (C x - d) in float64;
rho grows by ``rho_growth`` when the worst relative violation
||Cx - d||_inf / max(1, ||d||_inf) fell by less than 4x and is above
``eq_tol``.  rho starts at 0.1 times mean ||A_j||^2 / mean ||C_j||^2.  The
stacked operator keeps the block equilibration of the first rho; its
step bound is L(rho0) + (rho - rho0) L_C, L_C the bound of the scaled C
alone.  The loop runs until the inner budget ``max_iter`` is spent (a run
with ``tol = 0`` never stops earlier).  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from .pgd import Blocks, Objective, Operator, block_scales, pgd_exact, power_norm, project

__all__ = ["solve_eq"]


def solve_eq(rows, vals, m, sizes, C: np.ndarray, B: np.ndarray, D: np.ndarray, *,
             max_iter: int, inner_iters: int, chunk: int, eq_tol: float, device,
             dtype=torch.float64, tf32: bool = False, rho_growth: float = 4.0,
             power_iters: int = 30):
    """(x (S, n) float64, objective (S,), worst violation) of the served
    solve; the objective 0.5 ||A x - b||^2 and the violation as the program
    reports them, in float64 from x, whatever ``dtype`` the loop ran in."""
    B = np.atleast_2d(np.asarray(B, np.float64))
    D = np.array(np.broadcast_to(np.atleast_2d(np.asarray(D, np.float64)),
                                 (B.shape[0], C.shape[0])))
    S, n, p = B.shape[0], int(sizes.sum()), C.shape[0]
    a_cn2 = (vals * vals).sum(1)
    c_cn2 = (C * C).sum(0)
    rho = 0.1 * float(a_cn2.mean()) / (float(c_cn2.mean()) or 1.0)
    rho0 = rho
    c = block_scales(a_cn2 + rho0 * c_cn2, sizes)
    c_col = np.repeat(c, sizes)
    op = Operator(rows, vals, m, c_col, dtype, device, C=C, tf32=tf32)
    blocks = Blocks(sizes, c, device, dtype)
    op.scale = float(np.sqrt(rho0))
    L_top = 1.05 * power_norm(op, n, power_iters)
    # the scaled C alone: the top's values zeroed
    bottom = Operator(rows, np.zeros_like(vals), m, c_col, dtype, device, C=C, tf32=tf32)
    bottom.scale = 1.0
    L_C = 1.05 * power_norm(bottom, n, power_iters)
    lam = np.zeros((S, p))
    viol = np.inf
    U = torch.as_tensor(np.tile(c_col / np.repeat(sizes, sizes), (S, 1)),
                        dtype=dtype, device=device)
    c_t = torch.as_tensor(c_col, device=device)
    Dt = torch.as_tensor(D, dtype=torch.float64, device=device)
    d_scale = max(1.0, float(np.abs(D).max()))
    total = 0
    while total < max_iter:
        steps = min(inner_iters, max_iter - total)
        sr = float(np.sqrt(rho))
        op.scale = sr
        Bst = torch.as_tensor(np.concatenate([B, sr * (D - lam / rho)], axis=1), dtype=dtype,
                              device=device)
        L = L_top + max(0.0, rho - rho0) * L_C
        U, _ = pgd_exact(op, blocks, Bst, U, L, steps, chunk)
        total += steps
        U = project(U, blocks)
        # C x - d as the loop sees it, in the working precision
        cx_d = (op._dense(U, op.C.T).double() - Dt).cpu().numpy()
        new_viol = float(np.abs(cx_d).max()) / d_scale
        lam = lam + rho * cx_d
        if new_viol > 0.25 * viol and new_viol > eq_tol:
            rho *= rho_growth
        viol = new_viol
    x = (U.to(torch.float64) / c_t).cpu().numpy()
    viol = float(np.abs(x @ C.T - D).max()) / d_scale
    return x, Objective(rows, vals, m, device)(x, B), viol
