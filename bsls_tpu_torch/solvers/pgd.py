"""Projected gradient solver (x-space sort-projection or z-space PAVA).

Line-search modes:
  exact  — candidate x^ = proj(x - t0 g), then closed-form quadratic step
           along d = x^ - x (monotone descent, 2 matvecs/iter)
  pava   — same but in z-space: candidate z^ = iso_[0,1](z - t0 D^T g) via
           the PAVA kernel; direction mapped back linearly
  bb     — Barzilai-Borwein step, projected (non-monotone, cheapest)
  bbm    — monotone safeguarded BB: the projected BB candidate is kept only
           if it descends; otherwise the exact quadratic step along the
           same direction (guaranteed descent: d is a projection-arc
           direction, g.d < 0) replaces the unit step.
  fixed  — constant step (opts.step_size or 1/L)

Counterpart of ``bsls_tpu/solvers/pgd.py``.  The state always carries a
leading scenario axis S (S = 1 for a single right-hand side): ``xp[k]`` is
(S, Bk, w), ``r`` is (S, m), and ``f``, ``gap`` and every step size are (S,)
— one exact step per scenario.

The exact x-space step (``_exact_step``) runs its passes around the
products and the projection through ``ops/stepkernels.py``: its three
hand-written kernels where ``fused_step`` holds (float32 on the card, no
process group), else their plain versions (the CPU, float64, a mesh, whose
dots are summed over ranks before t is formed).  The other modes take the
chain of PyTorch passes in ``step``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..ops import isotonic, layout as L, projection, quadratic as Q, stepkernels as SK
from ..ops import ztransform as Z
from .base import SolveOptions, fw_gap

__all__ = ["PGDState", "init", "step", "refresh", "fused_step"]


@dataclass(frozen=True)
class PGDState:
    xp: tuple  # per bucket (S, Bk, w)
    r: torch.Tensor  # (S, m) residual A x - b, in the device row order
    f: torch.Tensor  # (S,)
    gap: torch.Tensor  # (S,)
    k: torch.Tensor  # (S,) int32 iterations taken, on the device
    x_prev: torch.Tensor  # (S, n_pf) previous iterate, for BB (x- or z-space)
    g_prev: torch.Tensor  # (S, n_pf) previous gradient, same space


# how each field lies on a mesh (parallel/sharding.py::leaf_layout)
PGDState.SHARD_KINDS = {
    "xp": "x", "r": "r", "f": "scalar", "gap": "scalar", "k": "scalar",
    "x_prev": "xflat", "g_prev": "xflat",
}


def _rhs(dp: L.DeviceProblem) -> torch.Tensor:
    return dp.b if dp.b.ndim == 2 else dp.b[None]


def _dz_forward(dzp, buckets):
    """Linear part of z->x per bucket (see ztransform.dz_forward_padded)."""
    return tuple(Z.dz_forward_padded(dz, bk.mask) for dz, bk in zip(dzp, buckets))


def init(dp: L.DeviceProblem, L_est, opts: SolveOptions, xp0=None) -> PGDState:
    b = _rhs(dp)
    xp = xp0 if xp0 is not None else L.feasible_init(dp, scenarios=b.shape[0])
    x_flat = L.padded_to_flat(dp, xp)
    r = Q.residual(dp, x_flat, b)
    f = Q.objective_from_residual(dp, r)
    return PGDState(
        xp=xp, r=r, f=f,
        gap=torch.full_like(f, float("inf")),
        k=torch.zeros(f.shape, dtype=torch.int32, device=f.device),
        x_prev=x_flat,
        g_prev=torch.zeros_like(x_flat),
    )


def refresh(dp, st: PGDState, L_est, opts: SolveOptions) -> PGDState:
    """Recompute the residual exactly (the steps update it incrementally)."""
    r = Q.residual(dp, L.padded_to_flat(dp, st.xp), _rhs(dp))
    return replace(st, r=r, f=Q.objective_from_residual(dp, r))


def fused_step(dp, opts: SolveOptions, st: PGDState) -> bool:
    """Whether ``step`` launches the step kernels of ``ops/stepkernels.py``:
    the exact line search in x-space on a float32 state on the card, with no
    process group over the problem (whose dots would need an all-reduce
    before t is formed)."""
    return (opts.line_search == "exact" and opts.space == "x" and st.r.is_cuda
            and st.r.dtype == torch.float32 and not dp.sharded)


def _exact_step(dp, st: PGDState, L_est, opts: SolveOptions, fused: bool) -> PGDState:
    """The exact x-space step: the step kernels where ``fused``, else their
    plain versions, which take the same arguments."""
    if fused:
        prep, direction, update = SK.step_prep, SK.step_dir, SK.step_update
    else:
        prep, direction, update = SK.prep_plain, SK.dir_plain, SK.update_plain
    g_flat = Q.grad_flat(dp, st.r)
    cand, x_flat, gap = prep(dp, st.xp, g_flat, st.f, L_est, opts.step_size)
    xhat = projection.proj_blocks(cand, dp.buckets)
    d = direction(dp, xhat, st.xp, x_flat, g_flat)
    Ad = L.matvec_ps(dp, d.flat, d.operand)
    xp_new, r_new, f_new, gap = update(dp, st.xp, x_flat, st.r, d, Ad, gap)
    return PGDState(xp=xp_new, r=r_new, f=f_new, gap=gap, k=st.k + 1,
                    x_prev=x_flat, g_prev=g_flat)


def step(dp, st: PGDState, L_est, opts: SolveOptions) -> PGDState:
    if opts.line_search == "exact" and opts.space == "x":
        return _exact_step(dp, st, L_est, opts, fused_step(dp, opts, st))
    x_flat = L.padded_to_flat(dp, st.xp)
    g_flat = Q.grad_flat(dp, st.r)
    gp = L.flat_to_padded(dp, g_flat)
    gap = fw_gap(dp, g_flat, x_flat, gp)
    zspace = opts.line_search == "pava" or opts.space == "z"

    # when the trial point is built in z-space, the whole trial-step logic
    # (1/L, BB differences) must live in z-space too: the cumulative-sum map
    # D inflates curvature to ||A D||^2 = O(w^2)||A||^2, so x-space steps are
    # orders too long there.  solve() passes the matching power_lipschitz_z
    # estimate as L_est for these modes.
    if zspace:
        zp = tuple(Z.x_to_z_padded(x, bk.mask) for x, bk in zip(st.xp, dp.buckets))
        gzp = tuple(Z.dz_adjoint_padded(g, bk.mask) for g, bk in zip(gp, dp.buckets))
        u_flat = L.padded_to_flat(dp, zp)
        gu_flat = L.padded_to_flat(dp, gzp)
    else:
        zp = gzp = None
        u_flat, gu_flat = x_flat, g_flat

    t0 = (torch.full_like(st.f, opts.step_size) if opts.step_size > 0
          else Q.inv_lipschitz(L_est, st.f))
    if opts.line_search in ("bb", "bbm") or zspace:
        # z-space modes always take the spectral (BB) trial step: the exact
        # segment step below is clipped to t<=1 (feasibility of the z-segment),
        # so a 1/L_z trial — with L_z = O(w^2)||A||^2 — would cap per-iteration
        # progress at the tiny trial step itself.  BB adapts to the local
        # curvature; the exact safeguard keeps pava monotone.  The first
        # iteration takes the 1/L step; its BB candidate (from init's finite
        # x_prev and zero g_prev) is computed and dropped, so that no branch
        # on the host reads k.
        du = u_flat - st.x_prev
        dg = gu_flat - st.g_prev
        t_bb = Q.bb_step(L.xdot(dp, du, du), L.xdot(dp, du, dg), fallback=t0)
        t0 = torch.where(st.k > 0, t_bb, t0)
    t0b = t0[:, None, None]

    if zspace:
        zhat = isotonic.pava_blocks(tuple(z - t0b * gz for z, gz in zip(zp, gzp)), dp.buckets)
        dzp = tuple(zh - z for zh, z in zip(zhat, zp))
        dxp = _dz_forward(dzp, dp.buckets)
    else:
        cand = tuple(x - t0b * g for x, g in zip(st.xp, gp))
        xhat = projection.proj_blocks(cand, dp.buckets)
        dxp = tuple(xh.sub_(x) for xh, x in zip(xhat, st.xp))  # xhat is fresh

    d_flat = L.padded_to_flat(dp, dxp)
    Ad = L.matvec_ps(dp, d_flat)
    if opts.line_search == "exact":  # in z-space (x-space: _exact_step)
        t = Q.exact_step(dp, L.xdot(dp, g_flat, d_flat), Ad, 0.0, 1.0)
    elif opts.line_search in ("bbm", "pava"):
        # pava shares the monotone BB safeguard: unit BB step if it descends,
        # else the exact quadratic minimiser along the same (descent)
        # direction — keeps the BB rate AND monotonicity
        g_dot_d = L.xdot(dp, g_flat, d_flat)
        dAAd = L.rdot(dp, Ad, Ad)
        f_unit = st.f + g_dot_d + 0.5 * dAAd  # f(x+d), exact for a quadratic
        t_exact = torch.clamp(-g_dot_d / torch.clamp(dAAd, min=1e-30), 0.0, 1.0)
        t = torch.where(f_unit <= st.f, torch.ones_like(t_exact), t_exact)
    else:
        t = torch.ones_like(st.f)

    # x + t d and r + t Ad are written into the buffers of d and Ad, which
    # this step owns (every dot product that reads them is taken above): no
    # extra (S, n_pf) / (S, m) allocation, and the old state stays intact
    tb = t[:, None, None]
    xp_new = tuple(d.mul_(tb).add_(x) for x, d in zip(st.xp, dxp))
    r_new = Ad.mul_(t[:, None]).add_(st.r)
    f_new = Q.objective_from_residual(dp, r_new)
    return PGDState(
        xp=xp_new, r=r_new, f=f_new, gap=gap, k=st.k + 1,
        x_prev=u_flat, g_prev=gu_flat,
    )
