"""Per-block simplex ops on the padded (..., B, w) layout: the entropic-mirror
(EG) update, the Frank-Wolfe vertex and the pairwise direction, and the block
minimum of the Frank-Wolfe gap.

Counterpart of ``bsls_tpu/ops/simplex.py``.  The masks are (B, w) and the
radii (B,); values may carry a leading scenario axis, and a step size ``t`` is
a number or an (S,) tensor, one step per scenario.  EG runs in the log domain
for underflow safety.  Ties go to the first index, as ``jnp.argmin`` and
``jnp.argmax`` give them: the masked fill values are the same ``finfo`` bounds
as the reference's, so that a padded slot never wins a tie.
"""
from __future__ import annotations

import torch

__all__ = [
    "eg_update_padded", "eg_update", "fw_vertex_padded", "fw_vertex",
    "pairwise_direction_padded", "pairwise_direction", "block_min",
]

_NEG = -1e30


def _rad(radius, like: torch.Tensor) -> torch.Tensor:
    r = torch.as_tensor(radius, dtype=like.dtype, device=like.device)
    return r[..., None] if r.ndim >= 1 else r


def _per_scenario(t, like: torch.Tensor):
    """A step of one value per scenario broadcast over (S, B, w)."""
    if isinstance(t, torch.Tensor) and t.ndim == 1:
        return t.reshape(-1, *([1] * (like.ndim - 1)))
    return t


def _one_hot(idx: torch.Tensor, w: int, dtype) -> torch.Tensor:
    return (torch.arange(w, device=idx.device) == idx[..., None]).to(dtype)


def eg_update_padded(x: torch.Tensor, g: torch.Tensor, t, mask: torch.Tensor,
                     radius=1.0) -> torch.Tensor:
    """One exponentiated-gradient step per block: x <- x*exp(-t g) renormalised
    to the block's radius.

    Computed as radius * softmax(log x - t g) over valid slots.  Zero
    coordinates stay zero (log 0 is replaced by the floor ``_NEG``).
    """
    valid = mask > 0
    neg = torch.full((), _NEG, dtype=x.dtype, device=x.device)
    logx = torch.where((x > 0) & valid, torch.log(torch.clamp(x, min=1e-38)), neg)
    s = torch.where(valid, logx - _per_scenario(t, x) * g, neg)
    smax = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - smax) * valid
    denom = e.sum(dim=-1, keepdim=True)
    out = _rad(radius, x) * e / torch.clamp(denom, min=1e-38)
    return torch.where(valid, out, torch.zeros((), dtype=x.dtype, device=x.device))


def eg_update(xp, gp, t, buckets):
    return tuple(
        eg_update_padded(x, g, t, bk.mask, bk.radius)
        for x, g, bk in zip(xp, gp, buckets)
    )


def fw_vertex_padded(g: torch.Tensor, mask: torch.Tensor, radius=1.0) -> torch.Tensor:
    """Frank-Wolfe LMO on a product of (radius-scaled) simplices:
    radius * one_hot(argmin) per block.  Dummy rows return all zeros."""
    big = torch.full((), torch.finfo(g.dtype).max, dtype=g.dtype, device=g.device)
    valid = mask > 0
    amin = torch.where(valid, g, big).argmin(dim=-1)
    out = _rad(radius, g) * _one_hot(amin, g.shape[-1], g.dtype)
    row_valid = valid.any(dim=-1, keepdim=True)
    return torch.where(row_valid, out, torch.zeros((), dtype=g.dtype, device=g.device))


def fw_vertex(gp, buckets):
    return tuple(fw_vertex_padded(g, bk.mask, bk.radius) for g, bk in zip(gp, buckets))


def pairwise_direction_padded(x: torch.Tensor, g: torch.Tensor, mask: torch.Tensor,
                              q=None) -> torch.Tensor:
    """Per-block pairwise Frank-Wolfe direction, per-block step-sized.

    On a simplex the iterate's coordinates ARE its vertex weights, so the
    away vertex needs no active-set bookkeeping (Lacoste-Julien & Jaggi,
    arXiv:1511.05932): v = argmax_{j in supp(x)} g_j, s = argmin_j g_j, and
    the pairwise direction transfers weight w from v to s:

        d_b = w_b * (e_s - e_v),   0 <= w_b <= x_v  keeps t in [0,1] feasible.

    With ``q`` = diag(A^T A) in the same padded layout, the transfer is
    *diagonally Newton-sized*: w* = (g_v - g_s)/(q_s + q_v) clipped to the
    away weight (the cross term of the 1-D curvature is dropped; one global
    exact line search over the assembled direction safeguards it).  Without
    ``q`` the transfer is maximal (w = x_v).
    """
    dt, dev = g.dtype, g.device
    big = torch.finfo(dt).max
    valid = mask > 0
    amin = torch.where(valid, g, torch.full((), big, dtype=dt, device=dev)).argmin(dim=-1)
    on_supp = valid & (x > 0)
    amax = torch.where(on_supp, g, torch.full((), -big, dtype=dt, device=dev)).argmax(dim=-1)
    w_ = g.shape[-1]
    oh_s, oh_v = _one_hot(amin, w_, dt), _one_hot(amax, w_, dt)
    x_v = (x * oh_v).sum(dim=-1, keepdim=True)  # away weight
    if q is None:
        w = x_v
    else:
        g_s = (g * oh_s).sum(dim=-1, keepdim=True)
        g_v = (g * oh_v).sum(dim=-1, keepdim=True)
        q_s = (q * oh_s).sum(dim=-1, keepdim=True)
        q_v = (q * oh_v).sum(dim=-1, keepdim=True)
        tiny = torch.finfo(dt).tiny
        w = torch.minimum(x_v, (g_v - g_s) / torch.clamp(q_s + q_v, min=tiny))
        w = torch.clamp(w, min=0.0)
    row_valid = on_supp.any(dim=-1, keepdim=True)
    return torch.where(row_valid, w * (oh_s - oh_v), torch.zeros((), dtype=dt, device=dev))


def pairwise_direction(xp, gp, buckets, qp=None):
    if qp is None:
        qp = (None,) * len(buckets)
    return tuple(
        pairwise_direction_padded(x, g, bk.mask, q)
        for x, g, bk, q in zip(xp, gp, buckets, qp)
    )


def block_min(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-block min over valid slots (0 for dummy rows): used for the FW gap."""
    big = torch.finfo(g.dtype).max
    valid = mask > 0
    m = torch.where(valid, g, torch.full((), big, dtype=g.dtype, device=g.device)).amin(dim=-1)
    return torch.where(valid.any(dim=-1), m, torch.zeros((), dtype=g.dtype, device=g.device))
