"""Dispatch for the fused-chunk PGD kernel (``ops/chunkkernel.py``).

OPT-IN: ``BSLS_MEGA=1`` enables it, ``BSLS_NO_MEGA=1`` wins over that; off by
default, as in the reference.  When it applies, a whole chunk of iterations
is one kernel launch instead of some forty per iteration.

The runner consumes and produces the same ``PGDState`` the eager path uses,
so the chunk loop's stopping, the callbacks and the final extraction work
unchanged.  The residual, the objective, the gradient and the FW-gap
certificate are recomputed exactly at the chunk boundary; within a chunk the
f-trace comes from the kernel and ``trace_gap`` repeats the boundary value.

Eligibility (all required; anything else keeps the eager path):
  an unsharded problem (the reference keeps a mesh off it: a chunk in one
  launch has no place for the collectives of a step),
  method pgd + exact line search in x-space, a single right-hand side, dense
  A, one width bucket, fp32, a block width the kernel's projection takes, and
  A small enough to stay in the card's L2 cache between the two reads of a
  step.

Counterpart of ``bsls_tpu/solvers/mega.py``.  On the CPU (with the gate set)
the runner goes through the plain version of the kernel, as the reference
runs its kernel in interpret mode off its device.
"""
from __future__ import annotations

import os
from functools import lru_cache
from typing import Optional

import torch

from ..ops import layout as L, quadratic as Q
from ..ops.chunkkernel import pgd_chunk
from ..ops.rowkernels import MAX_WIDTH

__all__ = ["make_mega_runner", "mega_eligible", "use_mega", "MAX_A_BYTES"]

# The kernel reads A twice per step and has no other large operand.  It is
# worth dispatching while A stays resident in the H100's 50 MB L2 cache beside
# the per-block partial gradients; above this it would stream A from device
# memory every step, which the eager path does as well as it.
MAX_A_BYTES = 32 << 20


@lru_cache(maxsize=1)
def use_mega() -> bool:
    if os.environ.get("BSLS_NO_MEGA", "") == "1":
        return False
    return os.environ.get("BSLS_MEGA", "") == "1"


def mega_eligible(dp, method: str, opts) -> bool:
    if not use_mega() or dp.sharded:
        return False
    if method != "pgd" or opts.line_search != "exact" or opts.space != "x":
        return False
    if dp.b.ndim != 1:
        return False
    if not isinstance(dp.A, L.DeviceDense) or len(dp.buckets) != 1:
        return False
    if dp.b.dtype != torch.float32:
        return False
    if dp.buckets[0].mask.shape[1] > MAX_WIDTH:
        return False
    return dp.A.data.numel() * 4 <= MAX_A_BYTES


def make_mega_runner(dp, method: str, opts, L_est, chunk: int) -> Optional[object]:
    """Return run(state) -> (state, (trace_f, trace_gap)) with traces of shape
    (1, chunk), or None if the fused chunk does not apply to this (problem,
    options) combination."""
    if not mega_eligible(dp, method, opts):
        return None

    from .base import fw_gap
    from .pgd import PGDState

    bk = dp.buckets[0]
    t0 = opts.step_size if opts.step_size > 0 else 1.0 / float(L_est)
    A = dp.A.data.contiguous()

    def run(state):
        x_new, tf = pgd_chunk(A, dp.b, state.xp[0][0].contiguous(), bk.sizes, bk.radius,
                              t0, chunk)
        # exact residual, objective and certificate at the chunk boundary
        xp = (x_new[None],)
        x_flat = L.padded_to_flat(dp, xp)
        r = Q.residual(dp, x_flat, dp.b[None])
        f = Q.objective_from_residual(dp, r)
        g_flat = Q.grad_flat(dp, r)
        gap = fw_gap(dp, g_flat, x_flat, L.flat_to_padded(dp, g_flat))
        st = PGDState(xp=xp, r=r, f=f, gap=gap, k=state.k + chunk,
                      x_prev=x_flat, g_prev=g_flat)
        return st, (tf[None], gap[:, None].expand(1, chunk))

    return run
