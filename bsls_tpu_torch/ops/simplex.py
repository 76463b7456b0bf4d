"""Per-block simplex ops on the padded (..., B, w) layout.

Counterpart of ``bsls_tpu/ops/simplex.py``.  Only ``block_min`` (the
Frank-Wolfe gap needs it) is ported; the mirror-descent update and the
Frank-Wolfe vertex/pairwise directions come with their solvers.
"""
from __future__ import annotations

import torch

__all__ = ["block_min"]


def block_min(g: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-block min over valid slots (0 for dummy rows): used for the FW gap."""
    big = torch.finfo(g.dtype).max
    valid = mask > 0
    m = torch.where(valid, g, torch.full((), big, dtype=g.dtype, device=g.device)).amin(dim=-1)
    return torch.where(valid.any(dim=-1), m, torch.zeros((), dtype=g.dtype, device=g.device))
