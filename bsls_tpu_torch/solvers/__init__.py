from .base import (
    SolveOptions, SolveResult, StopTracker, fw_gap, power_lipschitz,
    power_lipschitz_z, solve, uses_zspace,
)
from . import pgd

__all__ = [
    "SolveOptions",
    "SolveResult",
    "StopTracker",
    "fw_gap",
    "power_lipschitz",
    "power_lipschitz_z",
    "uses_zspace",
    "solve",
    "pgd",
]
