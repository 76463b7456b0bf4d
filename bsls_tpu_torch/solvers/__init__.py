from .base import (
    SolveOptions, SolveResult, StopTracker, fw_gap, power_lipschitz,
    power_lipschitz_z, refine_polish, solve, uses_zspace,
)
from . import apgd, frank_wolfe, lbfgs, mirror_descent, pgd

__all__ = [
    "SolveOptions",
    "SolveResult",
    "StopTracker",
    "fw_gap",
    "power_lipschitz",
    "power_lipschitz_z",
    "uses_zspace",
    "refine_polish",
    "solve",
    "apgd",
    "frank_wolfe",
    "lbfgs",
    "mirror_descent",
    "pgd",
]
