from .base import (
    SolveOptions, SolveResult, StopTracker, fw_gap, power_lipschitz,
    power_lipschitz_z, refine_polish, solve, uses_zspace,
)
from .eq_constrained import (
    eq_dual_bound, eq_multiplier_polish, prox_bpp_polish, solve_eq_sensitivity,
    solve_equality_constrained,
)
from . import apgd, eq_constrained, frank_wolfe, graph, lbfgs, mirror_descent, pgd

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
    "solve_equality_constrained",
    "solve_eq_sensitivity",
    "prox_bpp_polish",
    "eq_dual_bound",
    "eq_multiplier_polish",
    "apgd",
    "eq_constrained",
    "frank_wolfe",
    "graph",
    "lbfgs",
    "mirror_descent",
    "pgd",
]
