"""How ``correct`` is decided: the answers of the window against the plain
reference (``perfbench/reference``), each number beside its limit.

Every answered request is checked by what it says: each block of x on its
simplex (``simplex_err``), and the objective it reports against the
objective of its x recomputed in float64 (``obj_err``, where the cell
compares it: an equality-constrained answer reports its objective, as its
control does, in float64 from x, so no control separates that number).  A sample
drawn from the seed is solved again by the reference in float64 and
compared: the float64 objective of the answer over the reference's
(``obj_ratio``), and for an equality-constrained answer its violation over
the reference's (``viol_ratio``).  Both are one-sided: the reference takes
the exact step bound 1.05 ||A||^2, which the program's power iteration can
only fall below, and a smaller bound takes longer trial steps, so a sound
answer reads at most about 1 (PERF.md: an answer of the same budget with a
bound 3% lower reads 0.95).  The reference reads the program's answers only
to judge them.
"""
from __future__ import annotations

import math

import numpy as np

from reference import al as RA
from reference import pgd as RP

__all__ = ["numbers", "judge"]


def _rows(res) -> tuple:
    """(x (S, n) float64, objective (S,)) of one answer."""
    return (np.atleast_2d(np.asarray(res.x, np.float64)),
            np.atleast_1d(np.asarray(res.objective, np.float64)))


def _violation(X, C, D):
    """Worst relative violation ||Cx - d||_inf / max(1, ||d||_inf)."""
    D = np.broadcast_to(np.atleast_2d(D), (X.shape[0], C.shape[0]))
    return float(np.abs(X @ C.T - D).max()) / max(1.0, float(np.abs(D).max()))


def _rel(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


def numbers(kind: str, inst, traffic: dict, pool: list, answers: list, seed: int,
            device) -> dict:
    """The compared numbers of the answered requests (each a dict with
    ``pool`` and ``result``)."""
    if not answers:
        return {}
    objective = RP.Objective(inst.rows, inst.vals, inst.m, device)
    out = {"simplex_err": 0.0, "obj_err": 0.0}
    for rec in answers:
        X, f = _rows(rec["result"])
        B = pool[rec["pool"]]
        out["simplex_err"] = max(out["simplex_err"], RP.simplex_error(X, inst.sizes))
        out["obj_err"] = max(out["obj_err"], _rel(f, objective(X, B)))
    rng = np.random.default_rng([seed, 5])
    solve, chunk = traffic["solve"], traffic["endpoint"]["chunk"]
    first = {}  # one answer of each distinct right-hand side
    for rec in answers:
        first.setdefault(rec["pool"], rec)
    if kind == "pgd":
        S = int(traffic["scenarios"])
        keys = [(p, s) for p in sorted(first) for s in range(S)]
        pick = sorted(rng.choice(len(keys), size=min(int(traffic["check_sample"]), len(keys)),
                                 replace=False))
        keys = [keys[i] for i in pick]
        Bs = np.stack([np.atleast_2d(pool[p])[s] for p, s in keys])
        Xp = np.stack([_rows(first[p]["result"])[0][s] for p, s in keys])
        Xr, _ = RP.solve(inst.rows, inst.vals, inst.m, inst.sizes, Bs, solve["max_iter"], chunk,
                         device)
        out["obj_ratio"] = float(np.max(objective(Xp, Bs) / objective(Xr, Bs)))
    elif kind == "al":
        p = sorted(first)[int(rng.integers(len(first)))]
        X, _ = _rows(first[p]["result"])
        B = np.atleast_2d(pool[p])
        Xr, _, _ = RA.solve_eq(inst.rows, inst.vals, inst.m, inst.sizes, inst.C, B, inst.d,
                               max_iter=solve["max_iter"], inner_iters=solve["inner_iters"],
                               chunk=chunk, eq_tol=solve["eq_tol"], device=device)
        out["obj_ratio"] = float(np.max(objective(X, B) / objective(Xr, B)))
        out["viol_ratio"] = _violation(X, inst.C, inst.d) / _violation(Xr, inst.C, inst.d)
    else:
        raise ValueError(f"unknown reference {kind!r}")
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: [value, limit]}): every limited number within its
    limit; a number that is missing or not finite fails."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        table[name] = [v if v is not None and math.isfinite(v) else 1e300, limit]
    return ok, table
