"""Solver protocol and the host-side solve loop.

A solver module exposes plain functions on tensors

    init(dp, L_est, opts, xp0=None)  -> state   (a frozen dataclass of tensors)
    step(dp, state, L_est, opts)     -> state   (one iteration)
    refresh(dp, state, L_est, opts)  -> state   (recompute exact residual/objective)

State always carries: xp (padded iterate), r (residual), f (objective),
gap (Frank-Wolfe duality gap — a true optimality certificate on products of
simplices: f(x) - f* <= gap), k (iteration counter).  Every field has a
leading scenario axis S.

``solve`` runs chunks of K steps in a Python loop and reads back the
end-of-chunk (f, gap) once per chunk — convergence checks, wall-clock trace
and metrics all amortise over the chunk.  Solvers never branch on data on
the host inside a chunk.

Iterations use an *incremental residual* (r += t * A d), so PGD costs two
matvec-equivalents per iteration; ``refresh`` recomputes r exactly at every
chunk boundary to stop fp drift.

With ``BSLS_MEGA=1`` a chunk of an eligible solve is one launch of the
fused-chunk kernel (``solvers/mega.py``).

Counterpart of ``bsls_tpu/solvers/base.py`` for ``method="pgd"``.  Parts that
are not ported yet raise ``NotImplementedError``; none is silently ignored.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.problem import Problem
from ..ops import layout as L
from ..ops import ztransform as Z
from ..ops.projection import proj_blocks
from ..ops.simplex import block_min

__all__ = [
    "SolveOptions", "SolveResult", "StopTracker", "fw_gap", "power_lipschitz",
    "power_lipschitz_z", "uses_zspace", "solve",
]


@dataclass(frozen=True)
class SolveOptions:
    """Static solver options."""

    method: str = "pgd"
    line_search: str = "exact"  # exact | bb | bbm | fixed | pava
    tol: float = 1e-6  # relative FW-gap tolerance: gap <= tol * max(1, |f|)
    max_iter: int = 10_000
    chunk: int = 100  # iterations between host readbacks
    step_size: float = 0.0  # fixed step (0 -> 1/L from power iteration)
    space: str = "x"  # x | z  (z-space PGD projects with PAVA)


_LINE_SEARCHES = ("exact", "bb", "bbm", "fixed", "pava")


@dataclass
class SolveResult:
    x: np.ndarray  # flat solution (N,) or (S, N)
    objective: float | np.ndarray
    gap: float | np.ndarray
    iterations: int
    converged: bool
    trace_f: np.ndarray  # (iters,) or (S, iters)
    trace_gap: np.ndarray
    chunk_times: np.ndarray  # wall seconds per chunk
    chunk_iters: np.ndarray  # cumulative iteration count per chunk boundary
    stop_reason: str = "max_iter"  # "gap" | "stall" | "gap/stall" | "max_iter"

    def steady_iters_per_sec(self, skip: int = 1) -> float:
        """Solver iterations/sec from the paired (chunk_iters, chunk_times)
        records, skipping the first ``skip`` intervals (warm-up lands there):
        iterations-spanned / seconds-spanned."""
        t = np.asarray(self.chunk_times, float)
        i = np.asarray(self.chunk_iters, float)
        if t.size == 0 or i.size == 0:
            return 0.0
        if t.size <= skip:
            skip = 0
        start = i[skip - 1] if skip else 0.0
        dt = float(np.sum(t[skip:]))
        return float((i[-1] - start) / dt) if dt > 0 else 0.0

    def time_to_gap(self, f_star: float, rel: float = 1e-6) -> float | None:
        """Wall seconds until f <= f* + rel*max(1,|f*|), from the chunk trace."""
        thresh = f_star + rel * max(1.0, abs(f_star))
        tf = self.trace_f if self.trace_f.ndim == 1 else self.trace_f.max(axis=0)
        hits = np.nonzero(tf <= thresh)[0]
        if hits.size == 0:
            return None
        it = hits[0] + 1
        # linear interpolation of wall time within the chunk trace
        cum_t = np.concatenate([[0.0], np.cumsum(self.chunk_times)])
        cum_i = np.concatenate([[0], self.chunk_iters])
        return float(np.interp(it, cum_i, cum_t))


class StopTracker:
    """Per-chunk convergence decision.

    A scenario counts as converged when either
      * its relative FW gap is <= tol  (sound optimality certificate), or
      * (stop_rule "stall"/"auto") its RUNNING-BEST objective improved by
        less than ``stall_frac * tol * max(1, |f|)`` over each of
        ``patience`` consecutive chunks — the practical criterion: the
        FW-gap certificate is loose on ill-conditioned instances, so
        gap-only stopping would always exhaust max_iter there.  Tracking
        the best (not last) objective keeps non-monotone methods (bb) from
        registering oscillation as progress; use stop_rule="gap" for
        certificate-only stopping.
    """

    def __init__(self, tol: float, stop_rule: str = "auto", patience: int = 2,
                 stall_frac: float = 0.1):
        if stop_rule not in ("gap", "stall", "auto"):
            raise ValueError(f"unknown stop_rule {stop_rule!r}")
        self.tol = tol
        # tol<=0 means "run the full budget": stall detection would trigger
        # spuriously at the fp floor, so fall back to the (unreachable) gap rule
        self.rule = stop_rule if tol > 0 else "gap"
        self.patience = patience
        self.thresh = stall_frac * tol
        self._f_best = None
        self._stall = None
        self.reason = "max_iter"

    def update(self, f_last: np.ndarray, rel_gap: np.ndarray) -> bool:
        f_last = np.atleast_1d(np.asarray(f_last, np.float64))
        rel_gap = np.atleast_1d(np.asarray(rel_gap, np.float64))
        gap_ok = rel_gap <= self.tol
        if self._stall is None:
            self._stall = np.zeros(f_last.shape, np.int64)
        if self._f_best is not None:
            new_best = np.minimum(self._f_best, f_last)
            df = (self._f_best - new_best) / np.maximum(1.0, np.abs(new_best))
            self._stall = np.where(df <= self.thresh, self._stall + 1, 0)
            self._f_best = new_best
        else:
            self._f_best = f_last
        stalled = self._stall >= self.patience
        if self.rule == "gap":
            done = gap_ok
        elif self.rule == "stall":
            done = stalled
        else:
            done = gap_ok | stalled
        if bool(np.all(done)):
            by_gap, by_stall = bool(np.all(gap_ok)), bool(np.all(stalled))
            self.reason = "gap" if by_gap else ("stall" if by_stall else "gap/stall")
            return True
        return False


def fw_gap(dp, g_flat: torch.Tensor, x_flat: torch.Tensor, gp) -> torch.Tensor:
    """Frank-Wolfe duality gap g.(x - s) on the product of (radius-scaled)
    simplices, over the last axis: (S,) for (S, n_pf) inputs.  Dummy rows
    (all-padding blocks) contribute nothing."""
    total_min = 0.0
    for g, bk in zip(gp, dp.buckets):
        valid = (bk.mask > 0).any(dim=-1)
        bm = block_min(g, bk.mask)
        total_min = total_min + torch.where(valid, bk.radius * bm, torch.zeros_like(bm)).sum(dim=-1)
    return (g_flat * x_flat).sum(dim=-1) - total_min


def _start_vector(dp: L.DeviceProblem, seed: int, v0) -> torch.Tensor:
    if v0 is not None:
        v = torch.tensor(np.asarray(v0), dtype=dp.b.dtype)  # a copy
        if v.shape != (dp.n_pf,):
            raise ValueError(f"v0 must have shape ({dp.n_pf},), got {tuple(v.shape)}")
    else:
        gen = torch.Generator(device="cpu").manual_seed(seed)
        v = torch.randn(dp.n_pf, generator=gen, dtype=dp.b.dtype)
    return v.to(dp.device)


def _power_iterate(dp, apply_m, v: torch.Tensor, iters: int) -> float:
    v = v / torch.sqrt(torch.clamp(L.xdot(dp, v, v), min=1e-30))
    lam = torch.ones((), dtype=v.dtype, device=v.device)
    for _ in range(iters):
        w = apply_m(v)
        lam = torch.sqrt(torch.clamp(L.xdot(dp, w, w), min=1e-30))
        v = w / lam
    return float(lam) * 1.05


def power_lipschitz(dp: L.DeviceProblem, iters: int = 30, seed: int = 0,
                    v0: Optional[np.ndarray] = None) -> float:
    """||A||_2^2 estimate by power iteration on A^T A (device-side).  The
    start vector is drawn from a ``torch.Generator`` seeded with ``seed``, or
    taken from ``v0`` (numpy, (n_pf,)) so that two packages can start from
    the same vector."""
    return _power_iterate(
        dp, lambda v: L.rmatvec(dp.A, L.matvec(dp.A, v)), _start_vector(dp, seed, v0), iters)


def uses_zspace(method: str, line_search: str, space: str = "x") -> bool:
    """True when the solver builds its trial point in z-space (order simplex),
    so the 1/L trial step must use the z-space curvature ||A D||^2, not
    ||A||^2 — the cumulative-sum map D inflates curvature by O(w^2)."""
    return space == "z" or (line_search == "pava" and method in ("pgd",))


def power_lipschitz_z(dp: L.DeviceProblem, iters: int = 30, seed: int = 0,
                      v0: Optional[np.ndarray] = None) -> float:
    """||A D||_2^2 estimate by power iteration on D^T A^T A D — the curvature
    of the z-parametrisation (D = per-block cumulative-sum map, ztransform)."""

    def zproject(flat):
        vp = tuple(
            torch.where(Z.zmask(bk.mask) > 0, v, torch.zeros_like(v))
            for v, bk in zip(L.flat_to_padded(dp, flat), dp.buckets)
        )
        return L.padded_to_flat(dp, vp)

    def apply_m(flat):
        dxp = tuple(
            Z.dz_forward_padded(v, bk.mask)
            for v, bk in zip(L.flat_to_padded(dp, flat), dp.buckets)
        )
        w = L.rmatvec(dp.A, L.matvec(dp.A, L.padded_to_flat(dp, dxp)))
        gzp = tuple(
            Z.dz_adjoint_padded(g, bk.mask)
            for g, bk in zip(L.flat_to_padded(dp, w), dp.buckets)
        )
        return L.padded_to_flat(dp, gzp)

    return _power_iterate(dp, apply_m, zproject(_start_vector(dp, seed, v0)), iters)


def _get_solver(method: str):
    from . import pgd

    if method == "pgd":
        return pgd
    raise NotImplementedError(
        f"method {method!r} is not ported yet (later slice: the other five "
        "solver families); this package has method='pgd'")


def _reject_unported(**given):
    """Options of ``bsls_tpu.solve`` whose part is not ported yet."""
    later = {
        "mesh": "distribution",
        "refine": "refine/certify",
        "refine_tol": "refine/certify",
        "certify": "refine/certify",
        "checkpoint_path": "checkpoint/CLI rest",
        "resume": "checkpoint/CLI rest",
    }
    for name, value in given.items():
        if value:
            raise NotImplementedError(
                f"solve({name}=...) is not ported yet (later slice: {later[name]})")


def solve(
    problem: Problem | L.DeviceProblem,
    method: str = "pgd",
    tol: float = 1e-6,
    max_iter: int = 10_000,
    chunk: int = 100,
    line_search: str = "exact",
    step_size: float = 0.0,
    space: str = "x",
    dtype=torch.float32,
    callback: Optional[Callable[[int, Any], None]] = None,
    mesh=None,
    verbose: bool = False,
    x0: Optional[np.ndarray] = None,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    metrics=None,
    stop_rule: str = "auto",
    certify: int = 0,
    lipschitz: Optional[float] = None,
    refine: int = 0,
    refine_tol: Optional[float] = None,
    device="cuda",
) -> SolveResult:
    """Solve a block-simplex LSQ instance on one device.

    Multi-RHS problems (b of shape (S, m)) solve S scenarios at once, each
    with its own step sizes and stopping state.  ``device`` is where a host
    ``Problem`` is prepared and solved ("cuda" raises when there is no card;
    pass "cpu" to run on the CPU); a ``DeviceProblem`` is solved where it
    lies.

    ``lipschitz`` skips the on-device power iteration and uses the given
    ||A||_2^2 bound (||A D||_2^2 for the z-space modes) for the 1/L trial
    step.  ``x0`` (N,) or (S, N) is a warm start in the user's ordering.
    """
    _reject_unported(mesh=mesh is not None, refine=refine, refine_tol=refine_tol is not None,
                     certify=certify, checkpoint_path=checkpoint_path, resume=resume)
    solver = _get_solver(method)
    if line_search not in _LINE_SEARCHES:
        raise ValueError(f"unknown line_search {line_search!r}; options: {_LINE_SEARCHES}")
    if space not in ("x", "z"):
        raise ValueError(f"unknown space {space!r}")
    if isinstance(problem, Problem):
        dp = L.prepare(problem, dtype=dtype, device=device)  # raises on Problem.C
    else:
        dp = problem

    opts = SolveOptions(
        method=method, line_search=line_search, tol=tol,
        max_iter=max_iter, chunk=chunk, step_size=step_size, space=space,
    )
    multi = dp.b.ndim == 2

    if lipschitz is not None:
        L_est = float(lipschitz)
    else:
        # z-space solvers need the z-parametrisation's curvature ||A D||^2
        # for their trial step, not ||A||^2 (see uses_zspace)
        power = (
            power_lipschitz_z if uses_zspace(method, line_search, space)
            else power_lipschitz
        )
        L_est = power(dp)

    xp0 = None
    if x0 is not None:
        x0t = torch.as_tensor(np.asarray(x0), dtype=dp.b.dtype).to(dp.device)
        xp0 = L.inject_user_flat(dp, x0t if multi else x0t[None])
    state = solver.init(dp, L_est, opts, xp0=xp0)

    # fused-chunk fast path (small dense single-RHS instances, opt-in; see
    # solvers/mega.py for eligibility) — produces and consumes the same
    # PGDState, so the chunk loop below is unchanged
    from .mega import make_mega_runner

    mega_run = None if multi else make_mega_runner(dp, method, opts, L_est, chunk)

    def run_chunk(st):
        st = solver.refresh(dp, st, L_est, opts)
        tf = torch.empty((st.f.shape[0], chunk), dtype=st.f.dtype, device=dp.device)
        tg = torch.empty_like(tf)
        for j in range(chunk):
            st = solver.step(dp, st, L_est, opts)
            tf[:, j] = st.f
            tg[:, j] = st.gap
        return st, (tf, tg)

    run = mega_run if mega_run is not None else run_chunk

    # Chunk loop: K steps enqueued without a host sync, then ONE readback of
    # the end-of-chunk (f, gap), which is also what closes the chunk's wall
    # time.  The per-step traces stay on the device until the end.
    traces_f, traces_g, ctimes, citers = [], [], [], []
    converged = False
    stopper = StopTracker(tol, stop_rule)
    it = 0
    if dp.device.type == "cuda":
        torch.cuda.synchronize(dp.device)
    t0 = time.perf_counter()
    while it < max_iter:
        state, (tf, tg) = run(state)
        it += chunk
        traces_f.append(tf)
        traces_g.append(tg)
        citers.append(it)
        fg = torch.stack([state.f, state.gap]).cpu().numpy()  # the one readback
        t1 = time.perf_counter()
        ctimes.append(t1 - t0)
        t0 = t1
        f_last = fg[0] if multi else fg[0, 0]
        gap_last = fg[1] if multi else fg[1, 0]
        rel = gap_last / np.maximum(1.0, np.abs(f_last))
        if metrics is not None:
            metrics.log(
                "chunk", iteration=it, f=f_last.tolist(), relgap=rel.tolist(),
                secs=ctimes[-1],
            )
        if callback is not None:
            callback(it, state)
        if verbose:
            print(f"iter {it}: f={f_last} relgap={rel}")
        if stopper.update(f_last, rel):
            converged = True
            break

    if traces_f:
        trace_f = torch.cat(traces_f, dim=1).cpu().numpy()
        trace_gap = torch.cat(traces_g, dim=1).cpu().numpy()
    else:  # max_iter <= 0: nothing ran
        trace_f = trace_gap = np.zeros((state.f.shape[0], 0), np.float32)
    # one final exact projection: guarantees feasibility of the returned x
    # regardless of method (the z-space path can leave O(eps) negative
    # entries after the z->x difference map)
    xp = proj_blocks(state.xp, dp.buckets)
    x = L.extract_user_flat(dp, xp).cpu().numpy()
    f = state.f.cpu().numpy()
    gap = state.gap.cpu().numpy()
    if not multi:
        x, f, gap, trace_f, trace_gap = x[0], f[0], gap[0], trace_f[0], trace_gap[0]
    return SolveResult(
        x=x,
        objective=f,
        gap=gap,
        iterations=it,
        converged=converged,
        trace_f=trace_f,
        trace_gap=trace_gap,
        chunk_times=np.asarray(ctimes),
        chunk_iters=np.asarray(citers),
        stop_reason=stopper.reason,
    )
