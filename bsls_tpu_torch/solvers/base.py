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
the host inside a chunk, and keep every field of their state on the device:
on a CUDA device a chunk is one captured CUDA graph, cached across calls by
the reference's key (``solvers/graph.py``, the counterpart of the
reference's compiled chunk), and replayed once a chunk; on the CPU the
chunk runs eagerly (``make_chunk_runner``).

Iterations use an *incremental residual* (r += t * A d), so PGD costs two
matvec-equivalents per iteration; ``refresh`` recomputes r exactly at every
chunk boundary to stop fp drift.

With ``BSLS_MEGA=1`` a chunk of an eligible solve is one launch of the
fused-chunk kernel (``solvers/mega.py``).

After the main solve, ``certify=K`` runs K pairwise-FW steps from the final
iterate, and ``refine=K`` / ``refine_tol=`` polish the result against a
float64 anchor on the host (``refine_polish``; its correction is a batched
fp32 CG on the device, or a float64 Jacobi-PCG on the host).

``route`` decides once where a solve runs, for ``solve`` and
``parallel.solve_sharded``.  A ``Problem`` with equality constraints (``C``)
goes to the augmented-Lagrangian loop of ``solvers/eq_constrained.py``,
whose inner solves are ``solve_on`` on the stacked operator [A; sqrt(rho)
C].  Everything else runs ``solve_on``, one body for a placement:
``OneCard``, or with ``mesh=`` (``parallel.make_mesh``) a
``parallel/sharding.py::MeshPlacement``, every rank of a
``torch.distributed`` mesh on its own slice of the problem; every
cross-shard reduction of a step goes through the collective products and
inner products of ``ops/layout.py``.

Counterpart of ``bsls_tpu/solvers/base.py`` for all six solver families
(``_get_solver``), certify, refine, checkpoint/resume, and the
unconstrained and the equality-constrained solve on one device and on a
mesh.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.problem import Problem
from ..ops import cudalib
from ..ops import layout as L
from ..ops import ztransform as Z
from ..ops.projection import proj_blocks
from ..ops.simplex import fw_gap
from ..utils.checkpoint import resume_state, save_state
from ..utils.profiling import span

PAIRWISE = ("afw", "pairwise", "pairwise_fw")

__all__ = [
    "SolveOptions", "SolveResult", "StopTracker", "fw_gap", "power_lipschitz",
    "power_lipschitz_z", "uses_zspace", "refine_polish", "refine_rounds", "solve",
]

# refine_tol without refine: the certified polish runs with this round cap
DEFAULT_REFINE_ROUNDS = 16


@dataclass(frozen=True)
class SolveOptions:
    """Static solver options."""

    method: str = "pgd"  # pgd | apgd | lbfgs | eg | frank_wolfe | afw
    line_search: str = "exact"  # exact | bb | bbm | fixed | pava
    tol: float = 1e-6  # relative FW-gap tolerance: gap <= tol * max(1, |f|)
    max_iter: int = 10_000
    chunk: int = 100  # iterations between host readbacks
    step_size: float = 0.0  # fixed step (0 -> 1/L from power iteration)
    space: str = "x"  # x | z  (z-space PGD/L-BFGS project with PAVA)
    lbfgs_mem: int = 8  # curvature-pair memory depth (method="lbfgs")


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
    refine_secs: float = 0.0  # wall seconds spent in refine_polish (refine=K)
    # float64 FW duality-gap certificate of the polished iterate, relative
    # (gap / max(1, |f|), worst scenario): f - f* <= refine_fw_gap is SOUND
    # with no oracle.  Set by refine_polish when target_rel_gap is given.
    refine_fw_gap: Optional[float] = None
    # equality-constrained solves (solvers/eq_constrained.py): relative
    # ||Cx - d||_inf / max(1, ||d||_inf) of the worst scenario, and the final
    # augmented-Lagrangian state (multipliers (p,) or (S, p), penalty)
    eq_violation: Optional[float] = None
    eq_lam: Optional[np.ndarray] = None
    eq_rho: Optional[float] = None
    # host seconds by phase, from the request's ``bsls.*`` spans
    # (utils/profiling.py::span), and its counts (chunks, graph captures;
    # outers of an eq solve; a queued request's batch width and padded width)
    phases: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

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

    def time_to_gap(self, f_star, rel: float = 1e-6) -> float | None:
        """Wall seconds until f <= f* + rel*max(1,|f*|), from the chunk trace.
        For a multi-RHS trace every scenario must be there; ``f_star`` is one
        value for all or one per scenario, (S,)."""
        f_star = np.asarray(f_star, np.float64)
        thresh = f_star + rel * np.maximum(1.0, np.abs(f_star))
        if self.trace_f.ndim == 1:
            ok = self.trace_f <= thresh
        else:
            ok = np.all(self.trace_f <= np.reshape(thresh, (-1, 1)), axis=0)
        hits = np.nonzero(ok)[0]
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


def _start_vector(dp: L.DeviceProblem, seed: int, v0) -> torch.Tensor:
    if v0 is not None:
        v = torch.tensor(np.asarray(v0), dtype=dp.b.dtype)  # a copy
        if v.shape != (dp.n_pf,):
            raise ValueError(f"v0 must have shape ({dp.n_pf},), got {tuple(v.shape)}")
        return v.to(dp.device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    if not dp.sharded:
        return torch.randn(dp.n_pf, generator=gen, dtype=dp.b.dtype).to(dp.device)
    # a sharded problem: every rank takes its slice of ONE global vector,
    # drawn in the user's column order (padding slots 0), so that the
    # estimate does not depend on the mesh shape
    u = torch.randn(dp.n_user, generator=gen, dtype=dp.b.dtype).to(dp.device)
    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    return torch.where(dp.perm >= 0, u[dp.perm.clamp(min=0).long()], zero)


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
    """||A||_2^2 estimate by power iteration on A^T A (device-side,
    collective on a sharded problem).  The start vector is drawn from a
    ``torch.Generator`` seeded with ``seed``, or taken from ``v0`` (numpy,
    (n_pf,)) so that two packages can start from the same vector."""
    return _power_iterate(
        dp, lambda v: L.rmatvec_ps(dp, L.matvec_ps(dp, v)), _start_vector(dp, seed, v0), iters)


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
        w = L.rmatvec_ps(dp, L.matvec_ps(dp, L.padded_to_flat(dp, dxp)))
        gzp = tuple(
            Z.dz_adjoint_padded(g, bk.mask)
            for g, bk in zip(L.flat_to_padded(dp, w), dp.buckets)
        )
        return L.padded_to_flat(dp, gzp)

    return _power_iterate(dp, apply_m, zproject(_start_vector(dp, seed, v0)), iters)


def _get_solver(method: str):
    from . import apgd, frank_wolfe, lbfgs, mirror_descent, pgd

    table = {
        "pgd": pgd,
        "apgd": apgd,
        "fista": apgd,
        "lbfgs": lbfgs,
        "eg": mirror_descent,
        "mirror_descent": mirror_descent,
        "frank_wolfe": frank_wolfe,
        "fw": frank_wolfe,
        "afw": frank_wolfe,
        "pairwise": frank_wolfe,
        "pairwise_fw": frank_wolfe,
    }
    if method not in table:
        raise KeyError(f"unknown method {method!r}; options: {sorted(table)}")
    return table[method]


def _warm_up(device: torch.device, first_launch: Callable[[], Any]):
    """Load the kernel library (building it with nvcc when it is stale) and
    make the path's first launches, before the chunk clock starts: a fresh
    process would otherwise book the load, the first launch of every kernel
    (the fused chunk's first cooperative launch among them) and the first
    launch of every torch operation into ``chunk_times[0]``, and through it
    into ``time_to_gap``.  ``first_launch`` makes the chunk's runner
    (``chunk_program``: on the card the capture of its graph, which runs one
    throwaway step first) or runs one fused chunk whose result is dropped;
    its result is returned.  No fallback: a library that does not load
    raises here."""
    if device.type == "cuda":
        cudalib.load()
    out = first_launch()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out


def _polish_cg(dp, free_pf: torch.Tensor, g0t_pf: torch.Tensor, iters: int) -> torch.Tensor:
    """CG on the tangent-subspace normal equations, one per scenario:
    min_d 1/2||A d + r0||^2 over d in T = {per-block free coords, zero-sum} —
    operator H = P A^T A P, rhs = -P g0 (P = tangent projection).  ``free_pf``
    and ``g0t_pf`` are (S, n_pf); every CG scalar is (S,).  Everything stays
    fp32 at DELTA scale, which is the point: the correction d is O(gap)
    small, so fp32 resolves it to ~1e-7 RELATIVE to the gap, not to ||x||.
    The reference vmaps this over scenarios; here it is batched directly."""
    freep = L.flat_to_padded(dp, free_pf)
    zero = torch.zeros((), dtype=g0t_pf.dtype, device=g0t_pf.device)

    def proj(v_flat):
        outs = []
        for v, f in zip(L.flat_to_padded(dp, v_flat), freep):
            cnt = f.sum(dim=-1, keepdim=True)
            mean = (v * f).sum(dim=-1, keepdim=True) / torch.clamp(cnt, min=1.0)
            outs.append(torch.where(f > 0, v - mean, zero))
        return L.padded_to_flat(dp, outs)

    b = proj(-g0t_pf)
    d, rr, p = torch.zeros_like(b), b, b
    rs = L.xdot(dp, b, b)
    for _ in range(iters):
        hp = proj(L.rmatvec(dp.A, L.matvec(dp.A, p)))
        denom = L.xdot(dp, p, hp)
        alpha = torch.where(denom > 1e-30, rs / denom, zero)
        d = d + alpha[:, None] * p
        rr = rr - alpha[:, None] * hp
        rs_new = L.xdot(dp, rr, rr)
        beta = torch.where(rs > 1e-30, rs_new / rs, zero)
        p = rr + beta[:, None] * p
        rs = rs_new
    return d


def refine_polish(problem: Problem, dp, res: SolveResult, rounds: int = 3,
                  cg_iters: int = 30,
                  target_rel_gap: float | None = None) -> SolveResult:
    """Active-set tangent-space polish (fp32 iterative refinement).

    fp32 floors the true (f64-evaluated) relative objective gap at ~2e-6
    to ~1e-5 on medium-scale instances — not because the solvers stall but
    because near the optimum every fp32 update smaller than eps*|x| rounds
    away.  The polish solves for the CORRECTION instead, per round:

      1. anchor in f64 on the host: r0 = A x - b, g0 = A^T r0;
      2. free set = {x > 0} plus pinned coords whose reduced gradient
         wants them positive (multiplier release test);
      3. truncated CG on the tangent-subspace normal equations ON DEVICE
         (fp32 at DELTA scale; the subspace projection is a per-block
         masked mean — no simplex projection in the loop);
      4. backtracked clipped step chosen by the f64 host objective
         (t = 1, 1/2, ... — first improvement wins), clip + renormalise
         in f64.

    A wrong active set or an already-optimal x degrades to a no-op (the
    backtracking accepts only f64-objective improvements).  Rounds after
    convergence are cheap no-ops (first rejected backtrack exits).

    ``target_rel_gap``: certified adaptive mode.  Each round's f64 anchor
    already pays for the gradient, so the float64 Frank-Wolfe duality gap
    (a SOUND bound: f - f* <= gap, no oracle needed) is computed for free;
    the polish stops as soon as every scenario's gap / max(1, |f|) is at
    or below the target, and the certificate ships on the result as
    ``refine_fw_gap`` (worst scenario).  ``rounds`` becomes the cap.
    Certified mode corrects with a float64 Jacobi-PCG on the host, which is
    what makes the certificate tight; ``BSLS_REFINE_HOST=1`` takes that
    path for plain refine too, and ``dp=None`` means there is no device
    problem (host only).  ``BSLS_REFINE_TRACE=1`` prints a line per round.

    Counterpart of ``bsls_tpu/solvers/base.py::refine_polish``: the host
    code is the reference's; the device CG is ``_polish_cg`` batched over S.
    """
    t_start = time.perf_counter()
    from ..models.oracle import _fast_operator, fw_gap_np as _fwgap

    op = _fast_operator(problem.A)  # CSR matvecs: the EllMatrix host
    # bincount path is ~10x slower and the polish does hundreds of them

    def _mm(Xm):  # (S, n) -> (S, m)
        if hasattr(op, "matmat"):
            return op.matmat(Xm)
        return np.stack([op.matvec(v) for v in Xm])

    def _rmm(Rm):  # (S, m) -> (S, n)
        if hasattr(op, "rmatmat"):
            return op.rmatmat(Rm)
        return np.stack([op.rmatvec(v) for v in Rm])

    part = problem.partition
    sizes = part.sizes
    offsets = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    multi = np.asarray(res.x).ndim == 2

    def repair(V):  # (S, N) or (N,): clip + per-block renormalise in f64
        V = np.maximum(V, 0.0)
        s = np.add.reduceat(V, offsets, axis=-1)
        return V / np.repeat(np.maximum(s, 1e-300), sizes, axis=-1)

    X = repair(np.atleast_2d(np.asarray(res.x, np.float64)))
    B = np.atleast_2d(np.asarray(problem.b, np.float64))
    S = X.shape[0]

    def obj_s(v, s):
        r = op.matvec(v) - B[s]
        return 0.5 * float(r @ r)

    F = np.array([obj_s(X[s], s) for s in range(S)])
    it_extra = 0
    use_host = (dp is None or target_rel_gap is not None
                or os.environ.get("BSLS_REFINE_HOST") == "1")
    if dp is not None:
        perm_h = dp.perm.cpu().numpy()
        sel = perm_h >= 0
    if use_host:
        from ..ops.layout import _col_norms_sq
        from ..utils.hostops import host_matmat_ops

        _coln = _col_norms_sq(problem.A)  # diag(A^T A): Jacobi preconditioner
        _nat = host_matmat_ops(problem.A)  # OpenMP SpMM (scipy fallback)
        if _nat is not None:
            _mm, _rmm = _nat
    cert = None  # f64 FW-gap certificate of the CURRENT X (relative, worst s)

    # certified mode needs enough CG to resolve the face: 30 device
    # iterations suffice for the 1e-12 objective but not for a tight
    # certificate, and when a round's steps are all rejected the budget
    # escalates (doubling, capped) instead of giving up — the remaining
    # FW gap lives in near-null face directions that barely move f.
    cg_now = cg_iters if target_rel_gap is None else max(cg_iters, 200)
    cg_cap = max(cg_now, 1600)
    # per-scenario convergence mask: certified scenarios drop out of the
    # host PCG and step phases
    active = np.ones(S, bool)
    # incremental anchors: a scenario's f64 anchor pair (r0, g0) and
    # certificate only change when a step moved ITS iterate, so
    # frozen/rejected scenarios keep last round's
    G0 = np.zeros_like(X)
    certv = np.full(S, np.inf)
    stale = np.ones(S, bool)
    _rtrace = os.environ.get("BSLS_REFINE_TRACE") == "1"
    for _round_i in range(rounds):
        _t_round = time.perf_counter()
        idxn = np.nonzero(stale)[0]
        if idxn.size:
            G0[idxn] = _rmm(_mm(X[idxn]) - B[idxn])
            stale[idxn] = False
        g0 = G0
        if target_rel_gap is not None:
            for s in idxn:
                # two sound bounds on F[s] - f*: the f64 FW duality gap,
                # and F[s] itself (least squares: f* >= 0)
                certv[s] = (min(_fwgap(G0[s], X[s], sizes), F[s])
                            / max(1.0, abs(F[s])))
            cert = float(certv.max())
            active = certv > target_rel_gap
            if not active.any():
                break
        free = (X > 1e-12).astype(np.float64)
        cnt = np.maximum(np.add.reduceat(free, offsets, axis=-1), 1.0)
        lam = np.repeat(np.add.reduceat(g0 * free, offsets, axis=-1) / cnt,
                        sizes, axis=-1)
        free = np.maximum(
            free, ((free == 0) & (g0 < lam - 1e-12)).astype(np.float64))
        # tangent-project g0 in f64 BEFORE the fp32 cast: the cast error
        # then scales with the remaining optimality gap, not with ||g||
        cnt = np.maximum(np.add.reduceat(free, offsets, axis=-1), 1.0)
        gsum = np.add.reduceat(g0 * free, offsets, axis=-1)
        g0t = (g0 - np.repeat(gsum / cnt, sizes, axis=-1)) * free
        if use_host:
            # host float64 Jacobi-PCG on the same tangent-subspace normal
            # equations (P A^T A P d = -P g0), batched over the active
            # scenarios with per-scenario CG scalars.  f64 throughout, so
            # the correction is exact to the face; the diag(A^T A)
            # preconditioner is what lets refine_tol certify.
            idx = np.nonzero(active)[0]
            freea, cnta, g0ta = free[idx], cnt[idx], g0t[idx]

            def tproj(V):
                V = V * freea
                sm = np.add.reduceat(V, offsets, axis=-1)
                return (V - np.repeat(sm / cnta, sizes, axis=-1)) * freea

            Minv = freea / np.maximum(_coln[None, :], 1e-30)

            def prec(V):
                # V (the CG residual) stays in the tangent space by the
                # projected-CG invariants: one projection after the scaling
                return tproj(Minv * V)

            Da = np.zeros_like(g0ta)
            R = -g0ta  # g0t = P g0 already
            Z = prec(R)
            Pd = Z.copy()
            rz = np.einsum("sn,sn->s", R, Z)
            rz0 = rz.copy()
            for _ in range(cg_now):
                if float(np.max(rz / np.maximum(rz0, 1e-300))) <= 1e-28:
                    break
                HP = tproj(_rmm(_mm(Pd)))
                den = np.einsum("sn,sn->s", Pd, HP)
                alpha = np.where(den > 1e-300, rz / np.maximum(den, 1e-300), 0.0)
                Da += alpha[:, None] * Pd
                R -= alpha[:, None] * HP
                Z = prec(R)
                rz_new = np.einsum("sn,sn->s", R, Z)
                beta = np.where(rz > 1e-300, rz_new / np.maximum(rz, 1e-300), 0.0)
                Pd = Z + beta[:, None] * Pd
                rz = rz_new
            D = np.zeros_like(g0t)
            D[idx] = Da
        else:
            dev, dt = dp.device, dp.b.dtype
            free_pf = np.where(sel[None], free[:, np.maximum(perm_h, 0)], 0.0)
            g0t_pf = L.inject_user_grad(dp, torch.as_tensor(g0t, dtype=dt).to(dev))
            d_pf = _polish_cg(dp, torch.as_tensor(free_pf, dtype=dt).to(dev), g0t_pf,
                              cg_iters)
            D = L.extract_user_flat(dp, L.flat_to_padded(dp, d_pf)).double().cpu().numpy()
        it_extra += cg_now if use_host else cg_iters
        # per-scenario backtracked clipped step, f64 objective decides
        any_accepted = False
        for s in range(S):
            if not active[s]:
                continue  # already certified: frozen
            t = 1.0
            for _k in range(24):
                xc = repair(X[s] + t * D[s])
                fc = obj_s(xc, s)
                if fc < F[s]:
                    X[s], F[s] = xc, fc
                    any_accepted = True
                    stale[s] = True  # anchor + certificate now outdated
                    break
                t *= 0.5
        if not any_accepted:
            if (target_rel_gap is not None and cert is not None
                    and cert > target_rel_gap and cg_now < cg_cap):
                cg_now = min(2 * cg_now, cg_cap)
                continue
            break
        if _rtrace:
            print(f"[refine] round={_round_i} active={int(active.sum())}"
                  f"/{S} cg={cg_now} cert={cert} "
                  f"secs={time.perf_counter() - _t_round:.2f}", flush=True)
    if target_rel_gap is not None:
        # certify the final iterate: refresh only moved scenarios' anchors
        idxn = np.nonzero(stale)[0]
        if idxn.size:
            G0[idxn] = _rmm(_mm(X[idxn]) - B[idxn])
            for s in idxn:
                certv[s] = (min(_fwgap(G0[s], X[s], sizes), F[s])
                            / max(1.0, abs(F[s])))
        cert = float(certv.max())
    return SolveResult(
        x=X if multi else X[0],
        objective=np.asarray(F if multi else F[0]),
        gap=res.gap,
        iterations=res.iterations + it_extra,
        converged=res.converged,
        trace_f=res.trace_f,
        trace_gap=res.trace_gap,
        chunk_times=res.chunk_times,
        chunk_iters=res.chunk_iters,
        stop_reason=res.stop_reason,
        refine_secs=time.perf_counter() - t_start,
        refine_fw_gap=cert,
        phases=res.phases,
        counts=res.counts,
    )


def lipschitz_tensor(L_est, device) -> torch.Tensor:
    """L as the float64 0-d tensor on ``device`` that a chunk's steps read."""
    if isinstance(L_est, torch.Tensor):
        return L_est.to(device=device, dtype=torch.float64)
    return torch.full((), float(L_est), dtype=torch.float64, device=device)


def make_chunk_runner(dp, solver, opts, L_est, steps: int):
    """run(state) -> (state, (trace_f, trace_gap)): ``steps`` solver steps
    after an exact residual refresh, the per-step traces (S, steps) left on
    the device.  The eager runner: one launch at a time.  ``L_est`` (a float
    or a 0-d tensor) reaches the steps as a float64 0-d tensor, as in the
    captured chunk (``solvers/graph.py``), so that both take the same
    operations."""
    L_est = lipschitz_tensor(L_est, dp.device)

    def run(st):
        st = solver.refresh(dp, st, L_est, opts)
        tf = torch.empty((st.f.shape[0], steps), dtype=st.f.dtype, device=dp.device)
        tg = torch.empty_like(tf)
        for j in range(steps):
            st = solver.step(dp, st, L_est, opts)
            tf[:, j] = st.f
            tg[:, j] = st.gap
        return st, (tf, tg)

    return run


def chunk_program(dp, solver, opts, L_est, steps: int, state):
    """The chunk runner of a solve, made before its clock starts.  On a CUDA
    device: the cached CUDA graph of the chunk (``solvers/graph.py``, the
    counterpart of the reference's compiled chunk), captured now when its
    key is new.  On the CPU, and on a mesh rank (whose chunk is not captured
    yet): the eager runner, after one throwaway step from ``state``.  The
    device's type alone decides; nothing falls back."""
    if dp.device.type == "cuda" and not dp.sharded:
        from .graph import graph_runner

        return graph_runner(dp, solver, opts, L_est, steps, state)
    solver.step(dp, state, L_est, opts)
    return make_chunk_runner(dp, solver, opts, L_est, steps)


@dataclass
class ChunkLoop:
    """What ``run_chunk_loop`` hands back."""

    state: Any
    iterations: int
    converged: bool
    stopper: StopTracker
    traces_f: list  # per chunk, (S, chunk) on the device
    traces_g: list
    chunk_times: list
    chunk_iters: list


def run_chunk_loop(run, state, it: int, max_iter: int, chunk: int, tol: float, stop_rule: str,
                   device: torch.device, readback: Callable[[Any], np.ndarray],
                   after_chunk: Optional[Callable] = None) -> ChunkLoop:
    """The chunk loop of ``solve_on``: K steps enqueued
    without a host sync, then ONE readback of the end-of-chunk (f, gap) —
    ``readback(state)`` returns them as a (2, S) array of every scenario —
    which is also what closes the chunk's wall time.  The per-step traces
    stay on the device until the end.  ``after_chunk(it, chunks_done, state,
    f, rel_gap, secs)`` runs after each readback, before the stop decision.
    On a mesh every rank sees the same (2, S) stats and so stops at the same
    chunk.  The loop is the span ``bsls.chunks`` and each chunk (its launch
    and its readback) the span ``bsls.chunk``, whose seconds are the chunk's
    ``chunk_times`` entry."""
    traces_f, traces_g, ctimes, citers = [], [], [], []
    converged = False
    stopper = StopTracker(tol, stop_rule)
    chunks_done = 0
    with span("chunks"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        while it < max_iter:
            with span("chunk") as one:
                state, (tf, tg) = run(state)
                fg = readback(state)  # the one readback
            it += chunk
            chunks_done += 1
            traces_f.append(tf)
            traces_g.append(tg)
            citers.append(it)
            ctimes.append(one.secs)
            rel = fg[1] / np.maximum(1.0, np.abs(fg[0]))
            if after_chunk is not None:
                after_chunk(it, chunks_done, state, fg[0], rel, ctimes[-1])
            if stopper.update(fg[0], rel):
                converged = True
                break
    return ChunkLoop(state, it, converged, stopper, traces_f, traces_g, ctimes, citers)


def refine_rounds(refine, refine_tol) -> int:
    """The polish's round cap: ``refine``, or ``DEFAULT_REFINE_ROUNDS``
    where ``refine_tol`` is given alone (certified mode must not skip the
    polish)."""
    if refine_tol is not None and not refine:
        return DEFAULT_REFINE_ROUNDS
    return int(refine or 0)


@dataclass
class OneCard:
    """Where a solve runs, one device: what ``solve_on`` asks of its
    placement.  ``parallel/sharding.py::MeshPlacement`` answers the same
    questions for a mesh.  ``keep_x`` leaves the result's x on the device,
    as a tensor in the solve's dtype (the equality-constrained loop hands it
    to its next inner solve)."""

    dp: L.DeviceProblem
    keep_x: bool = False
    mesh = None
    leader = True  # writes the records and the log lines

    @property
    def multi(self) -> bool:
        return self.dp.b.ndim == 2

    @property
    def squeeze(self) -> bool:  # one RHS: the traces and records lose the scenario axis
        return not self.multi

    @property
    def refine_dp(self):  # the polish's device CG runs here
        return self.dp

    def inject(self, x0) -> tuple:
        """A user-flat warm start, (N,) or (S, N), numpy or a tensor on any
        device, cast to the solve's dtype and moved to its device."""
        dp = self.dp
        if isinstance(x0, torch.Tensor):
            x0t = x0.to(device=dp.device, dtype=dp.b.dtype)
        else:
            x0t = torch.as_tensor(np.asarray(x0), dtype=dp.b.dtype).to(dp.device)
        return L.inject_user_flat(dp, x0t if self.multi else x0t[None])

    def host(self, t: torch.Tensor, dim: int = 0) -> np.ndarray:
        """A per-scenario tensor, whole, on the host."""
        return t.cpu().numpy()

    def extract(self, xp) -> np.ndarray | torch.Tensor:
        x = L.extract_user_flat(self.dp, xp)
        return x if self.keep_x else x.cpu().numpy()

    def check(self, callback, space: str, certify: int) -> None:
        """Every option of ``solve`` runs on one device."""

    def shard(self, state) -> None:
        """A checkpoint of one process: no shard."""
        return None


def place_problem(problem, mesh=None, shard_rows: bool = False, layout: str = "auto",
                  device="cuda", dtype=torch.float32, keep_x: bool = False):
    """Where a solve of ``problem`` runs: on ``mesh``, this rank's slice of
    it (``parallel/sharding.py::placement``, which gathers x on the host);
    else one device, where a host ``Problem`` is prepared (``keep_x``: see
    ``OneCard``)."""
    if mesh is not None:
        from ..parallel.sharding import placement

        return placement(problem, mesh, dtype=dtype, layout=layout, shard_rows=shard_rows)
    if shard_rows:
        raise ValueError("shard_rows=True needs a mesh")
    if isinstance(problem, Problem):
        problem = L.prepare(problem, dtype=dtype, layout=layout, device=device)
    return OneCard(problem, keep_x=keep_x)


# solve()'s options that the augmented-Lagrangian loop does not take, at the
# values it runs with
EQ_REJECTS = dict(space="x", callback=None, certify=0, lipschitz=None, stop_rule="auto",
                  layout="auto", verbose=False)


def route(problem, mesh=None, shard_rows: bool = False, layout: str = "auto", device="cuda",
          dtype=torch.float32, **kw) -> SolveResult:
    """Where a solve runs, decided once for ``solve`` and
    ``parallel.solve_sharded``: a host ``Problem`` with ``C`` goes to the
    augmented-Lagrangian loop (``EQ_REJECTS`` refused); anything else to
    ``solve_on`` at its ``place_problem``, with ``refine_rounds`` of the
    polish."""
    if isinstance(problem, Problem) and problem.C is not None:
        from .eq_constrained import solve_equality_constrained

        kw["layout"] = layout
        bad = [k for k, v in EQ_REJECTS.items() if kw.pop(k, v) != v]
        if bad:
            raise ValueError(
                f"equality-constrained solve does not support {bad}; run the AL loop "
                "manually via solvers.eq_constrained if needed")
        return solve_equality_constrained(problem, mesh=mesh, shard_rows=shard_rows,
                                          device=device, dtype=dtype, **kw)
    host = problem if isinstance(problem, Problem) else None
    kw["refine"] = refine_rounds(kw.get("refine"), kw.get("refine_tol"))
    if kw["refine"] > 0 and host is None:
        raise ValueError(
            "refine requires a host Problem (the correction anchor is re-evaluated in "
            "float64 on the host); pass the Problem, not a prepared or pre-sharded one")
    _check_options(kw.get("method", "pgd"), kw.get("line_search", "exact"), kw.get("space", "x"))
    place = place_problem(problem, mesh, shard_rows, layout, device, dtype)
    return solve_on(place, host, **kw)


def _check_options(method: str, line_search: str, space: str):
    """The solver module of ``method``; raises on an unknown method, line
    search or space."""
    solver = _get_solver(method)
    if line_search not in _LINE_SEARCHES:
        raise ValueError(f"unknown line_search {line_search!r}; options: {_LINE_SEARCHES}")
    if space not in ("x", "z"):
        raise ValueError(f"unknown space {space!r}")
    return solver


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
    x0: Optional[np.ndarray | torch.Tensor] = None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    checkpoint_keep: int = 0,
    resume: bool = False,
    metrics=None,
    stop_rule: str = "auto",
    certify: int = 0,
    lipschitz: Optional[float] = None,
    lbfgs_mem: int = 8,
    refine: int = 0,
    refine_tol: Optional[float] = None,
    device="cuda",
    layout: str = "auto",
    shard_rows: bool = False,
) -> SolveResult:
    """Solve a block-simplex LSQ instance on one device, or on a mesh.

    Multi-RHS problems (b of shape (S, m)) solve S scenarios at once, each
    with its own step sizes and stopping state.  ``device`` is where a host
    ``Problem`` is prepared and solved ("cuda" raises when there is no card;
    pass "cpu" to run on the CPU); a ``DeviceProblem`` is solved where it
    lies.  ``layout`` is ``prepare``'s for a host ``Problem``.

    ``mesh`` (``parallel.make_mesh``) solves on every rank of the mesh, on
    the mesh's devices: each rank calls ``solve`` with the same host
    ``Problem`` and gets the full result (``parallel.solve_sharded``;
    ``shard_rows=True`` shards A's rows instead of its columns).  There
    ``callback``, ``space="z"`` and ``certify`` raise, and ``refine`` polishes
    the gathered result on the host.

    ``lipschitz`` skips the on-device power iteration and uses the given
    ||A||_2^2 bound (||A D||_2^2 for the z-space modes) for the 1/L trial
    step.  ``x0`` (N,) or (S, N) is a warm start in the user's ordering: a
    numpy array, or a tensor (on any device), cast to the solve's dtype and
    moved to its device as the array would be.

    ``certify=K`` runs K pairwise-FW polish steps after the main solve to
    tighten the duality-gap certificate; the polished state replaces the
    main one only if EVERY scenario's objective is no worse (+1e-12), and the
    returned ``gap`` is then the pairwise-FW gap.

    ``refine=K`` runs K active-set tangent-space polish rounds after the main
    solve (needs a host ``Problem``): see ``refine_polish``.  The returned
    ``x`` is float64 and ``objective`` is its f64 value.  ``refine_tol``
    makes the polish adaptive and certified (``refine`` caps the rounds;
    given alone, the cap is ``DEFAULT_REFINE_ROUNDS``), and the certificate
    is returned as ``res.refine_fw_gap``.

    ``checkpoint_path`` with ``checkpoint_every=K`` saves the solver state
    (``utils/checkpoint.py``) after every K-th chunk's readback and once at
    the end; ``checkpoint_keep=N`` keeps the newest N iteration-stamped
    files.  ``resume=True`` loads the latest checkpoint into the freshly
    initialised state and continues from its iteration; a checkpoint at or
    past ``max_iter`` comes back as it is.  The stop rule's history is not
    checkpointed.

    A host ``Problem`` with equality constraints (``C``, ``d``) runs the
    augmented-Lagrangian loop (``solve_equality_constrained``): ``max_iter``
    is then its total inner budget, ``refine``/``refine_tol`` its float64
    finishing outers and certified polish, the checkpoint options act per
    outer iteration, and the result carries ``eq_violation``, ``eq_lam`` and
    ``eq_rho``; with ``mesh`` (and ``shard_rows``) its inner solves run on the
    mesh.  The options of ``EQ_REJECTS`` are rejected there.
    """
    return route(**locals())  # every option above, by name


def solve_on(
    place,
    problem: Optional[Problem] = None,
    method: str = "pgd",
    tol: float = 1e-6,
    max_iter: int = 10_000,
    chunk: int = 100,
    line_search: str = "exact",
    step_size: float = 0.0,
    space: str = "x",
    callback: Optional[Callable[[int, Any], None]] = None,
    verbose: bool = False,
    x0=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,
    checkpoint_keep: int = 0,
    resume: bool = False,
    metrics=None,
    stop_rule: str = "auto",
    certify: int = 0,
    lipschitz: Optional[float] = None,
    lbfgs_mem: int = 8,
    refine: int = 0,
    refine_tol: Optional[float] = None,
) -> SolveResult:
    """The solve on a prepared problem, one body for one device and a mesh:
    power iteration, init, resume, warm-up, the chunk loop, certify, the
    result and refine.  ``place`` (``OneCard``, or
    ``parallel/sharding.py::MeshPlacement``) holds the problem and answers
    what differs: how x0 goes in, how per-scenario tensors and x come back to
    the host, the checkpoint's shard and resume, and which rank writes the
    records.  ``problem`` is the host ``Problem`` that ``refine`` rounds
    (``refine_rounds``: the caller's) polish against.  The options are
    ``solve``'s."""
    dp = place.dp
    solver = _check_options(method, line_search, space)
    place.check(callback, space, certify)
    if refine > 0 and place.keep_x:
        raise ValueError("keep_x does not combine with refine, whose x is a host array")
    opts = SolveOptions(
        method=method, line_search=line_search, tol=tol,
        max_iter=max_iter, chunk=chunk, step_size=step_size, space=space,
        lbfgs_mem=lbfgs_mem,
    )
    # host seconds of the phases between the syncs the solve makes anyway
    # (the power iteration's readback, the warm-up's synchronise, each
    # chunk's readback, the result's), and what it counted; the layout's
    # static counts come with it
    phases: dict = {}
    counts = {"chunks": 0, "captures": 0, **L.gather_counts(dp.A)}

    if lipschitz is not None:
        L_est = float(lipschitz)
    else:
        # z-space solvers need the z-parametrisation's curvature ||A D||^2
        # for their trial step, not ||A||^2 (see uses_zspace)
        power = (
            power_lipschitz_z if uses_zspace(method, line_search, space)
            else power_lipschitz
        )
        with span("power", phases):
            L_est = power(dp)

    with span("init", phases):
        xp0 = None if x0 is None else place.inject(x0)
        state = solver.init(dp, L_est, opts, xp0=xp0)

        # fused-chunk fast path (small dense single-RHS instances, opt-in;
        # see solvers/mega.py for eligibility) — produces and consumes the
        # same PGDState, so the chunk loop below is unchanged
        from .mega import make_mega_runner

        mega_run = None if dp.b.ndim == 2 else make_mega_runner(dp, method, opts, L_est, chunk)
        it = 0
        if resume and checkpoint_path:
            state, meta = resume_state(checkpoint_path, state, place.shard(state))
            it = int(meta.get("iteration", 0))
        run = mega_run
        if it < max_iter:
            if mega_run is not None:
                _warm_up(dp.device, lambda: mega_run(state))
            else:
                run = _warm_up(dp.device,
                               lambda: chunk_program(dp, solver, opts, L_est, chunk, state))
                counts["captures"] += getattr(run, "captures", 0)

    def after_chunk(it, chunks_done, st, f_last, rel, secs):
        if place.squeeze:
            f_last, rel = f_last[0], rel[0]
        if metrics is not None and place.leader:
            metrics.log("chunk", iteration=it, f=f_last.tolist(), relgap=rel.tolist(), secs=secs)
        if checkpoint_path and checkpoint_every and chunks_done % checkpoint_every == 0:
            save_state(checkpoint_path, st, meta={"iteration": it}, keep=checkpoint_keep,
                       shard=place.shard(st))
        if callback is not None:
            callback(it, st)
        if verbose and place.leader:
            print(f"iter {it}: f={f_last} relgap={rel}")

    loop = run_chunk_loop(run, state, it, max_iter, chunk, tol, stop_rule, dp.device,
                          lambda st: place.host(torch.stack([st.f, st.gap]), dim=1),
                          after_chunk)
    state, it = loop.state, loop.iterations
    phases["chunks"] = float(sum(loop.chunk_times))
    counts["chunks"] = len(loop.chunk_times)
    # the steps that ran through the step kernels (ops/stepkernels.py): the
    # step_prep launches of one replay of the chunk program, a chunk
    counts["fused_steps"] = getattr(run, "launches", {}).get("step_prep", 0) * counts["chunks"]
    if checkpoint_path and checkpoint_every:
        save_state(checkpoint_path, state, meta={"iteration": it}, keep=checkpoint_keep,
                   shard=place.shard(state))

    if certify and method not in PAIRWISE:
        # certificate polish: a short pairwise-FW phase from the current
        # iterate.  The FW duality gap g.(x-s) is sound but loose at a
        # PGD-family iterate (residual mass on suboptimal coordinates
        # inflates it); pairwise transfers drain exactly those coordinates,
        # so ~100 afw steps tighten the certificate by orders of magnitude
        # at equal-or-better objective.  All or nothing, as the reference:
        # one scenario that came out worse keeps every scenario's main state.
        from . import frank_wolfe as _fw

        with span("certify"):
            opts_c = SolveOptions(method="afw", line_search="exact", tol=0.0,
                                  max_iter=certify, chunk=certify)
            state_c = _fw.init(dp, L_est, opts_c, xp0=state.xp)
            run_c = chunk_program(dp, _fw, opts_c, L_est, certify, state_c)
            counts["captures"] += getattr(run_c, "captures", 0)
            state_c, _ = run_c(state_c)
            f_c = state_c.f.cpu().numpy()
            if bool(np.all(f_c <= state.f.cpu().numpy() + 1e-12)):
                state = replace(state, xp=state_c.xp, r=state_c.r, f=state_c.f,
                                gap=state_c.gap)

    with span("result", phases):
        if loop.traces_f:
            trace_f = place.host(torch.cat(loop.traces_f, dim=1))
            trace_gap = place.host(torch.cat(loop.traces_g, dim=1))
        # one final exact projection: guarantees feasibility of the returned
        # x regardless of method (the z-space path can leave O(eps) negative
        # entries after the z->x difference map)
        x = place.extract(proj_blocks(state.xp, dp.buckets))
        f = place.host(state.f)
        gap = place.host(state.gap)
        if not loop.traces_f:  # max_iter <= 0, or resumed at or past it: nothing ran
            trace_f = trace_gap = np.zeros((f.shape[0], 0), np.float32)
        if not place.multi:
            x, f, gap = x[0], f[0], gap[0]
        if place.squeeze:
            trace_f, trace_gap = trace_f[0], trace_gap[0]
    res = SolveResult(
        x=x,
        objective=f,
        gap=gap,
        iterations=it,
        converged=loop.converged,
        trace_f=trace_f,
        trace_gap=trace_gap,
        chunk_times=np.asarray(loop.chunk_times),
        chunk_iters=np.asarray(loop.chunk_iters),
        stop_reason=loop.stopper.reason,
        phases=phases,
        counts=counts,
    )
    if refine > 0:
        with span("refine"):
            res = refine_polish(problem, place.refine_dp, res, rounds=refine,
                                target_rel_gap=refine_tol)
    return res
