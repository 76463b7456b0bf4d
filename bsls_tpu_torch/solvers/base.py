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

After the main solve, ``certify=K`` runs K pairwise-FW steps from the final
iterate, and ``refine=K`` / ``refine_tol=`` polish the result against a
float64 anchor on the host (``refine_polish``; its correction is a batched
fp32 CG on the device, or a float64 Jacobi-PCG on the host).

A ``Problem`` with equality constraints (``C``) goes to the
augmented-Lagrangian loop of ``solvers/eq_constrained.py``, whose inner
solves are this chunk runner on the stacked operator [A; sqrt(rho) C].

Counterpart of ``bsls_tpu/solvers/base.py`` for all six solver families
(``_get_solver``), certify, refine, checkpoint/resume and the
equality-constrained path on one device.  Only the mesh-sharded solve is not
ported yet: ``mesh=`` and ``shard_rows=`` raise ``NotImplementedError``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..models.problem import Problem
from ..ops import cudalib
from ..ops import layout as L
from ..ops import ztransform as Z
from ..ops.projection import proj_blocks
from ..ops.simplex import block_min
from ..utils.checkpoint import latest_checkpoint, load_state, save_state

PAIRWISE = ("afw", "pairwise", "pairwise_fw")

__all__ = [
    "SolveOptions", "SolveResult", "StopTracker", "fw_gap", "power_lipschitz",
    "power_lipschitz_z", "uses_zspace", "refine_polish", "solve",
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


def _reject_unported(**given):
    """Options of ``bsls_tpu.solve`` whose part is not ported yet."""
    for name, value in given.items():
        if value:
            raise NotImplementedError(
                f"solve({name}=...) is not ported yet (later slice: distribution)")


def _warm_up(device: torch.device, first_launch: Callable[[], Any]) -> None:
    """Load the kernel library (building it with nvcc when it is stale) and
    make the path's first launches, before the chunk clock starts: a fresh
    process would otherwise book the load, the first launch of every kernel
    (the fused chunk's first cooperative launch among them) and the first
    launch of every torch operation into ``chunk_times[0]``, and through it
    into ``time_to_gap``.  ``first_launch`` runs one step (or one fused
    chunk) whose result is dropped; the steps do not write into their input
    state.  No fallback: a library that does not load raises here."""
    if device.type == "cuda":
        cudalib.load()
    first_launch()
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    problem (host only).  ``BSLS_REFINE_TRACE=1`` prints a line per round,
    ``BSLS_PCG_TRACE=1`` the host PCG's residual every 10 iterations.

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
            _trace = os.environ.get("BSLS_PCG_TRACE") == "1"
            for _cg_k in range(cg_now):
                _ratio = float(np.max(rz / np.maximum(rz0, 1e-300)))
                if _trace and _cg_k % 10 == 0:
                    print(f"    pcg it={_cg_k} max rz/rz0={_ratio:.3e}", flush=True)
                if _ratio <= 1e-28:
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
    )


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
    ``eq_rho``.  ``space``, ``callback``, ``certify``, ``lipschitz`` and a
    ``stop_rule`` other than "auto" are rejected there.
    """
    _reject_unported(mesh=mesh is not None)
    if isinstance(problem, Problem) and problem.C is not None:
        from .eq_constrained import solve_equality_constrained

        # the AL outer loop supports a subset of solve()'s surface: reject
        # the rest loudly instead of silently ignoring it (the reference
        # drops stop_rule; here it is rejected too)
        unsupported = {
            "space": space != "x", "callback": callback is not None,
            "certify": certify > 0, "lipschitz": lipschitz is not None,
            "stop_rule": stop_rule != "auto",
        }
        bad = [k for k, v in unsupported.items() if v]
        if bad:
            raise ValueError(
                f"equality-constrained solve does not support {bad}; run the "
                "AL loop manually via solvers.eq_constrained if needed")
        return solve_equality_constrained(
            problem, method=method, tol=tol, max_iter=max_iter, chunk=chunk,
            line_search=line_search, step_size=step_size, dtype=dtype,
            lbfgs_mem=lbfgs_mem, x0=x0, refine=refine, refine_tol=refine_tol,
            metrics=metrics, checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every, checkpoint_keep=checkpoint_keep,
            resume=resume, device=device,
        )
    if refine_tol is not None and refine == 0:
        # certified mode with no explicit round cap: default the cap instead
        # of silently ignoring refine_tol
        refine = DEFAULT_REFINE_ROUNDS
    if refine > 0 and not isinstance(problem, Problem):
        raise ValueError(
            "refine requires a host Problem (the correction anchor is "
            "re-evaluated in float64 on the host)")
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
        lbfgs_mem=lbfgs_mem,
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

    def run_chunk(st, solver=solver, opts=opts, steps=chunk):
        st = solver.refresh(dp, st, L_est, opts)
        tf = torch.empty((st.f.shape[0], steps), dtype=st.f.dtype, device=dp.device)
        tg = torch.empty_like(tf)
        for j in range(steps):
            st = solver.step(dp, st, L_est, opts)
            tf[:, j] = st.f
            tg[:, j] = st.gap
        return st, (tf, tg)

    run = mega_run if mega_run is not None else run_chunk
    it = 0
    if resume and checkpoint_path:
        ck = latest_checkpoint(checkpoint_path)
        if ck:
            state, meta = load_state(ck, state)
            it = int(meta.get("iteration", 0))
    if it < max_iter:
        _warm_up(dp.device, (lambda: mega_run(state)) if mega_run is not None
                 else (lambda: solver.step(dp, state, L_est, opts)))

    # Chunk loop: K steps enqueued without a host sync, then ONE readback of
    # the end-of-chunk (f, gap), which is also what closes the chunk's wall
    # time.  The per-step traces stay on the device until the end.
    traces_f, traces_g, ctimes, citers = [], [], [], []
    converged = False
    stopper = StopTracker(tol, stop_rule)
    chunks_done = 0
    if dp.device.type == "cuda":
        torch.cuda.synchronize(dp.device)
    t0 = time.perf_counter()
    while it < max_iter:
        state, (tf, tg) = run(state)
        it += chunk
        chunks_done += 1
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
        if checkpoint_path and checkpoint_every and chunks_done % checkpoint_every == 0:
            save_state(checkpoint_path, state, meta={"iteration": it}, keep=checkpoint_keep)
        if callback is not None:
            callback(it, state)
        if verbose:
            print(f"iter {it}: f={f_last} relgap={rel}")
        if stopper.update(f_last, rel):
            converged = True
            break
    if checkpoint_path and checkpoint_every:
        save_state(checkpoint_path, state, meta={"iteration": it}, keep=checkpoint_keep)

    if certify and method not in PAIRWISE:
        # certificate polish: a short pairwise-FW phase from the current
        # iterate.  The FW duality gap g.(x-s) is sound but loose at a
        # PGD-family iterate (residual mass on suboptimal coordinates
        # inflates it); pairwise transfers drain exactly those coordinates,
        # so ~100 afw steps tighten the certificate by orders of magnitude
        # at equal-or-better objective.  All or nothing, as the reference:
        # one scenario that came out worse keeps every scenario's main state.
        from . import frank_wolfe as _fw

        opts_c = SolveOptions(method="afw", line_search="exact", tol=0.0,
                              max_iter=certify, chunk=certify)
        state_c = _fw.init(dp, L_est, opts_c, xp0=state.xp)
        state_c, _ = run_chunk(state_c, solver=_fw, opts=opts_c, steps=certify)
        f_c = state_c.f.cpu().numpy()
        if bool(np.all(f_c <= state.f.cpu().numpy() + 1e-12)):
            state = replace(state, xp=state_c.xp, r=state_c.r, f=state_c.f, gap=state_c.gap)

    if traces_f:
        trace_f = torch.cat(traces_f, dim=1).cpu().numpy()
        trace_gap = torch.cat(traces_g, dim=1).cpu().numpy()
    else:  # max_iter <= 0, or resumed at or past it: nothing ran
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
    res = SolveResult(
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
    if refine > 0:
        res = refine_polish(problem, dp, res, rounds=refine, target_rel_gap=refine_tol)
    return res
