"""Serving endpoint: prepare once, answer many solve requests.

Deployments hold a fixed incidence matrix A (the road network) and answer a
stream of right-hand sides b (new sensor readings, scenario batches).
``Endpoint`` front-loads the per-instance work (PF layout, equilibration,
ELL encoding, the upload to the device), so each request uploads only its b
and runs a chunked solve on the device.

    ep = Endpoint(problem, method="apgd", chunk=200)    # device="cuda"
    ep.warmup()                       # optional: first launches before traffic
    res = ep.solve(b_new, tol=1e-6)
    res = ep.solve(B_batch)           # (S, m) batches are first-class

The layout is fixed when the endpoint is built, by the width of the
problem's own b (``prepare``'s ``layout="auto"``).  Every request still runs
the power iteration and the throwaway warm-up step of ``solve``.

An equality-constrained problem (``C``) is served by the augmented-Lagrangian
loop: its stacked operator is prepared by the first request and kept in the
endpoint's ``op_cache``; the converged multipliers and x of the last request
(per batch shape) warm-start the next, and a nearby request takes the float64
sensitivity fast path (``solve_eq_sensitivity``) when it certifies.

``BatchQueue`` coalesces concurrent single-RHS requests onto the scenario
axis.

Counterpart of the single-device branches of ``bsls_tpu/serving.py``;
``mesh=`` raises ``NotImplementedError`` (the distribution slice).
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from .models.problem import Problem
from .ops import layout as L
from .solvers.base import DEFAULT_REFINE_ROUNDS, SolveResult, refine_polish, solve

__all__ = ["Endpoint", "BatchQueue"]


class Endpoint:
    def __init__(
        self,
        problem: Problem,
        method: str = "apgd",
        line_search: str = "exact",
        chunk: int = 200,
        dtype=torch.float32,
        equilibrate: bool = True,
        warm_start: bool = True,
        mesh=None,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(
                "Endpoint(mesh=...) is not ported yet (later slice: distribution)")
        self.method = method
        self.line_search = line_search
        self.chunk = chunk
        self.dtype = dtype
        self.warm_start = warm_start
        dev = L.resolve_device(device)  # no card and no device="cpu": raises
        if dev.type == "cuda" and dev.index is None:
            # the constructing thread's current card; BatchQueue's worker
            # makes it current in its own thread
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self._problem = problem
        self._eq = problem.C is not None
        self._m = problem.A.shape[0]
        # warm-multiplier cache for eq-constrained streams: the converged AL
        # state (lam, rho, x) of the last request, keyed by batch shape
        self._eq_warm: dict = {}
        # the stacked [A; sqrt(rho) C] operator and its Lipschitz constants
        # depend only on the instance: shared by every eq request
        self._eq_ops: dict = {}
        if self._eq:
            # the AL loop prepares its stacked operator at the first request
            self._dp = None
        else:
            self._dp = L.prepare(problem, dtype=dtype, equilibrate=equilibrate,
                                 device=self.device)

    @property
    def num_rows(self) -> int:
        return self._m

    def _with_b(self, b: np.ndarray) -> L.DeviceProblem:
        """The prepared problem with this request's b: uploaded as given,
        then cast to float32 (as the reference) and put in the row order of
        the row-nnz-bucketed layout on the device; on the host, the cast and
        the gather of a (S, m) b cost more than the request's solve."""
        dev_b = torch.from_numpy(np.ascontiguousarray(b)).to(self.device).to(torch.float32)
        if self._dp.row_perm is not None:
            dev_b = dev_b.index_select(-1, self._dp.row_perm)
        return replace(self._dp, b=dev_b.to(self.dtype))

    def solve(
        self,
        b: np.ndarray,
        tol: float = 1e-6,
        max_iter: int = 10_000,
        x0: Optional[np.ndarray] = None,
        **kw,
    ) -> SolveResult:
        """Solve against a new right-hand side (or (S, m) batch)."""
        b = np.asarray(b)
        if b.shape[-1] != self._m:
            raise ValueError(f"b last dim {b.shape[-1]} != m={self._m}")
        if self._eq:
            np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
            return self._solve_eq(np.asarray(b, np_dtype), tol, max_iter, x0, **kw)
        # refine needs the host Problem (float64 anchor): the polish runs
        # here, against this request's b, not inside solve(dp), which sees
        # only the device problem
        refine = int(kw.pop("refine", 0))
        refine_tol = kw.pop("refine_tol", None)
        if refine_tol is not None and refine <= 0:
            refine = DEFAULT_REFINE_ROUNDS  # refine_tol alone must not skip the polish
        dp = self._with_b(b)
        res = solve(dp, method=self.method, line_search=self.line_search, tol=tol,
                    max_iter=max_iter, chunk=self.chunk, dtype=self.dtype, x0=x0, **kw)
        if refine > 0:
            prob = replace(self._problem, b=np.asarray(b, np.float64))
            res = refine_polish(prob, dp, res, rounds=refine, target_rel_gap=refine_tol)
        return res

    def _solve_eq(self, b, tol, max_iter, x0, **kw) -> SolveResult:
        from .solvers.eq_constrained import solve_eq_sensitivity, solve_equality_constrained

        prob = replace(self._problem, b=b)
        warm = self._eq_warm.get(b.shape[:-1]) if self.warm_start else None
        # Sensitivity fast path (streaming requests): from the previous
        # request's converged x, warm-started block principal pivoting in
        # float64 on the host, no fp32 inner solve.  A None return (instance
        # too large for the dense KKT system, round cap, or violation above
        # tolerance) falls through to the full AL solve.  sensitivity=False
        # opts out per request.
        sens = kw.pop("sensitivity", True)
        if sens and warm is not None and x0 is None and "rho" in warm:
            fast = solve_eq_sensitivity(prob, warm["x"], rho=warm["rho"],
                                        eq_tol=kw.get("eq_tol", tol))
            if fast is not None:
                self._eq_warm[b.shape[:-1]] = {"lam": fast.eq_lam, "rho": fast.eq_rho,
                                               "x": np.asarray(fast.x)}
                return fast
        if warm is not None and x0 is None:
            # warm-start lam and x but NOT the grown rho: near the optimal
            # multipliers a small penalty already holds the constraints,
            # while a large rho ill-conditions the stacked operator and slows
            # every inner solve
            kw.setdefault("lam0", warm["lam"])
            kw.setdefault("x0", warm["x"])
        elif x0 is not None:
            kw.setdefault("x0", x0)
        res = solve_equality_constrained(
            prob, method=self.method, tol=tol, max_iter=max_iter, chunk=self.chunk,
            line_search=self.line_search, dtype=self.dtype, op_cache=self._eq_ops,
            device=self.device, **kw)
        if self.warm_start and res.converged:
            self._eq_warm[b.shape[:-1]] = {"lam": res.eq_lam, "rho": res.eq_rho,
                                           "x": np.asarray(res.x)}
        return res

    def warmup(self, num_scenarios: int = 1) -> None:
        """Run one chunk at a batch width before traffic: the kernel
        library's load and the first launches of every operation."""
        shape = (self._m,) if num_scenarios == 1 else (num_scenarios, self._m)
        if self._eq:
            self.solve(np.zeros(shape, np.float32), tol=0.0, max_iter=self.chunk,
                       outer_iters=1, inner_iters=self.chunk)
        else:
            self.solve(np.zeros(shape, np.float32), tol=0.0, max_iter=self.chunk)


def _slice_result(res: SolveResult, i: int) -> SolveResult:
    """Per-request view of a batched SolveResult (scenario i).  Beyond the
    reference's fields it keeps refine's seconds and certificate and the eq
    path's violation, penalty (the batch's) and multipliers (scenario i's),
    so that a queued eq request can tell whether its constraints hold."""
    return SolveResult(
        x=np.asarray(res.x)[i],
        objective=float(np.asarray(res.objective)[i]),
        gap=float(np.asarray(res.gap)[i]),
        iterations=res.iterations,
        converged=res.converged,
        trace_f=np.asarray(res.trace_f)[i],
        trace_gap=np.asarray(res.trace_gap)[i],
        chunk_times=res.chunk_times,
        chunk_iters=res.chunk_iters,
        stop_reason=res.stop_reason,
        refine_secs=res.refine_secs,
        refine_fw_gap=res.refine_fw_gap,
        eq_violation=res.eq_violation,
        eq_lam=None if res.eq_lam is None else np.asarray(res.eq_lam)[i],
        eq_rho=res.eq_rho,
    )


class BatchQueue:
    """Micro-batching front for an Endpoint: concurrent requests coalesce
    onto the multi-RHS scenario axis, and batch widths are rounded up to
    powers of two.

        q = BatchQueue(Endpoint(problem), max_batch=32, max_wait_ms=20)
        fut = q.submit(b_new)            # thread-safe, returns a Future
        res = fut.result()               # per-request SolveResult
        q.close()

    Solve options are fixed per queue; every solve runs on the single worker
    thread, which makes the endpoint's device current first (the current
    CUDA device is per thread).  Pad scenarios are copies of the first
    request's b, so every lane converges at the same rate.  A failed batch
    sets its exception on every waiting future.
    """

    def __init__(self, endpoint: Endpoint, max_batch: int = 32,
                 max_wait_ms: float = 20.0, tol: float = 1e-6,
                 max_iter: int = 10_000, **solve_kw):
        self.endpoint = endpoint
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._solve_kw = dict(tol=tol, max_iter=max_iter, **solve_kw)
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0
        self.requests_served = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, b: np.ndarray) -> Future:
        fut: Future = Future()
        self._q.put((np.asarray(b, np.float32), fut))
        return fut

    def _run(self):
        if self.endpoint.device.type == "cuda":
            torch.cuda.set_device(self.endpoint.device)
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_wait
            while len(batch) < self.max_batch:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            bs = [b for b, _ in batch]
            # pad to the next power of two with copies of the first request
            S = len(bs)
            S_pad = 1 << (S - 1).bit_length()
            bs = bs + [bs[0]] * (S_pad - S)
            try:
                if S_pad == 1:
                    results = [self.endpoint.solve(bs[0], **self._solve_kw)]
                else:
                    res = self.endpoint.solve(np.stack(bs), **self._solve_kw)
                    results = [_slice_result(res, i) for i in range(S)]
                for (_, fut), r in zip(batch, results):
                    fut.set_result(r)
            except Exception as exc:  # propagate to every waiter
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(exc)
            self.batches_run += 1
            self.requests_served += S

    def close(self, timeout: float = 10.0):
        self._stop.set()
        self._worker.join(timeout=timeout)
