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
problem's own b (``prepare``'s ``layout="auto"``).  ||A||^2 depends on A
alone: the endpoint estimates it once, when it is built, and every request
solves with that estimate (or the caller's ``lipschitz``).  On the card a
request's chunks replay the CUDA graph captured for the endpoint's prepared
problem at that batch width (``solvers/graph.py``): the first request of a
width (or ``warmup``) captures it, and later ones replay it with their own
b.

An equality-constrained problem (``C``) is served by the augmented-Lagrangian
loop: its stacked operator is prepared by the first request and kept in the
endpoint's ``op_cache``; the converged multipliers and x of the last request
(per batch shape) warm-start the next, and a nearby request takes the float64
sensitivity fast path (``solve_eq_sensitivity``) when it certifies.

``BatchQueue`` coalesces concurrent single-RHS requests onto the scenario
axis.

On a mesh (``Endpoint(problem, mesh=...)``, every rank of the mesh builds
the endpoint and makes the same calls): an unconstrained endpoint shards and
uploads A once, its ||A||^2 estimate is one collective power iteration, and
each request uploads only the rank's scenarios of b; an eq endpoint's
``op_cache`` holds the sharded stacked operator after the first request.  A
``BatchQueue`` over a mesh endpoint of several processes lets rank 0 alone
compose the batches and sends each to the other ranks.

Counterpart of ``bsls_tpu/serving.py``.
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
from .solvers.base import (
    OneCard, SolveResult, power_lipschitz, power_lipschitz_z, refine_rounds, solve_on, uses_zspace,
)
from .utils.profiling import span

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
        self.method = method
        self.line_search = line_search
        self.chunk = chunk
        self.dtype = dtype
        self.warm_start = warm_start
        self.mesh = mesh
        L.check_dtype(dtype, device if mesh is None else mesh.device)
        if mesh is not None:
            dev = mesh.device
        else:
            dev = L.resolve_device(device)  # no card and no device="cpu": raises
        if dev.type == "cuda" and dev.index is None:
            # the constructing thread's current card; BatchQueue's worker
            # makes it current in its own thread
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        # host seconds of the build's phases (``bsls.prepare`` and its parts:
        # ``ops/layout.py::prepare``); empty on a mesh or for an eq problem,
        # which prepare elsewhere
        self.build_phases: dict = {}
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
            # (on a mesh, each rank its tile of it)
            self._dp = None
            return
        if mesh is not None:
            from .parallel.sharding import shard_problem

            # shard and upload A once
            self._dp, self._part = shard_problem(problem, mesh, dtype=dtype,
                                                 equilibrate=equilibrate)
        else:
            self._dp = L.prepare(problem, dtype=dtype, equilibrate=equilibrate,
                                 device=self.device, phases=self.build_phases)
        # ||A||^2 (||A D||^2 for z-space trial steps, as solve chooses)
        # depends on A alone: one power iteration per endpoint (collective
        # on a mesh), the span ``bsls.power``, none per request
        power = power_lipschitz_z if uses_zspace(method, line_search) else power_lipschitz
        with span("power"):
            self._lip = power(self._dp)

    @property
    def num_rows(self) -> int:
        return self._m

    def solve(
        self,
        b: np.ndarray,
        tol: float = 1e-6,
        max_iter: int = 10_000,
        x0: Optional[np.ndarray] = None,
        **kw,
    ) -> SolveResult:
        """Solve against a new right-hand side (or (S, m) batch).  The call
        is the span ``bsls.request``; the result's ``phases`` and
        ``counts`` say where its host time went (``utils/profiling.py``)."""
        with span("request"):
            b = np.asarray(b)
            if b.shape[-1] != self._m:
                raise ValueError(f"b last dim {b.shape[-1]} != m={self._m}")
            if self._eq:
                np_dtype = torch.empty((), dtype=self.dtype).numpy().dtype
                return self._solve_eq(np.asarray(b, np_dtype), tol, max_iter, x0, **kw)
            # refine needs the host Problem (float64 anchor): the polish runs
            # against this request's b
            refine = refine_rounds(kw.pop("refine", 0), kw.get("refine_tol"))
            host = replace(self._problem, b=np.asarray(b, np.float64)) if refine else None
            if kw.get("lipschitz") is None and kw.get("space", "x") == "x":
                kw["lipschitz"] = self._lip
            with span("upload") as up:
                place = self._placed(b)
            res = solve_on(place, host, method=self.method, line_search=self.line_search,
                           tol=tol, max_iter=max_iter, chunk=self.chunk, x0=x0, refine=refine,
                           **kw)
            res.phases = {"upload": up.secs, **res.phases}
            return res

    def _placed(self, b: np.ndarray):
        """The prepared problem with this request's b, where it runs: on one
        device uploaded as given, then cast to float32 (as the reference) and
        put in the row order of the row-nnz-bucketed layout on the device (on
        the host, the cast and the gather of a (S, m) b cost more than the
        request's solve); on a mesh this rank's scenarios of b."""
        if self.mesh is None:
            dev_b = torch.from_numpy(np.ascontiguousarray(b)).to(self.device).to(torch.float32)
            if self._dp.row_perm is not None:
                dev_b = dev_b.index_select(-1, self._dp.row_perm)
            return OneCard(replace(self._dp, b=dev_b.to(self.dtype)))
        from .parallel.mesh import SCENARIO_AXIS
        from .parallel.sharding import MeshPlacement, with_rank_rhs

        B = np.atleast_2d(b)
        ns = self.mesh.shape[SCENARIO_AXIS]
        if B.shape[0] % ns:
            raise ValueError(f"batch width {B.shape[0]} not divisible by the mesh's scenario "
                             f"axis ({ns}); pad the batch or use scenario=1")
        return MeshPlacement(with_rank_rhs(self._dp, B, self.mesh), self._part, self.mesh,
                             b.ndim == 1)

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
            # on a mesh of several processes rank 0 walks and every rank
            # takes its answer: a rank that fell through alone to the AL
            # solve would wait in its collectives
            with span("eq.sensitivity"):
                fast = _on_rank0(self.mesh, lambda: solve_eq_sensitivity(
                    prob, warm["x"], rho=warm["rho"], eq_tol=kw.get("eq_tol", tol)))
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
            mesh=self.mesh, device=self.device, **kw)
        if self.warm_start and res.converged:
            self._eq_warm[b.shape[:-1]] = {"lam": res.eq_lam, "rho": res.eq_rho,
                                           "x": np.asarray(res.x)}
        return res

    def warmup(self, num_scenarios: int = 1) -> None:
        """Run one chunk at a batch width before traffic: the kernel
        library's load, the first launches of every operation and, on the
        card, the capture of the chunk's graph at that width."""
        shape = (self._m,) if num_scenarios == 1 else (num_scenarios, self._m)
        if self._eq:
            self.solve(np.zeros(shape, np.float32), tol=0.0, max_iter=self.chunk,
                       outer_iters=1, inner_iters=self.chunk)
        else:
            self.solve(np.zeros(shape, np.float32), tol=0.0, max_iter=self.chunk)


def _world(mesh) -> int:
    """Processes of the mesh's world (1 without a mesh)."""
    import torch.distributed as dist

    return 1 if mesh is None else dist.get_world_size()


def _on_rank0(mesh, fn):
    """``fn()`` on rank 0 of a mesh of several processes, its result sent to
    every rank; ``fn()`` itself without a mesh or in a world of one."""
    import torch.distributed as dist

    if _world(mesh) == 1:
        return fn()
    box = [fn() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _slice_result(res: SolveResult, i: int) -> SolveResult:
    """Per-request view of a batched SolveResult (scenario i).  Beyond the
    reference's fields it keeps refine's seconds and certificate and the eq
    path's violation, penalty (the batch's) and multipliers (scenario i's),
    so that a queued eq request can tell whether its constraints hold, and
    copies of the batch's ``phases`` and ``counts``."""
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
        phases=dict(res.phases),
        counts=dict(res.counts),
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

    Each request's result adds to the batch's ``phases`` its own
    ``queue.wait`` (seconds from its ``submit`` to its batch's solve) and to
    its ``counts`` the batch's width (``batch``) and padded width
    (``padded``); the queue counts ``batches_run``, ``requests_served`` and
    ``padded_lanes``.  The worker's spans are ``bsls.queue.idle`` (waiting
    for a batch's first request), ``bsls.queue.collect`` (gathering the rest)
    and ``bsls.queue.batch`` (its solve and the fan-out of its results).  A
    profiler started on another thread records them (and the batch's own
    spans) only when it profiles every thread.

    Over a mesh endpoint of several processes every rank builds its queue,
    and a batch must be the same on every rank, yet it depends on when the
    requests arrive.  So rank 0 alone takes requests (``submit`` elsewhere
    raises) and composes the batches, and its worker sends each batch's
    right-hand sides to the other ranks' workers, which make the same
    ``Endpoint.solve`` (their results are dropped).  While no request comes,
    rank 0 sends an idle message every second so that no rank waits
    in a collective longer than that.  ``close`` on rank 0 stops every
    rank's worker; ``close`` on another rank waits for that.  The reference
    runs one controller, whose single queue does this implicitly; this is
    its counterpart, not a new feature.  No other collective may run on the
    endpoint's group while the queue is open.
    """

    _IDLE, _STOP = -1, 0  # header widths of the messages that carry no batch
    _IDLE_SECS = 1.0

    def __init__(self, endpoint: Endpoint, max_batch: int = 32,
                 max_wait_ms: float = 20.0, tol: float = 1e-6,
                 max_iter: int = 10_000, **solve_kw):
        import torch.distributed as dist

        self.endpoint = endpoint
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._solve_kw = dict(tol=tol, max_iter=max_iter, **solve_kw)
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.batches_run = 0
        self.requests_served = 0
        self.padded_lanes = 0
        # several processes: rank 0 decides, the others follow its messages
        self._ranks = _world(endpoint.mesh)
        self._leader = self._ranks == 1 or dist.get_rank() == 0
        self._worker = threading.Thread(
            target=self._run if self._leader else self._follow, daemon=True)
        self._worker.start()

    def submit(self, b: np.ndarray) -> Future:
        if not self._leader:
            raise RuntimeError("BatchQueue over a mesh: submit requests on rank 0; the other "
                               "ranks' queues follow its batches")
        fut: Future = Future()
        self._q.put((np.asarray(b, np.float32), fut, time.perf_counter()))
        return fut

    def _send(self, width: int, S: int = 0, bs=None) -> None:
        """Rank 0: a message to the other ranks' workers (a header, then the
        batch's right-hand sides when it carries one)."""
        import torch.distributed as dist

        if self._ranks == 1:
            return
        dist.broadcast(torch.tensor([width, S], dtype=torch.int64), src=0)
        if width > 0:
            dist.broadcast(torch.from_numpy(np.ascontiguousarray(np.stack(bs))), src=0)

    def _solve_batch(self, bs):
        if len(bs) == 1:
            return self.endpoint.solve(bs[0], **self._solve_kw)
        return self.endpoint.solve(np.stack(bs), **self._solve_kw)

    def _run(self):
        if self.endpoint.device.type == "cuda":
            torch.cuda.set_device(self.endpoint.device)
        idle_since = time.monotonic()
        while not self._stop.is_set():
            try:
                with span("queue.idle"):
                    first = self._q.get(timeout=0.05)
            except queue.Empty:
                if time.monotonic() - idle_since >= self._IDLE_SECS:
                    self._send(self._IDLE)
                    idle_since = time.monotonic()
                continue
            with span("queue.collect"):
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
            with span("queue.batch"):
                bs = [b for b, _, _ in batch]
                # pad to the next power of two with copies of the first request
                S = len(bs)
                S_pad = 1 << (S - 1).bit_length()
                bs = bs + [bs[0]] * (S_pad - S)
                try:
                    self._send(S_pad, S, bs)
                    t_solve = time.perf_counter()
                    res = self._solve_batch(bs)
                    results = [res] if S_pad == 1 else [_slice_result(res, i) for i in range(S)]
                    for (_, fut, t_in), r in zip(batch, results):
                        r.phases["queue.wait"] = t_solve - t_in
                        r.counts.update(batch=S, padded=S_pad)
                        fut.set_result(r)
                except Exception as exc:  # propagate to every waiter
                    for _, fut, _ in batch:
                        if not fut.done():
                            fut.set_exception(exc)
            self.batches_run += 1
            self.requests_served += S
            self.padded_lanes += S_pad - S
            idle_since = time.monotonic()
        self._send(self._STOP)

    def _follow(self):
        """Another rank: make the solve of every batch rank 0 sends, until it
        sends the stop."""
        import torch.distributed as dist

        if self.endpoint.device.type == "cuda":
            torch.cuda.set_device(self.endpoint.device)
        m = self.endpoint.num_rows
        while True:
            head = torch.empty(2, dtype=torch.int64)
            dist.broadcast(head, src=0)
            width, S = (int(v) for v in head)
            if width == self._STOP:
                break
            if width == self._IDLE:
                continue
            bs = torch.empty((width, m), dtype=torch.float32)
            dist.broadcast(bs, src=0)
            try:
                self._solve_batch(list(bs.numpy()))
            except Exception:  # noqa: BLE001 - rank 0's futures carry the failure
                pass
            self.batches_run += 1
            self.requests_served += S
            self.padded_lanes += width - S

    def close(self, timeout: float = 10.0):
        """Stop the worker (on rank 0 of a mesh: every rank's worker; on
        another rank: wait until rank 0 closes its queue)."""
        if self._leader:
            self._stop.set()
        self._worker.join(timeout=timeout)
