"""The one general traffic generator: a closed loop of callers or an open
loop of arrivals, driven by a traffic file's parameters.

Every request records when it was due, when it was sent, when its answer
came and whether it came; the window's clock is the host's
``time.perf_counter``.  Request i sends entry i of the run's requests
(``instances.Requests``, made before the window), so no right-hand side is
sent twice.
"""
from __future__ import annotations

import time
from concurrent import futures

import numpy as np
from torch.profiler import record_function

__all__ = ["closed_loop", "arrival_offsets", "open_loop", "latencies"]


def closed_loop(call, pool, seconds: float, tracer=None, trace_request: int = 1) -> tuple:
    """One caller: send a request, wait for its answer, send the next, until
    the window closes (the request in flight then is waited for).  With a
    tracer, request ``trace_request`` is traced whole."""
    reqs = []
    t0 = time.perf_counter()
    t_close = t0 + seconds
    i = 0
    while time.perf_counter() < t_close:
        traced = tracer is not None and i == trace_request
        if traced:
            tracer.start()
        start = time.perf_counter()
        rec = {"index": i, "pool": i, "due": start, "start": start, "traced": traced}
        try:
            with record_function("bench.request"):
                rec["result"] = call(pool[rec["pool"]])
            rec["ok"] = True
        except Exception as exc:  # noqa: BLE001 - a failed request is a result
            rec["ok"], rec["error"] = False, repr(exc)
        rec["end"] = time.perf_counter()
        if traced:
            tracer.stop()
        reqs.append(rec)
        i += 1
    return reqs, (t0, t_close)


def arrival_offsets(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times (seconds from the window's start) of round(rate x seconds)
    arrivals whose gaps are the exponential distribution's quantiles at
    (i + 1/2) / N, scaled to fill the window and shuffled by the seed: every
    seed offers the same gaps in another order."""
    N = max(int(round(rate * seconds)), 1)
    gaps = -np.log1p(-(np.arange(N) + 0.5) / N)
    gaps *= seconds / gaps.sum()
    gaps = np.random.default_rng([seed, 3]).permutation(gaps)
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def open_loop(submit, pool, offsets: np.ndarray, seconds: float, wait_s: float,
              tracer=None, trace_from: float = 0.0, trace_s: float = 0.0) -> tuple:
    """Send request k at its due time whatever is still in flight, then wait
    for every answer until ``wait_s`` past the window's close.  With a
    tracer, the profiler runs from ``trace_from`` to ``trace_from + trace_s``
    seconds into the window; before it starts and stops, the requests in
    flight are waited for (the generator runs late there: a traced run
    reports no latency)."""
    reqs = []

    def quiet():
        """Wait until every request sent so far is answered: the profiler
        starts and stops while no other thread launches work on the card."""
        futures.wait([r["future"] for r in reqs], timeout=wait_s)

    t0 = time.perf_counter() + 0.01
    state = "before"  # of the trace
    for k, off in enumerate(offsets):
        due = t0 + float(off)
        if tracer is not None and state == "before" and off >= trace_from:
            quiet()
            tracer.start()
            state = "on"
        elif state == "on" and off >= trace_from + trace_s:
            quiet()
            tracer.stop()
            state = "done"
        while (now := time.perf_counter()) < due:
            time.sleep(min(due - now, 0.001))
        rec = {"index": k, "pool": k, "due": due, "start": now, "end": None,
               "ok": False, "traced": state == "on"}
        with record_function("bench.submit"):
            fut = submit(pool[rec["pool"]])

        def done(f, rec=rec):
            rec["end"] = time.perf_counter()

        fut.add_done_callback(done)
        rec["future"] = fut
        reqs.append(rec)
    if state == "on":
        quiet()
        tracer.stop()
    t_close = t0 + seconds
    deadline = t_close + wait_s
    for rec in reqs:
        fut = rec.pop("future")
        try:
            rec["result"] = fut.result(timeout=max(deadline - time.perf_counter(), 0.0))
            rec["ok"] = True
        except Exception as exc:  # noqa: BLE001 - unanswered or failed: a result
            rec["error"] = repr(exc)
            if rec["end"] is None or not fut.done():
                rec["end"] = None
    return reqs, (t0, t_close, deadline)


def latencies(reqs: list, deadline: float) -> list:
    """Seconds from each request's due time to its answer; for a request that
    failed or was never answered, to the deadline of the wait, so that it
    misses any limit that the wait could show."""
    return [r["end"] - r["due"] if r["ok"] and r["end"] is not None else deadline - r["due"]
            for r in reqs]
