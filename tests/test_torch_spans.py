"""The port's spans and counters (``utils/profiling.py::span``) on the CPU:
the phases of one ``Endpoint.solve`` under ``torch.profiler``, nested in
order; the eq loop's counters with and without a ``metrics`` sink; a
``BatchQueue`` batch's wait and padding; and ``phases``/``counts`` filled
with no profiler running."""
import time

import numpy as np
import pytest
import torch

import bsls_tpu_torch as bt
from bsls_tpu_torch.models import synthetic as syn
from bsls_tpu_torch.solvers.eq_constrained import solve_equality_constrained
from bsls_tpu_torch.utils.profiling import span
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# an Endpoint estimates ||A||^2 at its build: a request runs no power iteration
REQUEST_PHASES = ["upload", "init", "chunks", "result"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def endpoint():
    prob = syn.tiny_dense(seed=3, num_blocks=20, dim=6, m=150)
    ep = bt.Endpoint(prob, method="pgd", chunk=5, device="cpu")
    ep.warmup()
    return prob, ep


def _spans(prof) -> list:
    """(name without the prefix, start, end) of the bsls spans, by start."""
    out = [(e.name[len("bsls."):], e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("bsls.")]
    return sorted(out, key=lambda s: s[1])


def test_request_spans_nest_in_order_under_the_profiler(endpoint):
    prob, ep = endpoint
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        res = ep.solve(prob.b, tol=0.0, max_iter=20)
        host = time.perf_counter() - t0
    spans = _spans(prof)
    (_, r0, r1), inner = spans[0], spans[1:]
    assert spans[0][0] == "request"
    assert all(r0 <= s and e <= r1 for _, s, e in inner)
    top = [s for s in inner if s[0] != "chunk"]
    assert [name for name, _, _ in top] == REQUEST_PHASES
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))  # one after the other
    _, c0, c1 = top[REQUEST_PHASES.index("chunks")]
    chunks = [s for s in inner if s[0] == "chunk"]
    assert len(chunks) == len(res.chunk_times) == res.counts["chunks"] == 4
    assert all(c0 <= s and e <= c1 for _, s, e in chunks)
    assert list(res.phases) == REQUEST_PHASES
    assert all(v >= 0 for v in res.phases.values())
    assert sum(res.phases.values()) <= host
    assert res.phases["chunks"] == pytest.approx(float(np.sum(res.chunk_times)))
    assert res.counts["captures"] == 0  # the CPU runs its chunks eagerly


def test_the_build_runs_the_power_iteration_and_a_request_does_not():
    prob = syn.tiny_dense(seed=3, num_blocks=20, dim=6, m=150)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ep = bt.Endpoint(prob, method="pgd", chunk=5, device="cpu")
        ep.solve(prob.b, tol=0.0, max_iter=10)
    names = [name for name, _, _ in _spans(prof)]
    assert names.count("power") == 1 and names.index("power") < names.index("request")


class _Sink:
    """A ``metrics`` sink whose records take ``secs`` each."""

    def __init__(self, secs: float):
        self.secs, self.outer = secs, []

    def log(self, kind, **fields):
        if kind == "outer":
            time.sleep(self.secs)
            self.outer.append(fields)


def test_eq_counters_read_the_same_with_and_without_a_sink():
    prob = syn.traffic_like(num_blocks=30, m=150, num_eq=8, noise=0.05)
    kw = dict(tol=0.0, max_iter=100, inner_iters=50, chunk=25, device="cpu")
    sink = _Sink(0.05)
    with_sink = solve_equality_constrained(prob, metrics=sink, **kw)
    without = solve_equality_constrained(prob, **kw)
    # the loop's copies between host and device: b and d up, per outer the
    # penalty scale up and the violation down, then x, lam, the objective
    copied = (8 * prob.A.shape[0] + 8 * prob.C.shape[0] + 2 * (4 + 8)
              + 4 * prob.partition.n_flat + 8 * prob.C.shape[0] + 8)
    assert with_sink.counts == without.counts == {"outers": 2, "chunks": 4, "captures": 0,
                                                  "fused_steps": 0, "eq_host_bytes": copied}
    assert with_sink.counts["outers"] == len(sink.outer)
    # the records' host seconds are the spans' own, and the sink's seconds
    # are eq.record's, not eq.host's
    assert with_sink.phases["eq.host"] == pytest.approx(sum(o["host_secs"] for o in sink.outer))
    assert with_sink.phases["eq.record"] >= 2 * sink.secs
    assert with_sink.phases["eq.host"] < sink.secs
    assert without.phases["eq.host"] < sink.secs
    assert "eq.record" not in without.phases
    for res in (with_sink, without):
        assert {"eq.setup", "eq.upload", "eq.host", "eq.report", "init", "chunks",
                "result"} <= set(res.phases)
        assert all(v >= 0 for v in res.phases.values())


def test_batch_queue_counts_its_batch_and_padding(endpoint):
    prob, ep = endpoint
    q = bt.BatchQueue(ep, max_batch=4, max_wait_ms=300, tol=0.0, max_iter=10)
    try:
        futs = [q.submit(prob.b) for _ in range(3)]
        results = [f.result(timeout=60) for f in futs]
    finally:
        q.close()
    assert q.batches_run == 1 and q.requests_served == 3 and q.padded_lanes == 1
    for r in results:
        assert r.counts["batch"] == 3 and r.counts["padded"] == 4
        assert r.counts["chunks"] == 2
        assert r.phases["queue.wait"] >= 0
        assert set(REQUEST_PHASES) <= set(r.phases)
    # each request's own wait, on dicts of its own
    assert len({id(r.phases) for r in results}) == 3


def test_phases_and_counts_without_a_profiler(endpoint):
    prob, ep = endpoint
    assert not torch.autograd._profiler_enabled()
    res = ep.solve(prob.b, tol=0.0, max_iter=10)
    assert list(res.phases) == REQUEST_PHASES and res.counts["chunks"] == 2
    direct = bt.solve(prob, method="pgd", tol=0.0, max_iter=10, chunk=5, device="cpu")
    assert list(direct.phases) == ["power", *REQUEST_PHASES[1:]]
    assert direct.counts["chunks"] == 2
    phases = {}
    with span("x", phases) as s:
        pass
    with span("x", phases):
        pass
    assert s.secs >= 0 and phases["x"] >= s.secs
