"""Serving of the PyTorch port (``bsls_tpu_torch.serving``) against
``bsls_tpu.serving`` on the reference's own instances (tests/test_serving.py):
streaming right-hand sides with one Lipschitz constant for both packages,
refine requests by behaviour, ``BatchQueue`` coalescing, the eq endpoint's
warm-multiplier cache and its float64 sensitivity fast path, and the
per-request view of a batched result."""
import dataclasses

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import bsls_tpu.serving as JS
import bsls_tpu_torch as bt
import bsls_tpu_torch.serving as TS
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.solvers import base as TB
from bsls_tpu_torch.solvers import eq_constrained as TEQ
from bsls_tpu_torch.solvers.base import DEFAULT_REFINE_ROUNDS, SolveResult, power_lipschitz
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# fp32 solves of one instance with one Lipschitz constant: final objectives
# relative to max(1, |f|), the repo's measure (the reference's own serving
# test holds the oracle gap so), and pgd/exact traces relative (sums in
# another order part there first: ROADMAP.md queue 3)
OBJ_TOL = 1e-5
F32_TRACE_RTOL = 1e-3
# the float64 sensitivity walks of both packages from one warm state
SENS_X_ATOL = 1e-9


@pytest.fixture(autouse=True)
def one_thread():
    """One torch and one BLAS thread: beside the other test workers,
    multi-threaded small products spin against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


def _streaming_b(prob, syn, rng):
    x_true = syn.random_block_x(rng, prob.partition.sizes)
    return prob.A.matvec(x_true) + 1e-3 * rng.standard_normal(prob.A.shape[0])


def test_endpoint_streaming_rhs_matches_reference():
    pt = tsyn.tiny_dense(seed=3, num_blocks=20, dim=6, m=150)
    pj = jsyn.tiny_dense(seed=3, num_blocks=20, dim=6, m=150)
    ep = TS.Endpoint(pt, method="apgd", chunk=100, device="cpu")
    ep_ref = JS.Endpoint(pj, method="apgd", chunk=100)
    ep.warmup()
    lip = power_lipschitz(ep._dp)
    rng = np.random.default_rng(0)
    for trial in range(3):
        b = _streaming_b(pt, tsyn, rng)
        res = ep.solve(b, tol=1e-8, max_iter=3000, lipschitz=lip)
        ref = ep_ref.solve(b, tol=1e-8, max_iter=3000, lipschitz=lip)
        assert res.x.shape == (pt.partition.n_flat,)
        assert _rel(res.objective, ref.objective) <= OBJ_TOL, trial
        orc = bt.oracle_solve(dataclasses.replace(pt, b=b), tol_gap=1e-9, max_iter=10000)
        assert (float(res.objective) - orc.objective) / max(1.0, orc.objective) <= 1e-5


def test_endpoint_batched_request_and_warmup_width():
    pt = tsyn.tiny_dense(seed=3, num_blocks=20, dim=6, m=150)
    pj = jsyn.tiny_dense(seed=3, num_blocks=20, dim=6, m=150)
    ep = TS.Endpoint(pt, method="pgd", chunk=100, device="cpu")
    ep.warmup(4)
    lip = power_lipschitz(ep._dp)
    rng = np.random.default_rng(2)
    B = np.stack([_streaming_b(pt, tsyn, rng) for _ in range(4)])
    res = ep.solve(B, tol=0.0, max_iter=200, lipschitz=lip)
    ref = JS.Endpoint(pj, method="pgd", chunk=100).solve(B, tol=0.0, max_iter=200, lipschitz=lip)
    assert res.x.shape == (4, pt.partition.n_flat) and res.trace_f.shape == (4, 200)
    np.testing.assert_allclose(res.trace_f, np.asarray(ref.trace_f), rtol=F32_TRACE_RTOL)
    np.testing.assert_allclose(res.objective, np.asarray(ref.objective), rtol=0, atol=OBJ_TOL)


@pytest.mark.slow
def test_endpoint_batch_and_warm_start():
    """A sparse instance (row-bucketed gather layout below 16 scenarios, or
    the band where it is bandable, as the reference): a batch, then a warm
    start from its solution is no worse."""
    pt = tsyn.medium_sparse(seed=2, num_blocks=60, m=400)
    ep = TS.Endpoint(pt, method="pgd", chunk=100, device="cpu")
    rng = np.random.default_rng(1)
    B = np.stack([pt.A.matvec(tsyn.random_block_x(rng, pt.partition.sizes)) for _ in range(3)])
    lip = power_lipschitz(ep._dp)
    res = ep.solve(B, tol=1e-7, max_iter=2000, lipschitz=lip)
    assert res.x.shape == (3, pt.partition.n_flat)
    res2 = ep.solve(B, tol=1e-7, max_iter=500, x0=res.x, lipschitz=lip)
    assert np.all(np.asarray(res2.objective) <= np.asarray(res.objective) + 1e-5)
    ref = JS.Endpoint(jsyn.medium_sparse(seed=2, num_blocks=60, m=400), method="pgd",
                      chunk=100).solve(B, tol=1e-7, max_iter=2000, lipschitz=lip)
    np.testing.assert_allclose(res.objective, np.asarray(ref.objective), rtol=0, atol=OBJ_TOL)


@pytest.mark.parametrize("line_search", ["exact", "pava"])
def test_endpoint_estimates_lipschitz_once(monkeypatch, line_search):
    """||A||^2 (||A D||^2 for pava's z-space trial step) depends on A alone:
    the endpoint's build estimates it, its requests run no power iteration,
    and each answer is, bit for bit, a direct solve's with that estimate."""
    pt = tsyn.tiny_dense(seed=3, num_blocks=20, dim=6, m=150)
    ep = TS.Endpoint(pt, method="pgd", line_search=line_search, chunk=10, device="cpu")
    power = TB.power_lipschitz_z if line_search == "pava" else TB.power_lipschitz
    assert ep._lip == power(ep._dp)
    runs, real = [], TB._power_iterate
    monkeypatch.setattr(TB, "_power_iterate", lambda *a: runs.append(1) or real(*a))
    rng = np.random.default_rng(4)
    for B in ([_streaming_b(pt, tsyn, rng) for _ in range(3)],
              [_streaming_b(pt, tsyn, rng)], [_streaming_b(pt, tsyn, rng) for _ in range(2)]):
        B = np.squeeze(np.stack(B))
        got = ep.solve(B, tol=0.0, max_iter=30)
        want = bt.solve(bt.prepare(dataclasses.replace(pt, b=B), device="cpu"), method="pgd",
                        line_search=line_search, tol=0.0, max_iter=30, chunk=10,
                        lipschitz=ep._lip)
        for field in ("x", "objective", "gap", "trace_f", "trace_gap"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert not runs


def test_endpoint_row_bucketed_layout_takes_b_in_the_users_row_order():
    """On the gather layout of a sparse A the rows are sorted by nonzero
    count: each request's b goes through ``row_perm`` (S >= 16 keeps the
    gather layout under ``auto``)."""
    base = tsyn.medium_sparse(seed=2, num_blocks=60, m=400)
    pt = tsyn.with_scenarios(base, 16, seed=3)
    ep = TS.Endpoint(pt, method="pgd", chunk=50, device="cpu")
    assert ep._dp.row_perm is not None
    B = np.asarray(tsyn.with_scenarios(base, 16, seed=4).b)
    res = ep.solve(B, tol=0.0, max_iter=100)
    direct = bt.solve(dataclasses.replace(pt, b=B), method="pgd", tol=0.0, max_iter=100,
                      chunk=50, device="cpu", lipschitz=power_lipschitz(ep._dp))
    np.testing.assert_allclose(res.objective, direct.objective, rtol=1e-3)
    f64 = [dataclasses.replace(base, b=B[s]).objective_np(res.x[s]) for s in range(16)]
    np.testing.assert_allclose(res.objective, f64, rtol=1e-4)


def test_endpoint_refine_requests():
    """Per-request refine against the request's own b, by behaviour: never
    worse than the fp32 answer, well below the fp32 floor, and refine_tol
    (alone: DEFAULT_REFINE_ROUNDS) returns a certificate in both packages."""
    pt = tsyn.tiny_dense(seed=3, num_blocks=20, dim=6, m=150)
    pj = jsyn.tiny_dense(seed=3, num_blocks=20, dim=6, m=150)
    ep = TS.Endpoint(pt, method="lbfgs", chunk=100, device="cpu")
    b = _streaming_b(pt, tsyn, np.random.default_rng(4))
    single = dataclasses.replace(pt, b=b)
    orc = bt.oracle_solve(single, tol_gap=1e-11, max_iter=20000)
    plain = ep.solve(b, tol=0.0, max_iter=600)
    res = ep.solve(b, tol=0.0, max_iter=600, refine=6)
    assert res.refine_secs > 0.0 and res.refine_fw_gap is None
    assert float(res.objective) <= single.objective_np(plain.x) + 1e-15
    assert (float(res.objective) - orc.objective) / max(orc.objective, 1e-30) < 1e-8
    res_c = ep.solve(b, tol=0.0, max_iter=600, refine_tol=1e-8)
    ref_c = JS.Endpoint(pj, method="lbfgs", chunk=100).solve(b, tol=0.0, max_iter=600,
                                                              refine_tol=1e-8)
    for r in (res_c, ref_c):
        assert r.refine_fw_gap is not None and r.refine_fw_gap <= 1e-8
    assert res_c.iterations <= 600 + DEFAULT_REFINE_ROUNDS * 1600
    assert _rel(res_c.objective, ref_c.objective) <= 1e-8


@pytest.mark.parametrize("shape", [(29,), (3, 29)])
def test_endpoint_rejects_bad_shapes(shape):
    pt = tsyn.tiny_dense(seed=3, num_blocks=5, dim=4, m=30)
    for ep in (TS.Endpoint(pt, device="cpu"),
               TS.Endpoint(tsyn.traffic_like(num_blocks=10, m=30, num_eq=3), device="cpu")):
        with pytest.raises(ValueError, match="29"):
            ep.solve(np.zeros(shape))


def test_endpoint_without_a_card_raises_and_mesh_is_not_ported():
    pt = tsyn.tiny_dense(seed=3, num_blocks=5, dim=4, m=30)
    # a mesh endpoint serves (a world of one; more: tests/test_torch_serving_mesh.py)
    bt.init_distributed("gloo")
    ep = TS.Endpoint(pt, method="pgd", mesh=bt.make_mesh(block=1, device="cpu"))
    res = ep.solve(np.asarray(pt.b), tol=0.0, max_iter=20)
    want = TS.Endpoint(pt, method="pgd", device="cpu").solve(np.asarray(pt.b), tol=0.0,
                                                            max_iter=20, lipschitz=ep._lip)
    assert res.x.shape == (pt.partition.n_flat,)
    np.testing.assert_allclose(res.objective, want.objective, rtol=1e-6)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    with pytest.raises(RuntimeError, match="cuda"):
        TS.Endpoint(pt)
    with pytest.raises(RuntimeError, match="cuda"):
        bt.Endpoint(tsyn.traffic_like(num_blocks=10, m=30, num_eq=3))


def test_batch_queue_coalesces_and_matches_individual():
    pt = tsyn.tiny_dense(seed=3, num_blocks=20, dim=5, m=120)
    ep = TS.Endpoint(pt, method="pgd", chunk=100, device="cpu")
    q = TS.BatchQueue(ep, max_batch=8, max_wait_ms=50, tol=0.0, max_iter=200)
    rng = np.random.default_rng(0)
    bs = [np.asarray(pt.b) + 0.01 * rng.standard_normal(pt.A.shape[0]) for _ in range(5)]
    try:
        futs = [q.submit(b) for b in bs]
        results = [f.result(timeout=120) for f in futs]
        # a failing batch sets its exception on every waiter
        bad = q.submit(np.zeros(7))
        with pytest.raises(ValueError, match="7"):
            bad.result(timeout=120)
    finally:
        q.close(timeout=30)
    assert not q._worker.is_alive()
    assert q.requests_served == 6
    assert q.batches_run < 5, "requests should have coalesced"
    for b, r in zip(bs, results):
        solo = ep.solve(b, tol=0.0, max_iter=200)
        np.testing.assert_allclose(float(r.objective), float(solo.objective), rtol=1e-5,
                                   atol=1e-8)
        assert r.x.shape == (pt.partition.n_flat,) and r.trace_f.shape == (200,)


def test_batch_queue_under_many_client_threads():
    """More client threads than cores submit at once under a short switch
    interval: every request is served once, and each answer is its own b's
    (its fp32 objective is the float64 objective of its x against that b)."""
    import sys
    import threading

    pt = tsyn.tiny_dense(seed=4, num_blocks=10, dim=4, m=40)
    ep = TS.Endpoint(pt, method="pgd", chunk=50, device="cpu")
    q = TS.BatchQueue(ep, max_batch=8, max_wait_ms=5, tol=0.0, max_iter=50)
    rng = np.random.default_rng(3)
    bs = [np.asarray(pt.b) * rng.uniform(0.5, 2.0) for _ in range(24)]
    out = [None] * len(bs)

    def client(k):
        futs = [(i, q.submit(bs[i])) for i in (2 * k, 2 * k + 1)]
        for i, f in futs:
            out[i] = f.result(timeout=120)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        q.close(timeout=30)
    assert not any(t.is_alive() for t in threads) and not q._worker.is_alive()
    assert q.requests_served == len(bs) and q.batches_run < len(bs)
    for b, r in zip(bs, out):
        f64 = dataclasses.replace(pt, b=b).objective_np(r.x)
        assert abs(float(r.objective) - f64) <= 1e-4 * max(1.0, f64)


def test_slice_result_keeps_refine_and_eq_fields():
    """Intended deviation: the per-request view keeps refine's seconds and
    certificate and the eq fields (the batch's violation and rho, scenario
    i's multipliers), which the reference drops; the rest is the
    reference's view."""
    S, n, p = 4, 6, 3
    rng = np.random.default_rng(0)
    kw = dict(x=rng.random((S, n)), objective=rng.random(S), gap=rng.random(S),
              iterations=7, converged=True, trace_f=rng.random((S, 5)),
              trace_gap=rng.random((S, 5)), chunk_times=np.ones(2), chunk_iters=np.arange(2),
              stop_reason="gap")
    res = SolveResult(**kw, refine_secs=1.5, refine_fw_gap=2e-9, eq_violation=3e-7,
                      eq_lam=rng.random((S, p)), eq_rho=40.0)
    ref = JS._slice_result(JS.SolveResult(**kw), 2)
    got = TS._slice_result(res, 2)
    for f in ("x", "objective", "gap", "iterations", "converged", "trace_f", "trace_gap",
              "chunk_times", "chunk_iters", "stop_reason"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert (got.refine_secs, got.refine_fw_gap, got.eq_violation, got.eq_rho) == (
        1.5, 2e-9, 3e-7, 40.0)
    np.testing.assert_array_equal(got.eq_lam, res.eq_lam[2])
    assert TS._slice_result(SolveResult(**kw), 1).eq_lam is None


def _eq_instance(syn):
    prob = syn.traffic_like(num_blocks=30, m=150, num_eq=8, noise=0.05)
    # shifted targets: the constraints conflict with the fit (multipliers O(1))
    return dataclasses.replace(prob, d=np.asarray(prob.d) * 1.05 + 0.01)


@pytest.fixture(scope="module")
def eq_first():
    """The port's eq endpoint after one converged request."""
    prob = _eq_instance(tsyn)
    ep = TS.Endpoint(prob, method="apgd", chunk=50, device="cpu")
    with threadpool_limits(1):
        r1 = ep.solve(np.asarray(prob.b), tol=1e-7, max_iter=4000)
    return prob, ep, r1


def test_endpoint_eq_warm_multiplier_cache(eq_first, monkeypatch):
    """The converged AL state is cached per batch shape; the next request
    warm-starts lambda and x from it but not rho, reuses the one prepared
    stacked operator, and converges no slower than a cold request."""
    prob, ep, r1 = eq_first
    assert r1.converged and r1.eq_violation <= 1e-4
    assert np.abs(r1.eq_lam).max() > 1.0, "constraints should be active"
    warm = ep._eq_warm[()]
    np.testing.assert_array_equal(warm["lam"], r1.eq_lam)
    np.testing.assert_array_equal(warm["x"], r1.x)
    assert warm["rho"] == r1.eq_rho and len(ep._eq_ops) == 1
    seen = []
    real = TEQ.solve_equality_constrained

    def spy(problem, **kw):
        seen.append(kw)
        return real(problem, **kw)

    monkeypatch.setattr(TEQ, "solve_equality_constrained", spy)
    b1 = np.asarray(prob.b) * (1.0 + 1e-3 * np.random.default_rng(0).standard_normal(150))
    r2 = ep.solve(b1, tol=1e-7, max_iter=4000, sensitivity=False)
    (kw,) = seen
    assert kw["lam0"] is warm["lam"] and kw["x0"] is warm["x"]
    assert "rho_init" not in kw and kw["op_cache"] is ep._eq_ops and len(ep._eq_ops) == 1
    assert r2.stop_reason != "sensitivity" and r2.eq_violation <= 1e-4
    cold = TS.Endpoint(prob, method="apgd", chunk=50, warm_start=False, device="cpu")
    r2c = cold.solve(b1, tol=1e-7, max_iter=4000)
    assert r2.iterations <= r2c.iterations, (r2.iterations, r2c.iterations)
    assert float(r2.objective) <= float(r2c.objective) * 1.5 + 1e-6


def test_endpoint_eq_sensitivity_fast_path_matches_reference(eq_first):
    """From one warm state (the port's converged request, handed to the
    reference's endpoint), both packages' float64 host walks take the fast
    path and land on the same x; the result holds the constraints and ships
    its certificate, and feeds the warm cache for the next request."""
    prob, ep_first, _ = eq_first
    ep = TS.Endpoint(prob, method="apgd", chunk=50, device="cpu")
    ep_ref = JS.Endpoint(_eq_instance(jsyn), method="apgd", chunk=50)
    for e in (ep, ep_ref):
        e._eq_warm = {k: dict(v) for k, v in ep_first._eq_warm.items()}
    rng = np.random.default_rng(1)
    b1 = np.asarray(prob.b) * (1.0 + 2e-2 * rng.standard_normal(150))
    r2 = ep.solve(b1, tol=1e-7, max_iter=4000)
    ref = ep_ref.solve(b1, tol=1e-7, max_iter=4000)
    assert r2.stop_reason == ref.stop_reason == "sensitivity"
    assert r2.converged and r2.eq_violation <= 1e-7
    assert r2.refine_fw_gap is not None and r2.refine_fw_gap <= 1e-6
    np.testing.assert_allclose(r2.x, np.asarray(ref.x), rtol=0, atol=SENS_X_ATOL)
    assert not ep._eq_ops, "the fast path prepares nothing on the device"
    b2 = b1 * (1.0 + 1e-2 * rng.standard_normal(150))
    r4 = ep.solve(b2, tol=1e-7, max_iter=4000)
    assert r4.stop_reason == "sensitivity" and r4.eq_violation <= 1e-7


@pytest.mark.slow
def test_endpoint_eq_operator_cache(monkeypatch):
    """Streaming eq requests share ONE prepared stacked operator: the second
    request runs no prepare and still matches a fresh endpoint's solve."""
    import bsls_tpu_torch.ops.layout as TL

    prob = tsyn.traffic_like(num_blocks=30, m=150, num_eq=8, noise=0.05)
    ep = TS.Endpoint(prob, method="apgd", chunk=50, warm_start=False, device="cpu")
    calls = {"n": 0}
    real_prepare = TL.prepare

    def counting_prepare(*a, **k):
        calls["n"] += 1
        return real_prepare(*a, **k)

    monkeypatch.setattr(TL, "prepare", counting_prepare)
    b0 = np.asarray(prob.b)
    ep.solve(b0, tol=1e-7, max_iter=3000)
    n_first = calls["n"]
    assert n_first >= 1
    b1 = b0 * (1.0 + 1e-3 * np.random.default_rng(0).standard_normal(b0.shape))
    r2 = ep.solve(b1, tol=1e-7, max_iter=3000)
    assert calls["n"] == n_first, "second request re-prepared the operator"
    assert r2.eq_violation <= 1e-4
    monkeypatch.setattr(TL, "prepare", real_prepare)
    r2f = TS.Endpoint(prob, method="apgd", chunk=50, warm_start=False,
                      device="cpu").solve(b1, tol=1e-7, max_iter=3000)
    np.testing.assert_allclose(float(r2.objective), float(r2f.objective), rtol=1e-4, atol=1e-7)
