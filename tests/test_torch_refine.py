"""certify and refine of the PyTorch port, against ``bsls_tpu`` and the
float64 oracle: the reference's own tests of both (same instances, same
limits), the polish on the banded layout, the device CG and a whole polish
against the reference's from the same solve result, and the float64 host
SpMM against scipy."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu
import bsls_tpu.ops.layout as JL
import bsls_tpu.solvers.base as JB
import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.layout as TL
import bsls_tpu_torch.solvers.base as TB
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu_torch.convert import device_problem_from_numpy
from bsls_tpu_torch.models import synthetic as tsyn
from torch_port_helpers import flatten_device_problem, small_instance
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _relgap(f, fstar):
    return (f - fstar) / max(1.0, abs(fstar))


def _feasible(x, sizes, atol):
    off = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    assert np.all(x >= -1e-12)
    np.testing.assert_allclose(np.add.reduceat(x, off, axis=-1), 1.0, atol=atol)


@pytest.fixture(scope="module")
def medium400():
    prob = tsyn.medium_sparse(seed=0, num_blocks=400, m=3000)
    return prob, bt.oracle_solve(prob, tol_gap=1e-10, max_iter=40000)


# ------------------------------------------------------------ certify


@pytest.mark.slow
def test_certify_polish_tightens_gap():
    """certify=K runs a pairwise-FW polish that tightens the duality-gap
    certificate by orders of magnitude at equal-or-better objective."""
    prob = tsyn.medium_sparse(seed=0, num_blocks=400, m=3000)
    orc = bt.oracle_solve(prob, tol_gap=1e-9, max_iter=30000)
    kw = dict(method="pgd", line_search="bbm", tol=1e-8, max_iter=2000, device="cpu")
    r0 = bt.solve(prob, **kw)
    r1 = bt.solve(prob, certify=150, **kw)
    assert float(r1.gap) < 0.1 * float(r0.gap), (r1.gap, r0.gap)
    assert float(r1.objective) <= float(r0.objective) + 1e-6
    # the certificate is sound: f - f* <= gap
    assert float(r1.objective) - orc.objective <= float(r1.gap) + 1e-6


@pytest.mark.parametrize("kind,scenarios", [("dense", 1), ("ell", 3)])
def test_certify_matches_reference(kind, scenarios):
    """The same main solve and 30 afw steps after it (within the afw trace
    horizon of tests/test_torch_families.py), in both packages."""
    pt, pj = small_instance(tsyn, kind, scenarios), small_instance(jsyn, kind, scenarios)
    dpt = bt.prepare(pt, layout="gather", device="cpu")
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=200, chunk=100,
              lipschitz=TB.power_lipschitz(dpt))
    plain = bt.solve(dpt, **kw)
    res = bt.solve(dpt, certify=30, **kw)
    ref = bsls_tpu.solve(JL.prepare(pj, layout="gather"), certify=30, **kw)
    np.testing.assert_allclose(res.objective, ref.objective, rtol=1e-4)
    np.testing.assert_allclose(res.gap, ref.gap, rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(res.x, ref.x, atol=1e-4)
    # the main trace is the main solve's; the polish replaced the final state
    np.testing.assert_array_equal(res.trace_f, plain.trace_f)
    assert np.all(res.objective <= plain.objective + 1e-6 * np.abs(plain.objective))
    assert np.all(res.gap < plain.gap)


def test_certify_is_all_or_nothing(monkeypatch):
    """One scenario whose polish came out worse keeps EVERY scenario's main
    state, as in the reference."""
    import bsls_tpu_torch.solvers.frank_wolfe as TFW

    prob = small_instance(tsyn, "ell", 3)
    dp = bt.prepare(prob, layout="gather", device="cpu")
    kw = dict(method="pgd", tol=0.0, max_iter=100, lipschitz=TB.power_lipschitz(dp))
    plain = bt.solve(dp, **kw)
    good = bt.solve(dp, certify=20, **kw)
    assert np.all(good.gap < plain.gap)
    real_step = TFW.step

    def spoiled(dp_, st, L_est, opts):  # scenario 1's polish ends higher
        out = real_step(dp_, st, L_est, opts)
        bump = torch.tensor([0.0, 1e4, 0.0], dtype=out.f.dtype)
        return TFW.FWState(xp=out.xp, r=out.r, f=out.f + bump, gap=out.gap, k=out.k,
                           qp=out.qp)

    monkeypatch.setattr(TFW, "step", spoiled)
    bad = bt.solve(dp, certify=20, **kw)
    np.testing.assert_array_equal(bad.objective, plain.objective)
    np.testing.assert_array_equal(bad.gap, plain.gap)
    np.testing.assert_array_equal(bad.x, plain.x)


# ------------------------------------------------------------ refine


@pytest.mark.slow
def test_refine_polish_breaks_fp32_floor(medium400):
    prob, orc = medium400
    kw = dict(method="lbfgs", tol=0.0, max_iter=1200, chunk=100, device="cpu")
    r0 = bt.solve(prob, **kw)
    f0 = float(prob.objective_np(np.asarray(r0.x, np.float64)))
    r1 = bt.solve(prob, refine=3, **kw)
    f1, fs = float(r1.objective), orc.objective
    assert f1 <= f0 + 1e-12  # never worse
    assert (f1 - fs) / max(fs, 1e-30) < 1e-7, (f1, f0, fs)
    _feasible(np.asarray(r1.x), prob.partition.sizes, atol=1e-9)


def test_refine_polish_multi_rhs():
    """Multi-RHS refine: each scenario gets its own anchor/active set/step;
    every refined objective is <= the plain one and near its own optimum."""
    prob = tsyn.with_scenarios(tsyn.tiny_dense(num_blocks=20, m=100), 3)
    r0 = bt.solve(prob, method="lbfgs", tol=0.0, max_iter=400, device="cpu")
    f0 = prob.objective_np(np.asarray(r0.x, np.float64))
    r1 = bt.solve(prob, method="lbfgs", tol=0.0, max_iter=400, refine=6, device="cpu")
    f1 = np.asarray(r1.objective)
    assert f1.shape == (3,) and r1.x.dtype == np.float64 and r1.refine_secs > 0
    assert np.all(f1 <= f0 + 1e-12)
    for s in range(3):
        single = bt.Problem(A=prob.A, b=prob.b[s], partition=prob.partition)
        fs = bt.oracle_solve(single, tol_gap=1e-11, max_iter=30000).objective
        assert (f1[s] - fs) / max(fs, 1e-30) < 1e-6, (s, f1[s], fs)
    _feasible(r1.x, prob.partition.sizes, atol=1e-9)


def test_refine_tol_certificate_is_sound(medium400):
    prob, orc = medium400
    res = bt.solve(prob, method="lbfgs", tol=0.0, max_iter=1200, chunk=100, refine=8,
                   refine_tol=1e-6, device="cpu")
    assert res.refine_fw_gap is not None
    assert _relgap(float(res.objective), orc.objective) <= res.refine_fw_gap + 1e-12


def test_refine_tol_alone_defaults_round_cap():
    prob = tsyn.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
    res = bt.solve(prob, method="pgd", line_search="bb", max_iter=400, refine_tol=1e-7,
                   device="cpu")
    assert res.refine_fw_gap is not None and res.refine_fw_gap <= 1e-7
    # at most the default cap of rounds ran, each of >= 200 CG iterations
    assert res.iterations - 400 <= TB.DEFAULT_REFINE_ROUNDS * 1600


def test_refine_tol_stops_early_when_certified():
    prob = tsyn.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
    base = bt.solve(prob, method="lbfgs", tol=0.0, max_iter=400, device="cpu")
    res = bt.solve(prob, method="lbfgs", tol=0.0, max_iter=400, refine=20, refine_tol=1e-7,
                   device="cpu")
    rounds_run = (res.iterations - base.iterations) / 200
    assert res.refine_fw_gap is not None and res.refine_fw_gap <= 1e-7
    assert rounds_run < 20, rounds_run


def test_refine_host_toggle(monkeypatch):
    """BSLS_REFINE_HOST=1 forces the host f64 PCG path for plain refine=K."""
    monkeypatch.setenv("BSLS_REFINE_HOST", "1")
    prob = tsyn.tiny_dense(seed=3)
    res = bt.solve(prob, method="pgd", line_search="bb", tol=0.0, max_iter=600, refine=3,
                   device="cpu")
    orc = bt.oracle_solve(prob, tol_gap=1e-10, max_iter=20000)
    assert _relgap(float(res.objective), orc.objective) <= 1e-6
    # the host path counts its (larger) CG budget per round
    assert res.iterations > 600 and (res.iterations - 600) % 30 == 0


def test_refine_rejects_a_device_problem():
    prob = tsyn.tiny_dense(num_blocks=4, dim=3, m=10)
    with pytest.raises(ValueError, match="host Problem"):
        bt.solve(bt.prepare(prob, device="cpu"), refine=2)


def test_refine_on_the_banded_layout():
    """The device CG through the banded layout's products (flat_to_padded,
    matvec/rmatvec, perm of the value-grouped partition)."""
    prob = tsyn.medium_banded(seed=2, num_blocks=80, m=800, spread=40)
    dp = bt.prepare(prob, device="cpu")
    assert isinstance(dp.A, bt.ops.DeviceBanded)
    orc = bt.oracle_solve(prob, tol_gap=1e-11, max_iter=20000)
    res = bt.solve(dp, method="lbfgs", tol=0.0, max_iter=400)
    f0 = prob.objective_np(res.x)
    pol = TB.refine_polish(prob, dp, res, rounds=3)
    assert float(pol.objective) <= f0 + 1e-12
    assert _relgap(float(pol.objective), orc.objective) <= 1e-8
    assert _relgap(f0, orc.objective) > 1e-6  # the polish did the work
    _feasible(pol.x, prob.partition.sizes, atol=1e-9)


@pytest.mark.parametrize("host", [False, True])
def test_refine_polish_matches_reference(host, monkeypatch):
    """Both packages polish the same fp32 result: the host code is the same,
    the correction (device CG in fp32, or host PCG in f64) too."""
    if host:
        monkeypatch.setenv("BSLS_REFINE_HOST", "1")
    pt, pj = small_instance(tsyn, "ell", 3), small_instance(jsyn, "ell", 3)
    dj = JL.prepare(pj, layout="gather")
    dt = device_problem_from_numpy(flatten_device_problem(dj), device="cpu")
    res = bt.solve(dt, method="lbfgs", tol=0.0, max_iter=300, lipschitz=TB.power_lipschitz(dt))
    ref_in = JB.SolveResult(x=res.x, objective=res.objective, gap=res.gap,
                            iterations=res.iterations, converged=False, trace_f=res.trace_f,
                            trace_gap=res.trace_gap, chunk_times=res.chunk_times,
                            chunk_iters=res.chunk_iters)
    got = TB.refine_polish(pt, dt, res, rounds=4)
    want = JB.refine_polish(pj, dj, ref_in, rounds=4)
    assert got.iterations == want.iterations
    f0 = pt.objective_np(res.x)
    assert np.all(got.objective <= f0 + 1e-12)
    # rel to the distance the polish travelled, as the correction's fp32 CG
    # sums in another order
    np.testing.assert_allclose(got.objective, want.objective,
                               rtol=1e-12 if host else 1e-9)
    np.testing.assert_allclose(got.x, want.x, atol=1e-10 if host else 1e-6)


def test_polish_cg_matches_reference():
    pj = small_instance(jsyn, "ell", 3)
    dj = JL.prepare(pj, layout="gather")
    dt = device_problem_from_numpy(flatten_device_problem(dj), device="cpu")
    rng = np.random.default_rng(11)
    free = (rng.random((3, dt.n_pf)) < 0.7).astype(np.float32) * (np.asarray(dj.perm) >= 0)
    g0t = (rng.standard_normal((3, dt.n_pf)) * 1e-3).astype(np.float32) * free
    got = TB._polish_cg(dt, torch.tensor(free), torch.tensor(g0t), 30).numpy()
    want = np.asarray(JB._polish_cg_batch(dj, jnp.asarray(free), jnp.asarray(g0t), 30))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3 * np.abs(want).max())
    # the correction stays in the tangent space: free coords only, and a zero
    # sum per block up to the fp32 rounding of 30 accumulated CG updates,
    # which the reference's correction carries as well
    assert not got[free == 0].any()

    def worst_block_sum(d):
        return max(float((v * f).sum(-1).abs().max()) for v, f in zip(
            TL.flat_to_padded(dt, torch.tensor(d)), TL.flat_to_padded(dt, torch.tensor(free))))

    assert worst_block_sum(got) <= 1e-5 * np.abs(got).max()


@pytest.mark.parametrize("S", [1, 5])
def test_csr_matmat_f64_matches_scipy(S):
    import scipy.sparse as sp

    from bsls_tpu_torch.native import csr_matmat_f64, native_available
    from bsls_tpu_torch.utils.hostops import host_matmat_ops

    M = sp.random(300, 200, density=0.05, random_state=S, format="csr", dtype=np.float64)
    X = np.random.default_rng(S).standard_normal((S, 200))
    Y = csr_matmat_f64(M.indptr.astype(np.int64), M.indices.astype(np.int32), M.data, 300, X)
    if not native_available():
        assert Y is None
        return
    np.testing.assert_allclose(Y, (M @ X.T).T, rtol=1e-13, atol=1e-13)
    prob = tsyn.medium_sparse(seed=1, num_blocks=30, m=200)
    mm, rmm = host_matmat_ops(prob.A)
    A = prob.A.to_scipy().astype(np.float64)
    Xn = np.random.default_rng(0).standard_normal((S, A.shape[1]))
    np.testing.assert_allclose(mm(Xn), (A @ Xn.T).T, rtol=1e-12, atol=1e-12)
    R = np.random.default_rng(1).standard_normal((S, A.shape[0]))
    np.testing.assert_allclose(rmm(R), (A.T @ R.T).T, rtol=1e-12, atol=1e-12)
    assert os.environ.get("BSLS_NO_NATIVE") != "1"
