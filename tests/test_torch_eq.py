"""The equality-constrained path of the PyTorch port against ``bsls_tpu`` on
seeded inputs: the stacked operator on the host (``VStackMatrix``,
``ScaledMatrix``) and on the device (``DeviceVStack``), the float64 host
layer (``prox_bpp_polish`` with its dense and projected-PCG face solves,
``eq_multiplier_polish``, ``eq_dual_bound``, ``solve_eq_sensitivity``), the
oracle ``oracle_solve_eq``, and the augmented-Lagrangian loop itself with the
reference's stacked operator and Lipschitz constants handed across (in
float64 over every outer, in float32 over the first), its budget, ``refine``
and ``refine_tol``, and what ``solve`` rejects."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from threadpoolctl import threadpool_limits

import bsls_tpu
import bsls_tpu.ops.layout as JL
import bsls_tpu.solvers.eq_constrained as JEQ
import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.layout as TL
import bsls_tpu_torch.solvers.base as TB
import bsls_tpu_torch.solvers.eq_constrained as TEQ
from bsls_tpu.models import problem as jprob
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu.models.oracle import oracle_solve_eq as j_oracle_eq
from bsls_tpu_torch.convert import al_state_from_numpy, device_problem_from_numpy
from bsls_tpu_torch.models import problem as tprob
from bsls_tpu_torch.models import synthetic as tsyn
from torch_port_helpers import KERNELS, flatten_device_problem
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# float64 on both sides, the same numpy/scipy code: host results agree to
# rounding of sums taken in the same order
HOST_RTOL = 1e-9
# the AL loop in float64 on both sides, with the same stacked operator and
# Lipschitz constants: x after every outer
AL_X_ATOL = 1e-8
# fp32 on both sides with sums in another order: the first outer's trace
# (pgd/exact, which does not amplify rounding: ROADMAP.md queue 3)
F32_TRACE_RTOL = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """Each test in one torch and one BLAS thread: beside the other test
    workers, multi-threaded small products spin against them and run many
    times slower (the instances here are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpool_limits(1):
            yield
    finally:
        torch.set_num_threads(n)


def _pair(fn, **kw):
    """The same seeded instance from both packages."""
    return fn(tsyn, **kw), fn(jsyn, **kw)


def small(syn, seed=0, scenarios=1, **kw):
    kw = {"num_blocks": 12, "m": 60, "num_eq": 4, **kw}
    prob = syn.traffic_like(seed=seed, **kw)
    return prob if scenarios == 1 else syn.with_scenarios(prob, scenarios, seed=4)


def perturbed(syn):
    """The instance of the reference's test_eq_oracle_direct_vs_al: noisy
    counts and targets moved off the planted flow."""
    prob = syn.traffic_like(seed=3, num_blocks=30, m=150, num_eq=8, noise=0.3)
    return dataclasses.replace(prob, d=np.asarray(prob.d) * 1.05 + 0.01)


def _sparse_c(prob, pkg):
    """The instance with a sparse (ELL) C of 6 rows and targets that the
    planted flow meets."""
    rng = np.random.default_rng(3)
    C = sp.random(6, prob.A.shape[1], density=0.15, random_state=rng, format="csr")
    return pkg.Problem.from_arrays(prob.A, prob.b, prob.partition.sizes, C=C,
                                   d=C @ prob.x_true)


class Recorder:
    """A metrics sink that keeps the "outer" records."""

    def __init__(self):
        self.outer = []

    def log(self, kind, **fields):
        if kind == "outer":
            self.outer.append(fields)


# ------------------------------------------------------------ host operators


@pytest.mark.parametrize("c_kind", ["dense", "ell"])
def test_stacked_host_operators_match_the_reference(c_kind):
    pt, pj = _pair(small)
    if c_kind == "ell":
        pt, pj = _sparse_c(pt, bt), _sparse_c(pj, bsls_tpu)
        assert isinstance(pt.C, tprob.EllMatrix)
    st = tprob.VStackMatrix(top=pt.A, bottom=tprob.ScaledMatrix(pt.C, 1.7))
    sj = jprob.VStackMatrix(top=pj.A, bottom=jprob.ScaledMatrix(pj.C, 1.7))
    rng = np.random.default_rng(0)
    x = rng.standard_normal(st.shape[1])
    r = rng.standard_normal(st.shape[0])
    assert st.shape == sj.shape == (pt.A.shape[0] + pt.C.shape[0], pt.A.shape[1])
    np.testing.assert_allclose(st.matvec(x), sj.matvec(x), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st.rmatvec(r), sj.rmatvec(r), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(st.to_scipy().toarray(), sj.to_scipy().toarray(),
                               rtol=1e-12, atol=0)
    np.testing.assert_allclose(st.to_scipy() @ x, st.matvec(x), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(TL._col_norms_sq(st), JL._col_norms_sq(sj), rtol=1e-12)


# ------------------------------------------------------------ device operator


def _stacked(pkg, prob, scale):
    b_bot = np.zeros(np.shape(prob.b)[:-1] + (prob.C.shape[0],))
    return pkg.Problem(
        A=pkg.models.problem.VStackMatrix(
            top=prob.A, bottom=pkg.models.problem.ScaledMatrix(prob.C, scale)),
        b=np.concatenate([np.asarray(prob.b), b_bot], axis=-1),
        partition=prob.partition)


@pytest.mark.parametrize("scenarios", [1, 3])
def test_device_vstack_products_match_the_reference(scenarios):
    pt, pj = _pair(small, scenarios=scenarios)
    dj = JL.prepare(_stacked(bsls_tpu, pj, 2.5))
    dt = TL.prepare(_stacked(bt, pt, 2.5), device="cpu")
    # layout="auto" keeps the gather layout for a stacked operator, as the
    # reference: only an EllMatrix tries the band
    assert isinstance(dt.A, TL.DeviceVStack) and isinstance(dj.A, JL.DeviceVStack)
    assert isinstance(dt.A.top, TL.DeviceEll) and isinstance(dt.A.bottom, TL.DeviceDense)
    assert dt.A.top.rt_rows is None and dt.row_perm is None and dt.A.split == pt.A.shape[0]
    fj, ft = flatten_device_problem(dj), flatten_device_problem(dt)
    assert sorted(fj) == sorted(ft)
    for key, a in fj.items():
        if isinstance(a, np.ndarray):
            np.testing.assert_allclose(ft[key], a, rtol=1e-6, atol=0, err_msg=key)
        else:
            assert ft[key] == a, key
    # the reference's arrays carried across; then a new penalty scale swapped
    # in as a 0-d tensor, without a new prepare
    dc = device_problem_from_numpy(fj, device="cpu")
    rng = np.random.default_rng(1)
    lead = (scenarios,) if scenarios > 1 else ()
    x = rng.standard_normal(lead + (dt.n_pf,)).astype(np.float32)
    r = rng.standard_normal(lead + (dt.num_rows,)).astype(np.float32)
    for scale in (2.5, 0.3):
        A_t = dataclasses.replace(dc.A, bottom_scale=torch.tensor(scale, dtype=torch.float32))
        A_j = dataclasses.replace(dj.A, bottom_scale=jnp.asarray(scale, jnp.float32))
        if scenarios > 1:
            mv_j = jax.vmap(lambda v: JL.matvec(A_j, v))(jnp.asarray(x))
            rmv_j = jax.vmap(lambda v: JL.rmatvec(A_j, v))(jnp.asarray(r))
        else:
            mv_j, rmv_j = JL.matvec(A_j, jnp.asarray(x)), JL.rmatvec(A_j, jnp.asarray(r))
        mv_t = TL.matvec(A_t, torch.tensor(x)).numpy()
        rmv_t = TL.rmatvec(A_t, torch.tensor(r)).numpy()
        for got, want in ((mv_t, np.asarray(mv_j)), (rmv_t, np.asarray(rmv_j))):
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_prepare_of_an_eq_problem_points_to_solve():
    pt = small(tsyn)
    with pytest.raises(ValueError, match=r"solve\(\)"):
        TL.prepare(pt, device="cpu")
    with pytest.raises(ValueError, match="banded"):
        TL.prepare(_stacked(bt, pt, 1.0), layout="banded", device="cpu")


# ------------------------------------------------------------ float64 host layer


@pytest.fixture(scope="module")
def polished_pair():
    """prox_bpp_polish from the planted flow on the perturbed instance, in
    both packages (dense face solves)."""
    pt, pj = _pair(lambda s: perturbed(s))
    x0 = np.asarray(pt.x_true, np.float64)
    return pt, pj, x0, TEQ.prox_bpp_polish(pt, x0), JEQ.prox_bpp_polish(pj, x0)


def test_prox_bpp_polish_matches_the_reference(polished_pair):
    pt, pj, x0, (xt, lt, okt), (xj, lj, okj) = polished_pair
    assert okt and okj
    np.testing.assert_allclose(xt, xj, rtol=HOST_RTOL, atol=HOST_RTOL)
    np.testing.assert_allclose(lt, lj, rtol=HOST_RTOL, atol=HOST_RTOL * np.abs(lj).max())
    bt_, bj_ = TEQ.eq_dual_bound(pt, xt, lt), JEQ.eq_dual_bound(pj, xj, lj)
    assert bt_ == pytest.approx(bj_, rel=HOST_RTOL, abs=1e-14) and bt_ <= 1e-7


def test_prox_bpp_polish_face_pcg_matches_the_reference(polished_pair):
    """dense_kkt=0: every face solve by the projected PCG (_face_pcg)."""
    pt, pj, x0, (xd, ld, _), _ = polished_pair
    xt, lt, okt = TEQ.prox_bpp_polish(pt, x0, dense_kkt=0)
    xj, lj, okj = JEQ.prox_bpp_polish(pj, x0, dense_kkt=0)
    assert okt and okj
    np.testing.assert_allclose(xt, xj, rtol=HOST_RTOL, atol=HOST_RTOL)
    np.testing.assert_allclose(lt, lj, rtol=HOST_RTOL, atol=HOST_RTOL * np.abs(lj).max())
    # the same KKT point as the dense face solves, to the certificate
    assert TEQ.eq_dual_bound(pt, xt, lt) <= 1e-7
    fd, fs = pt.objective_np(xd), pt.objective_np(xt)
    assert abs(fd - fs) <= 1e-7 * max(1.0, abs(fd))


def test_multiplier_polish_and_dual_bound_match_the_reference(polished_pair):
    pt, pj, x0, (x, lam, _), _ = polished_pair
    lt, lj = TEQ.eq_multiplier_polish(pt, x), JEQ.eq_multiplier_polish(pj, x)
    np.testing.assert_allclose(lt, lj, rtol=HOST_RTOL, atol=HOST_RTOL * np.abs(lj).max())
    for lam_in in (lam, np.zeros_like(lam), lt):
        assert TEQ.eq_dual_bound(pt, x, lam_in) == pytest.approx(
            JEQ.eq_dual_bound(pj, x, lam_in), rel=HOST_RTOL, abs=1e-14)
    # stale multipliers certify loosely, the refit ones tightly: both sound
    assert TEQ.eq_dual_bound(pt, x, np.zeros_like(lam)) > 1e3 * TEQ.eq_dual_bound(pt, x, lt)
    # multi-RHS: (S, N) iterates give (S, p) multipliers and the worst bound
    X = np.stack([x, x0])
    pm = dataclasses.replace(pt, b=np.stack([pt.b, pt.b]))
    pmj = dataclasses.replace(pj, b=np.stack([pj.b, pj.b]))
    np.testing.assert_allclose(TEQ.eq_multiplier_polish(pm, X),
                               JEQ.eq_multiplier_polish(pmj, X), rtol=HOST_RTOL,
                               atol=HOST_RTOL * np.abs(lj).max())
    L2 = np.stack([lam, lam])
    assert TEQ.eq_dual_bound(pm, X, L2) == pytest.approx(JEQ.eq_dual_bound(pmj, X, L2),
                                                         rel=HOST_RTOL)


def test_solve_eq_sensitivity_matches_the_reference(polished_pair):
    """A nearby right-hand side from the converged point: the sensitivity
    fast path walks to the new KKT point and certifies it."""
    pt, pj, x0, (x, _, _), _ = polished_pair
    b2 = np.asarray(pt.b) * 1.02
    rt = TEQ.solve_eq_sensitivity(dataclasses.replace(pt, b=b2), x, rho=3.0)
    rj = JEQ.solve_eq_sensitivity(dataclasses.replace(pj, b=b2), x, rho=3.0)
    assert rt is not None and rj is not None
    assert rt.stop_reason == rj.stop_reason == "sensitivity" and rt.converged
    np.testing.assert_allclose(rt.x, rj.x, rtol=HOST_RTOL, atol=HOST_RTOL)
    assert rt.objective == pytest.approx(rj.objective, rel=HOST_RTOL)
    assert rt.eq_violation == pytest.approx(rj.eq_violation, rel=1e-6, abs=1e-15)
    assert rt.eq_rho == 3.0 and rt.refine_fw_gap <= 1e-7
    np.testing.assert_allclose(rt.eq_lam, rj.eq_lam, rtol=HOST_RTOL,
                               atol=HOST_RTOL * np.abs(rj.eq_lam).max())


def test_face_pcg_raises_on_a_block_without_weight():
    """Intended deviation: where a block has no free coordinate, the
    reference clamps its weight at 1e-300 and solves another system; the
    port names the block."""
    rng = np.random.default_rng(0)
    AF = sp.csr_matrix(rng.standard_normal((8, 5)))
    CF = sp.csr_matrix(rng.standard_normal((2, 5)))
    bids = np.array([0, 0, 1, 1, 1])  # block 2 of 3 has no free coordinate
    args = (AF, CF, bids, 3, rng.standard_normal(8), rng.standard_normal(2),
            np.full(5, 0.4), 1e-3, np.full(5, 0.4))
    with pytest.raises(ValueError, match="block 2"):
        TEQ._face_pcg(*args)
    y, mu = JEQ._face_pcg(*args)  # the reference goes on
    assert y.shape == (5,)


# ------------------------------------------------------------ the oracle


def test_oracle_solve_eq_matches_the_reference():
    """direct (the active-set finisher, certified) and a short AL run."""
    pt, pj = _pair(lambda s: perturbed(s))
    ot = bt.oracle_solve_eq(pt, tol_eq=1e-10, tol_gap=1e-11)
    oj = j_oracle_eq(pj, tol_eq=1e-10, tol_gap=1e-11)
    assert ot.objective == pytest.approx(oj.objective, rel=HOST_RTOL)
    np.testing.assert_allclose(ot.x, oj.x, rtol=HOST_RTOL, atol=HOST_RTOL)
    assert ot.eq_violation <= 1e-10 and ot.gap <= 1e-6 * max(1.0, abs(ot.objective))
    at = bt.oracle_solve_eq(pt, tol_eq=1e-10, tol_gap=1e-11, direct=False, max_outer=2,
                            inner_iter=1500)
    aj = j_oracle_eq(pj, tol_eq=1e-10, tol_gap=1e-11, direct=False, max_outer=2,
                     inner_iter=1500)
    assert at.iterations == aj.iterations
    assert at.objective == pytest.approx(aj.objective, rel=HOST_RTOL)
    assert at.gap == pytest.approx(aj.gap, rel=1e-6)
    assert at.eq_violation == pytest.approx(aj.eq_violation, rel=1e-6)
    # two outers leave the AL point infeasible; the active-set point is not
    assert at.eq_violation > 1e3 * ot.eq_violation


@pytest.mark.slow
def test_eq_oracle_direct_vs_al():
    """The reference's slow test of the same name, on the port: the direct
    mode matches or beats the full AL path with a bound that certifies."""
    prob = perturbed(tsyn)
    o_d = bt.oracle_solve_eq(prob, tol_eq=1e-10, tol_gap=1e-11)
    o_al = bt.oracle_solve_eq(prob, tol_eq=1e-10, tol_gap=1e-11, direct=False)
    ref = max(1.0, abs(o_al.objective))
    assert o_d.objective <= o_al.objective + 1e-8 * ref
    assert o_d.eq_violation <= 1e-10
    assert o_d.gap <= 1e-6 * ref


def test_oracle_of_one_scenario_uses_its_own_b():
    """Repaired fault: the objective of scenario s is taken against b[s]
    (the reference evaluates it against the whole (S, m) b and raises)."""
    prob = tsyn.with_scenarios(tsyn.tiny_dense(seed=3, num_blocks=12, dim=5, m=64), 3, seed=4)
    o1 = bt.oracle_solve(prob, scenario=1, max_iter=400)
    r = prob.A.matvec(o1.x) - prob.b[1]
    assert o1.objective == pytest.approx(0.5 * float(r @ r), rel=1e-12)
    single = dataclasses.replace(prob, b=prob.b[1])
    assert bt.oracle_solve(single, max_iter=400).objective == pytest.approx(o1.objective,
                                                                            rel=1e-12)
    # and through the eq oracle of a problem without C
    assert bt.oracle_solve_eq(prob, scenario=1, inner_iter=400).objective == pytest.approx(
        o1.objective, rel=1e-12)
    eq = small(tsyn, scenarios=2)
    o_eq = bt.oracle_solve_eq(eq, scenario=1, tol_eq=1e-9)
    re = eq.A.matvec(o_eq.x) - eq.b[1]
    assert o_eq.objective == pytest.approx(0.5 * float(re @ re), rel=1e-12)
    assert o_eq.eq_violation <= 1e-8
    assert np.abs(eq.C.matvec(o_eq.x) - eq.d[1]).max() <= 1e-8 * max(1.0, np.abs(eq.d[1]).max())


# ------------------------------------------------------------ the AL loop


def _al_pair(pt, pj, f64, method="pgd", line_search="exact", **kw):
    """The AL loop in both packages with the same stacked operator and the
    same Lipschitz constants: the reference runs first and fills its
    op_cache; its prepared operator is carried across (convert.py) into the
    port's op_cache under the port's key, with the same constants."""
    tdt, jdt = (torch.float64, jnp.float64) if f64 else (torch.float32, jnp.float32)
    common = dict(method=method, line_search=line_search, chunk=50, **kw)
    mj, mt = Recorder(), Recorder()
    with jax.enable_x64(f64):
        jcache = {}
        ref = JEQ.solve_equality_constrained(pj, dtype=jdt, op_cache=jcache, metrics=mj,
                                             **common)
        (dpj, rho_base, L_base, LC), = jcache.values()
        d = flatten_device_problem(dpj)
    dp = device_problem_from_numpy(d, device="cpu", dtype=tdt)
    tcache = {TEQ.op_cache_key(pt, tdt, method, line_search, "cpu"): TEQ.EqInstance.of(
        pt, "cpu", place=TB.OneCard(dp, keep_x=True), rho_base=rho_base,
        L_base=float(L_base), LC=float(LC))}
    res = TEQ.solve_equality_constrained(pt, dtype=tdt, op_cache=tcache, metrics=mt,
                                         device="cpu", **common)
    return res, ref, mt.outer, mj.outer


def test_op_cache_entry_serves_only_the_operator_it_was_prepared_from(monkeypatch):
    """A hit on the same A and C skips the prepare; an entry found under the
    key of other objects (as when a freed operator's id is reused) is not
    used: the solve prepares its own and matches a solve with no cache."""
    pt, other = small(tsyn), small(tsyn, seed=1)
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=60, inner_iters=30,
              chunk=30, device="cpu")
    prepared, real_prepare = [], TL.prepare

    def counting_prepare(*args, **kwargs):
        prepared.append(1)
        return real_prepare(*args, **kwargs)

    monkeypatch.setattr(TL, "prepare", counting_prepare)
    cache = {}
    first = TEQ.solve_equality_constrained(pt, op_cache=cache, **kw)
    again = TEQ.solve_equality_constrained(pt, op_cache=cache, **kw)
    assert len(prepared) == 1
    np.testing.assert_array_equal(again.x, first.x)
    (entry,) = cache.values()
    assert entry.A is pt.A and entry.C is pt.C
    # the same entry under the other instance's key
    stale = {TEQ.op_cache_key(other, torch.float32, "pgd", "exact", "cpu"): entry}
    got = TEQ.solve_equality_constrained(other, op_cache=stale, **kw)
    want = TEQ.solve_equality_constrained(other, **kw)
    assert len(prepared) == 3
    np.testing.assert_array_equal(got.x, want.x)
    (fresh,) = stale.values()
    assert fresh.A is other.A and fresh.C is other.C


@pytest.mark.parametrize("scenarios", [1, 3])
def test_al_loop_matches_the_reference_in_float64(scenarios):
    pt, pj = _pair(small, scenarios=scenarios)
    res, ref, ot, oj = _al_pair(pt, pj, f64=True, tol=1e-9, eq_tol=1e-7, max_iter=1500,
                                inner_iters=300)
    assert len(ot) == len(oj) >= 2
    np.testing.assert_allclose([o["rho"] for o in ot], [o["rho"] for o in oj], rtol=1e-12)
    assert [o["inner_iters"] for o in ot] == [o["inner_iters"] for o in oj]
    np.testing.assert_allclose([o["viol"] for o in ot], [o["viol"] for o in oj], rtol=1e-5)
    np.testing.assert_allclose(res.x, np.asarray(ref.x), atol=AL_X_ATOL)
    np.testing.assert_allclose(res.eq_lam, np.asarray(ref.eq_lam), rtol=1e-6,
                               atol=1e-6 * np.abs(ref.eq_lam).max())
    assert res.eq_rho == pytest.approx(ref.eq_rho, rel=1e-12)
    assert res.iterations == ref.iterations and res.converged == ref.converged
    assert res.stop_reason == ref.stop_reason
    np.testing.assert_allclose(res.objective, ref.objective, rtol=1e-9)
    assert res.eq_violation == pytest.approx(ref.eq_violation, rel=1e-5, abs=1e-14)
    lead = (scenarios,) if scenarios > 1 else ()
    assert res.x.shape == lead + (pt.partition.n_flat,) and res.eq_lam.shape == lead + (4,)


def test_al_first_outer_matches_the_reference_in_float32():
    """fp32, one outer (the budget is its inner budget): pgd/exact's trace
    stays within F32_TRACE_RTOL of the reference's over all of it."""
    pt, pj = _pair(small, scenarios=3)
    res, ref, ot, oj = _al_pair(pt, pj, f64=False, tol=0.0, max_iter=200, inner_iters=200)
    assert len(ot) == len(oj) == 1 and res.stop_reason == ref.stop_reason == "budget_exhausted"
    assert res.trace_f.shape == np.asarray(ref.trace_f).shape == (3, 200)
    np.testing.assert_allclose(res.trace_f, np.asarray(ref.trace_f), rtol=F32_TRACE_RTOL)
    np.testing.assert_allclose(res.x, np.asarray(ref.x), atol=1e-4)
    assert ot[0]["rho"] == pytest.approx(oj[0]["rho"], rel=1e-12)
    # the warm start: the port continues from the reference's AL state
    state = al_state_from_numpy({"eq_lam": np.asarray(ref.eq_lam), "eq_rho": ref.eq_rho,
                                 "x": np.asarray(ref.x)})
    more = bt.solve_equality_constrained(pt, max_iter=200, inner_iters=200, chunk=50,
                                         device="cpu", **state)
    assert np.max(more.eq_violation) < ref.eq_violation
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)


def test_al_budget_and_warm_start_pava():
    """max_iter is the total inner budget (z-space inners: pava); a solve it
    stops says so, in both packages."""
    pt, pj = _pair(small)
    kw = dict(method="pgd", line_search="pava", tol=1e-9, max_iter=150, chunk=50)
    rt = bt.solve(pt, device="cpu", **kw)
    rj = bsls_tpu.solve(pj, **kw)
    assert rt.iterations == rj.iterations == 150
    assert rt.stop_reason == rj.stop_reason == "budget_exhausted" and not rt.converged
    assert rt.eq_rho > 0 and rt.eq_lam.shape == (4,) and np.isfinite(rt.objective)
    # no budget at all: the warm start comes back, as in the reference
    x0 = np.asarray(pt.x_true)
    r0 = bt.solve(pt, device="cpu", max_iter=0, x0=x0)
    j0 = bsls_tpu.solve(pj, max_iter=0, x0=x0)
    assert r0.stop_reason == j0.stop_reason == "budget_exhausted" and r0.iterations == 0
    np.testing.assert_array_equal(r0.x, x0)
    assert r0.objective == pytest.approx(float(j0.objective), rel=1e-12)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_al_refine_returns_what_the_reference_returns(package):
    """refine=2 on the preset's grid instance (lbfgs, stopped by the stall
    rule short of the constrained optimum): the float64 finishing outers
    would trade feasibility away, so the guard returns the unrefined point
    (the last outer's), in the reference (objective 4.0509e-4 there) as in
    the port; each round costs its two polish rounds of 30 CG iterations."""
    rec = Recorder()
    if package == "port":
        res = bt.solve(tsyn.make_config("traffic", seed=0), method="lbfgs", device="cpu",
                       refine=2, metrics=rec)
    else:
        res = bsls_tpu.solve(jsyn.make_config("traffic", seed=0), method="lbfgs", refine=2,
                             metrics=rec)
    last = rec.outer[-1]
    assert res.stop_reason == "stall" and res.refine_secs > 0
    assert float(res.objective) == pytest.approx(last["f"], rel=1e-12)
    assert res.eq_violation == last["viol"] <= 1e-6
    assert res.iterations == sum(o["inner_iters"] for o in rec.outer) + 2 * 2 * 30


def test_al_refine_tol_on_a_small_grid_instance():
    """refine_tol: the certified finisher reaches the float64 oracle on a
    small grid instance, in both packages."""
    pt = tsyn.make_config("traffic", seed=1, nx=8, ny=8, num_od=40, num_eq=8)
    pj = jsyn.make_config("traffic", seed=1, nx=8, ny=8, num_od=40, num_eq=8)
    kw = dict(method="lbfgs", tol=1e-6, max_iter=1500, refine_tol=1e-8)
    rt = bt.solve(pt, device="cpu", **kw)
    rj = bsls_tpu.solve(pj, **kw)
    orc = bt.oracle_solve_eq(pt, tol_eq=1e-10, tol_gap=1e-11)
    ref = max(1.0, abs(orc.objective))
    assert rt.refine_fw_gap is not None and rt.refine_fw_gap <= 1e-8
    assert rj.refine_fw_gap <= 1e-8 and rt.eq_violation <= 1e-9
    # both at the oracle's point, and the certificate bounds the true gap
    assert abs(float(rt.objective) - orc.objective) <= 1e-9 * ref
    assert abs(float(rt.objective) - float(rj.objective)) <= 1e-9 * ref
    assert (float(rt.objective) - orc.objective) / ref <= rt.refine_fw_gap + 1e-10


# ------------------------------------------- the loop's float64 state on the device


def _spy_inner(monkeypatch):
    """Every inner solve's stacked RHS and x, as host arrays, in order."""
    import bsls_tpu_torch.solvers.base as TB

    calls, real = [], TB.solve_on

    def spy(place, *args, **kw):
        res = real(place, *args, **kw)
        calls.append((place.dp.b.cpu().numpy().copy(), np.asarray(res.x.cpu().numpy()).copy()))
        return res

    monkeypatch.setattr(TB, "solve_on", spy)
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("scenarios", [1, 4])
def test_device_state_equals_the_host_float64_loop(monkeypatch, scenarios, dtype):
    """Outer for outer, the loop's float64 work on the device equals the
    host numpy arithmetic recomputed from the same inner x at 1e-12
    relative: the violation, the multipliers (through the stacked RHS that
    the next inner solve receives, and the result's), the recorded and the
    reported objectives; rho's growth decisions are the same."""
    pt = small(tsyn, scenarios=scenarios)
    calls, rec = _spy_inner(monkeypatch), Recorder()
    eq_tol, growth = 1e-7, 4.0
    res = TEQ.solve_equality_constrained(pt, dtype=dtype, tol=0.0, eq_tol=eq_tol, max_iter=240,
                                         inner_iters=40, chunk=20, rho_growth=growth,
                                         metrics=rec, device="cpu")
    assert len(calls) == len(rec.outer) == 6
    C, m = pt.C.data, pt.A.shape[0]
    b, d = np.asarray(pt.b, np.float64), np.asarray(pt.d, np.float64)
    d = np.broadcast_to(d, np.atleast_2d(b).shape[:-1] + d.shape[-1:]).reshape(
        b.shape[:-1] + d.shape[-1:])
    lam = np.zeros_like(d)
    rho = 0.1 * float(np.mean(TL._col_norms_sq(pt.A))) / float(np.mean(TL._col_norms_sq(pt.C)))
    viol, grew = np.inf, []

    def close(got, want):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())

    for (b_st, x), o in zip(calls, rec.outer):
        bottom = np.sqrt(rho) * (d - lam / rho)
        np.testing.assert_array_equal(b_st[..., :m], b.astype(b_st.dtype))
        if dtype == torch.float64:
            close(b_st[..., m:], bottom)
        else:  # the float64 bottom, rounded once to float32
            np.testing.assert_allclose(b_st[..., m:], bottom, rtol=2.0**-24,
                                       atol=2.0**-24 * np.abs(bottom).max())
        assert o["inner_rho"] == rho
        x = x.astype(np.float64)
        cx_d = np.atleast_2d(x) @ C.T - np.atleast_2d(d)
        new_viol = float(np.abs(cx_d).max()) / max(1.0, float(np.abs(d).max()))
        assert o["viol"] == pytest.approx(new_viol, rel=1e-12)
        close(np.asarray(o["f"]), pt.objective_np(x))
        lam = lam + rho * cx_d.reshape(lam.shape)
        grew.append(new_viol > 0.25 * viol and new_viol > eq_tol)
        rho = rho * growth if grew[-1] else rho
        assert o["rho"] == rho
        viol = new_viol
    assert any(grew) and not all(grew)
    close(res.eq_lam, lam)
    assert res.eq_rho == rho and res.eq_violation == rec.outer[-1]["viol"]
    np.testing.assert_array_equal(res.x, calls[-1][1])
    close(np.asarray(res.objective), pt.objective_np(np.asarray(res.x, np.float64)))
    assert isinstance(res.objective, float if scenarios == 1 else np.ndarray)


@pytest.mark.parametrize("scenarios", [1, 3])
def test_solve_takes_a_tensor_warm_start_as_its_array(scenarios):
    """A warm start given as a tensor gives the same x, objective and trace,
    bit for bit, as the same values as a numpy array; the solve body on a
    placement that keeps x on the device (as the equality-constrained loop's
    inner solves run) hands back the same x as a tensor."""
    prob = tsyn.medium_sparse(num_blocks=40, m=160, seed=2)
    if scenarios > 1:
        prob = tsyn.with_scenarios(prob, scenarios, seed=1)
    x0 = np.asarray(bt.solve(prob, device="cpu", max_iter=20, chunk=10).x, np.float64)
    kw = dict(device="cpu", max_iter=40, chunk=20, tol=0.0, lipschitz=50.0)
    want = bt.solve(prob, x0=x0, **kw)
    for x0t in (torch.as_tensor(x0), torch.as_tensor(x0, dtype=torch.float32)):
        got = bt.solve(prob, x0=x0t, **kw)
        np.testing.assert_array_equal(got.x, want.x)
        np.testing.assert_array_equal(got.objective, want.objective)
        np.testing.assert_array_equal(got.trace_f, want.trace_f)
        np.testing.assert_array_equal(got.trace_gap, want.trace_gap)
    place = TB.OneCard(TL.prepare(prob, device="cpu"), keep_x=True)
    body_kw = {k: v for k, v in kw.items() if k != "device"}
    on_device = TB.solve_on(place, x0=x0, **body_kw)
    assert isinstance(on_device.x, torch.Tensor) and on_device.x.dtype == torch.float32
    np.testing.assert_array_equal(on_device.x.numpy(), want.x)
    with pytest.raises(ValueError, match="keep_x"):
        TB.solve_on(place, prob, x0=x0, refine=1, **body_kw)


def test_a_cache_hit_computes_no_norms_and_no_float64_copies(monkeypatch):
    """rho0's column norms and the float64 copies of A and C are made once
    per instance and kept in the op_cache entry: a second request makes
    neither; an entry a caller builds (``EqInstance.of``) makes them once,
    there."""
    pt = small(tsyn, scenarios=2)
    made = {"norms": 0, "copies": 0}
    real_norms, real_copy = TL._col_norms_sq, TEQ._f64_copy

    def norms(M):
        made["norms"] += 1
        return real_norms(M)

    def copy(M, dev):
        made["copies"] += 1
        return real_copy(M, dev)

    monkeypatch.setattr(TL, "_col_norms_sq", norms)
    monkeypatch.setattr(TEQ, "_f64_copy", copy)
    kw = dict(tol=0.0, max_iter=60, inner_iters=30, chunk=30, device="cpu")
    cache = {}
    first = TEQ.solve_equality_constrained(pt, op_cache=cache, **kw)
    assert made["norms"] > 0 and made["copies"] == 2
    (entry,) = cache.values()
    assert isinstance(entry, TEQ.EqInstance) and entry.place.keep_x
    made.update(norms=0, copies=0)
    again = TEQ.solve_equality_constrained(pt, op_cache=cache, **kw)
    assert made == {"norms": 0, "copies": 0}
    np.testing.assert_array_equal(again.x, first.x)
    np.testing.assert_array_equal(again.eq_lam, first.eq_lam)
    # an entry built by a caller around the prepared operator
    (key,) = cache
    cache[key] = TEQ.EqInstance.of(pt, "cpu", place=entry.place, rho_base=entry.rho_base,
                                   L_base=entry.L_base, LC=entry.LC)
    assert made == {"norms": 2, "copies": 2}
    for _ in range(2):
        TEQ.solve_equality_constrained(pt, op_cache=cache, **kw)
    assert made == {"norms": 2, "copies": 2} and cache[key].place is entry.place


@pytest.mark.parametrize("case", ["cold", "warm_sink"])
def test_eq_host_bytes_counts_what_crosses(case):
    """``counts["eq_host_bytes"]``: b and d up once, the warm start (lam0,
    x0) up once, each outer's penalty scale up and violation down, and at
    the end x, the multipliers and the objectives down; nothing else (a
    record's objectives are not counted)."""
    S, outers = 3, 3
    pt = small(tsyn, scenarios=S)
    n, (p, m) = pt.partition.n_flat, pt.C.shape[0:1] + pt.A.shape[0:1]
    kw = dict(tol=0.0, max_iter=outers * 20, inner_iters=20, chunk=20, device="cpu")
    b, d = np.asarray(pt.b), np.asarray(pt.d)
    want = b.nbytes + d.astype(np.float64).nbytes + outers * (4 + 8) + S * (4 * n + 8 * p + 8)
    if case == "warm_sink":
        kw.update(lam0=np.ones(p), x0=np.asarray(pt.x_true), metrics=Recorder())
        want += S * p * 8 + S * n * 4
    res = TEQ.solve_equality_constrained(pt, **kw)
    assert res.counts["outers"] == outers and res.x.dtype == np.float32
    assert res.counts["eq_host_bytes"] == want, (res.counts["eq_host_bytes"], want, m)


# ------------------------------------------------------------ rejections


def _grid_view():
    """A rank's view of a 2-D (row 2) mesh, without process groups."""
    from bsls_tpu_torch.parallel import mesh as TM

    return TM.Mesh(shape={"row": 2, "block": 1, "scenario": 1},
                   coords=dict.fromkeys(TM.AXES, 0), groups=dict.fromkeys(TM.AXES),
                   device=torch.device("cpu"), device_mesh=None)


REJECTED = {
    "space": (ValueError, dict(space="z")),
    "callback": (ValueError, dict(callback=lambda it, st: None)),
    "certify": (ValueError, dict(certify=10)),
    "lipschitz": (ValueError, dict(lipschitz=1.0)),
    "stop_rule": (ValueError, dict(stop_rule="gap")),
    # the loop runs on a mesh; on a 2-D grid it does not, as in the reference
    "mesh": (ValueError, dict(mesh=_grid_view())),
}


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_eq_solve_rejects(name):
    exc, kw = REJECTED[name]
    with pytest.raises(exc, match=name):
        bt.solve(small(tsyn), device="cpu", max_iter=10, **kw)
    if name == "mesh":
        with pytest.raises(exc, match="2-D grid"):
            bt.solve_equality_constrained(small(tsyn), device="cpu", max_iter=10, **kw)
        # on a mesh of one block the loop runs, as on one device
        bt.init_distributed("gloo")
        mesh = bt.make_mesh(block=1, device="cpu")
        kw = dict(max_iter=40, chunk=10)
        got = bt.solve(small(tsyn), mesh=mesh, **kw)
        want = bt.solve(small(tsyn), device="cpu", **kw)
        assert got.iterations == want.iterations == 40 and got.eq_violation is not None
        np.testing.assert_allclose(got.objective, want.objective, rtol=1e-4)


def test_eq_solve_needs_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        bt.solve(small(tsyn), max_iter=10)
    # shard_rows without a mesh is refused, as in the reference (the mesh
    # loop itself: tests/test_torch_eq_mesh.py)
    with pytest.raises(ValueError, match="requires a mesh"):
        bt.solve_equality_constrained(small(tsyn), device="cpu", shard_rows=True)
