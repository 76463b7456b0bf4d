"""The five other solver families of the PyTorch port (apgd, eg, frank_wolfe,
afw, lbfgs in x- and z-space) against ``bsls_tpu`` on seeded inputs: the
simplex ops and L-BFGS pieces they are built from, one step of each from the
same numpy state, whole solves with one ``lipschitz=`` (in float64 over the
full budget, in float32 over the horizon where rounding has not yet been
amplified), and the reference's oracle targets."""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu
import bsls_tpu.ops.layout as JL
import bsls_tpu.ops.simplex as JS
import bsls_tpu.solvers.base as JB
import bsls_tpu.solvers.lbfgs as JLB
import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.layout as TL
import bsls_tpu_torch.ops.quadratic as TQ
import bsls_tpu_torch.ops.simplex as TS
import bsls_tpu_torch.solvers.base as TB
import bsls_tpu_torch.solvers.lbfgs as TLB
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu_torch.convert import device_problem_from_numpy
from bsls_tpu_torch.models import synthetic as tsyn
from torch_port_helpers import KERNELS, flatten_device_problem, small_instance

# fp32 on both sides with sums in another order: one op or one step
RTOL = 1e-4
# float64 on both sides: whole traces of 200 iterations agree to 1e-9 at worst
# (EG and z-space L-BFGS on the ELL instance); every family is held at 1e-8
F64_RTOL = 1e-8
# float32 traces stay within 1e-3 of the reference's up to a point and then
# part, as BB traces do (ROADMAP.md queue 3): measured on the two instances
# below at S = 1 and 3, the first iteration past 1e-3 was apgd 126, eg 59,
# frank_wolfe 38, afw 44, lbfgs x-space none in 200, lbfgs z-space 19.  The
# reference run against itself with lipschitz * (1 + 1e-6) parts at the same
# places for apgd, eg and z-space L-BFGS (123, 59, 19), and x-space L-BFGS
# parts from itself at 42 on the dense instance; frank_wolfe and afw use no
# Lipschitz value, and their near-tied vertex choices flip with the order of
# a sum.  In float64 every family matches over all 200 (F64_RTOL).
HORIZON = {"apgd": 100, "eg": 50, "frank_wolfe": 30, "afw": 30, "lbfgs": 200, "lbfgs_z": 15}
FAMILIES = [("apgd", "x"), ("eg", "x"), ("frank_wolfe", "x"), ("afw", "x"), ("lbfgs", "x"),
            ("lbfgs", "z")]
# (instance, scenarios): the single-RHS dense one and the batched ELL one
INSTANCES = [("dense", 1), ("ell", 3)]


def _close(got, want, name, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-6),
                               err_msg=name)


def _t(a):
    return torch.tensor(np.asarray(a))


# ------------------------------------------------------------ simplex ops


def _padded(seed, B=40, w=8, S=3, ties=False):
    """Ragged masks (widths 0..w: dummy rows and single-slot blocks
    included), radii, iterates with exact zeros, gradients (tied when asked)."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, w + 1, size=B)
    widths[:3] = (0, 1, w)
    mask = (np.arange(w)[None] < widths[:, None]).astype(np.float32)
    radius = rng.uniform(0.5, 3.0, size=B).astype(np.float32)
    x = rng.dirichlet(np.ones(w), size=(S, B)).astype(np.float32) * radius[:, None]
    x[rng.random((S, B, w)) < 0.3] = 0.0
    x *= mask
    x[:, 3, :] = 0.0
    x[:, 3, 0] = radius[3]  # a block with one support coordinate
    if ties:
        g = rng.integers(-2, 3, size=(S, B, w)).astype(np.float32)
    else:
        g = rng.standard_normal((S, B, w)).astype(np.float32)
    q = rng.uniform(0.1, 2.0, size=(B, w)).astype(np.float32) * mask
    return x, g, mask, radius, q


@pytest.mark.parametrize("seed", [0, 1])
def test_eg_update_matches_reference(seed):
    x, g, mask, radius, _ = _padded(seed)
    t = np.array([0.3, 2.0, 50.0], np.float32)  # one step per scenario
    got = TS.eg_update_padded(_t(x), _t(g), _t(t), _t(mask), _t(radius)).numpy()
    for s in range(3):
        want = np.asarray(JS.eg_update_padded(x[s], g[s], t[s], mask, radius))
        _close(got[s], want, f"eg s={s}", rtol=1e-5)
        # a coordinate that is 0 stays exactly 0, as in the reference (the
        # long step of scenario 2 also drives positive ones below 1.2e-38:
        # the reference's XLA flushes those subnormals to 0, torch keeps them)
        zero = (x[s] == 0) & (x[s].sum(axis=-1, keepdims=True) > 0)  # blocks with a support
        assert not got[s][zero].any() and not want[zero].any()
        assert not np.any((got[s] == 0) & (want != 0))
        assert np.all(got[s][want == 0] < 1.2e-38)
    one = TS.eg_update_padded(_t(x[0]), _t(g[0]), 0.3, _t(mask), _t(radius)).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("ties", [False, True])
def test_fw_vertex_and_pairwise_direction_match_reference(ties):
    x, g, mask, radius, q = _padded(2, ties=ties)
    fw = TS.fw_vertex_padded(_t(g), _t(mask), _t(radius)).numpy()
    pw = TS.pairwise_direction_padded(_t(x), _t(g), _t(mask)).numpy()
    pwq = TS.pairwise_direction_padded(_t(x), _t(g), _t(mask), _t(q)).numpy()
    for s in range(3):
        # the vertex is an exact one-hot: ties go to the same (first) slot
        np.testing.assert_array_equal(fw[s], np.asarray(JS.fw_vertex_padded(g[s], mask, radius)))
        _close(pw[s], JS.pairwise_direction_padded(x[s], g[s], mask), f"pw s={s}", rtol=1e-6)
        _close(pwq[s], JS.pairwise_direction_padded(x[s], g[s], mask, q), f"pwq s={s}",
               rtol=1e-6)
        np.testing.assert_array_equal(pwq[s] != 0, np.asarray(
            JS.pairwise_direction_padded(x[s], g[s], mask, q)) != 0)
    # dummy rows give nothing; the single-support block moves nothing away
    assert not fw[:, 0].any() and not pw[:, 0].any()
    assert np.all(pw[:, 3, 0] <= 0.0)


def test_xmatdot_and_inject_user_grad_match_reference():
    pj = small_instance(jsyn, "ell", 3)
    dj = JL.prepare(pj, layout="gather")
    dt = device_problem_from_numpy(flatten_device_problem(dj), device="cpu")
    rng = np.random.default_rng(5)
    M = rng.standard_normal((3, 8, dt.n_pf)).astype(np.float32)
    v = rng.standard_normal((3, dt.n_pf)).astype(np.float32)
    got = TL.xmatdot(dt, _t(M), _t(v)).numpy()
    for s in range(3):
        _close(got[s], JL.xmatdot(dj, M[s], v[s]), f"xmatdot s={s}", rtol=1e-5)
    _close(TL.xmatdot(dt, _t(M[0]), _t(v[0])).numpy(), got[0], "unbatched", rtol=1e-6)
    g = rng.standard_normal((3, pj.partition.n_flat)).astype(np.float32)
    got = TL.inject_user_grad(dt, _t(g)).numpy()
    for s in range(3):
        np.testing.assert_allclose(got[s], np.asarray(JL.inject_user_grad(dj, g[s])), rtol=1e-6)


# ------------------------------------------------------------ L-BFGS pieces


def _random_history(dt, seed, S=3, M=8):
    """A ring of curvature pairs y = A^T A s (some slots empty), with the
    Gram buffers the solver would hold, and a gradient."""
    rng = np.random.default_rng(seed)
    n = dt.n_pf
    A = lambda v: TL.rmatvec(dt.A, TL.matvec(dt.A, _t(v))).numpy()
    s_h = np.zeros((S, M, n), np.float32)
    y_h = np.zeros_like(s_h)
    rho = np.zeros((S, M), np.float32)
    for s in range(S):
        for j in range(s, M):  # scenario s has its s oldest slots empty
            sv = (rng.standard_normal(n) * 1e-2).astype(np.float32)
            s_h[s, j], y_h[s, j] = sv, A(sv)
            rho[s, j] = 1.0 / float(s_h[s, j] @ y_h[s, j])
    sty = np.einsum("smn,skn->smk", s_h, y_h).astype(np.float32)
    yty = np.einsum("smn,skn->smk", y_h, y_h).astype(np.float32)
    gamma = np.array([float(s_h[s, -1] @ y_h[s, -1] / (y_h[s, -1] @ y_h[s, -1]))
                      for s in range(S)], np.float32)
    g = rng.standard_normal((S, n)).astype(np.float32)
    u_prev = rng.standard_normal((S, n)).astype(np.float32)
    return dict(s_hist=s_h, y_hist=y_h, rho_hist=rho, sty=sty, yty=yty, gamma=gamma), g, u_prev


def _jax_lbfgs_state(h, s, u_prev, k):
    z = jnp.zeros(())
    return JLB.LBFGSState(xp=(), r=z, f=z, gap=z, k=jnp.int32(k), u_prev=jnp.asarray(u_prev[s]),
                          g_prev=jnp.zeros_like(jnp.asarray(u_prev[s])),
                          **{n: jnp.asarray(a[s]) for n, a in h.items()})


def _torch_lbfgs_state(h, u_prev, k):
    z = torch.zeros(())
    return TLB.LBFGSState(xp=(), r=z, f=z, gap=z, k=torch.tensor(k, dtype=torch.int32),
                          u_prev=_t(u_prev), g_prev=torch.zeros(u_prev.shape),
                          **{n: _t(a) for n, a in h.items()})


@pytest.fixture(scope="module")
def ell3():
    dj = JL.prepare(small_instance(jsyn, "ell", 3), layout="gather")
    return dj, device_problem_from_numpy(flatten_device_problem(dj), device="cpu")


def test_compact_hg_matches_two_loop_and_reference(ell3):
    dj, dt = ell3
    h, g, u_prev = _random_history(dt, 7)
    st = _torch_lbfgs_state(h, u_prev, [5, 5, 5])
    got = TLB.compact_hg(dt, _t(g), st).numpy()
    loop = TLB.two_loop_hg(dt, _t(g), st).numpy()
    for s in range(3):
        sj = _jax_lbfgs_state(h, s, u_prev, 5)
        want = np.asarray(JLB.compact_hg(dj, jnp.asarray(g[s]), sj))
        _close(got[s], want, f"compact s={s}", rtol=1e-4)
        _close(loop[s], np.asarray(JLB.two_loop_hg(dj, jnp.asarray(g[s]), sj)),
               f"two-loop s={s}", rtol=1e-4)
        _close(got[s], loop[s], f"compact vs two-loop s={s}", rtol=1e-4)
    # an empty history is gamma * g
    empty = replace(st, rho_hist=torch.zeros_like(st.rho_hist))
    _close(TLB.compact_hg(dt, _t(g), empty).numpy(), h["gamma"][:, None] * g, "empty")


@pytest.mark.parametrize("k", [0, 4])
def test_update_pairs_matches_reference(ell3, k):
    dj, dt = ell3
    h, _, u_prev = _random_history(dt, 8)
    rng = np.random.default_rng(9)
    u = (u_prev + rng.standard_normal(u_prev.shape) * 1e-2).astype(np.float32)
    gu = rng.standard_normal(u.shape).astype(np.float32)
    got = TLB.update_pairs(dt, _torch_lbfgs_state(h, u_prev, [k] * 3), _t(u), _t(gu))
    for s in range(3):
        want = JLB.update_pairs(dj, _jax_lbfgs_state(h, s, u_prev, k), jnp.asarray(u[s]),
                                jnp.asarray(gu[s]))
        for name in ("s_hist", "y_hist", "rho_hist", "sty", "yty", "gamma"):
            _close(getattr(got, name)[s].numpy(), getattr(want, name), f"{name} s={s}")
    if k == 0:  # the first step appends an empty slot
        assert not got.rho_hist[:, -1].any() and not got.s_hist[:, -1].any()


# ------------------------------------------------------------ one step


STEP_CASES = [
    ("apgd", "exact", "x", "dense", 1), ("apgd", "exact", "x", "ell", 3),
    ("apgd", "fixed", "x", "ell", 3),
    ("eg", "exact", "x", "dense", 1), ("eg", "exact", "x", "ell", 3),
    ("eg", "bb", "x", "ell", 3), ("eg", "fixed", "x", "ell", 3),
    ("frank_wolfe", "exact", "x", "dense", 1), ("frank_wolfe", "exact", "x", "ell", 3),
    ("frank_wolfe", "fixed", "x", "ell", 3),
    ("afw", "exact", "x", "dense", 1), ("afw", "exact", "x", "ell", 3),
    ("lbfgs", "exact", "x", "dense", 1), ("lbfgs", "exact", "x", "ell", 3),
    ("lbfgs", "exact", "z", "ell", 3),
]


def _state_to_torch(cls, st_j, multi, dt, opts):
    out = {}
    for f in dataclasses.fields(cls):
        if f.name == "qp":
            out["qp"] = TQ.diag_quad(dt) if opts.method in TB.PAIRWISE else None
            continue
        v = getattr(st_j, f.name)
        lift = (lambda a: np.asarray(a)) if multi else (lambda a: np.asarray(a)[None])
        out[f.name] = (tuple(_t(lift(a)) for a in v) if isinstance(v, tuple)
                       else _t(lift(v)))
    return cls(**out)


def _compare_states(got, want_j, multi, what):
    for f in dataclasses.fields(got):
        if f.name == "qp":
            continue
        a, b = getattr(got, f.name), getattr(want_j, f.name)
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        for i, (ga, wb) in enumerate(pairs):
            wb = np.asarray(wb) if multi else np.asarray(wb)[None]
            if f.name == "k":
                np.testing.assert_array_equal(ga.numpy(), wb, err_msg=f"{what} k")
            else:
                _close(ga.numpy(), wb, f"{what} {f.name}[{i}]")


@pytest.mark.parametrize("method,line_search,space,kind,scenarios", STEP_CASES)
def test_init_step_refresh_match_reference(method, line_search, space, kind, scenarios):
    multi = scenarios > 1
    dj = JL.prepare(small_instance(jsyn, kind, scenarios), layout="gather")
    dt = device_problem_from_numpy(flatten_device_problem(dj), device="cpu")
    L_est = float((JB.power_lipschitz_z if space == "z" else JB.power_lipschitz)(
        replace(dj, b=dj.b[0]) if multi else dj))
    step_size = 0.5 / L_est if (line_search == "fixed" and method != "frank_wolfe") else 0.0
    kw = dict(method=method, line_search=line_search, space=space, step_size=step_size)
    jo, to = JB.SolveOptions(**kw), TB.SolveOptions(**kw)
    jmod, tmod = JB._get_solver(method), TB._get_solver(method)
    Lj = jnp.float32(L_est)
    if multi:
        init_j = jax.vmap(lambda b: jmod.init(replace(dj, b=b), Lj, jo))
        step_j = jax.jit(jax.vmap(lambda b, s: jmod.step(replace(dj, b=b), s, Lj, jo)))
        refresh_j = jax.vmap(lambda b, s: jmod.refresh(replace(dj, b=b), s, Lj, jo))
        st_j = init_j(dj.b)
        one = lambda s: step_j(dj.b, s)
        ref = lambda s: refresh_j(dj.b, s)
    else:
        st_j = jmod.init(dj, Lj, jo)
        one = jax.jit(lambda s: jmod.step(dj, s, Lj, jo))
        ref = lambda s: jmod.refresh(dj, s, Lj, jo)
    cls = type(tmod.init(dt, L_est, to))
    _compare_states(tmod.init(dt, L_est, to), st_j, multi, "init")
    for _ in range(6):  # a history for BB and L-BFGS, and afw's k near its FW mix
        st_j = one(st_j)
    if multi:
        # the scenarios' counters apart: afw's plain-FW mix (k % 8 == 7) and
        # L-BFGS's first-pair rule are per scenario
        st_j = st_j._replace(k=jnp.asarray([7, 3, 0], jnp.int32))
    st_t = _state_to_torch(cls, st_j, multi, dt, to)
    _compare_states(tmod.refresh(dt, st_t, L_est, to), ref(st_j), multi, "refresh")
    got, want = tmod.step(dt, st_t, L_est, to), one(st_j)
    _compare_states(got, want, multi, "step")
    got2 = tmod.step(dt, got, L_est, to)
    _compare_states(got2, one(want), multi, "second step")


def test_rejections():
    prob = tsyn.tiny_dense(num_blocks=4, dim=3, m=10)
    for kw in (dict(method="apgd", line_search="bb"), dict(method="apgd", line_search="pava"),
               dict(method="apgd", space="z"), dict(method="lbfgs", line_search="bb"),
               dict(method="lbfgs", line_search="bbm"), dict(method="lbfgs", step_size=0.1)):
        with pytest.raises(ValueError):
            bt.solve(prob, device="cpu", max_iter=10, chunk=10, **kw)
    with pytest.raises(KeyError, match="unknown method"):
        bt.solve(prob, device="cpu", method="newton")


# ------------------------------------------------------------ whole solves


def _solve_pair(method, space, kind, scenarios, f64, max_iter=200):
    pt, pj = small_instance(tsyn, kind, scenarios), small_instance(jsyn, kind, scenarios)
    tdt, jdt = (torch.float64, jnp.float64) if f64 else (torch.float32, jnp.float32)
    dpt = bt.prepare(pt, layout="gather", device="cpu", dtype=tdt)
    L_est = (TB.power_lipschitz_z if space == "z" else TB.power_lipschitz)(dpt)
    kw = dict(method=method, space=space, tol=0.0, max_iter=max_iter, chunk=100,
              lipschitz=L_est)
    res = bt.solve(dpt, **kw)
    with jax.enable_x64(f64):
        ref = bsls_tpu.solve(JL.prepare(pj, layout="gather", dtype=jdt), dtype=jdt, **kw)
    return pt, res, ref


@pytest.mark.parametrize("kind,scenarios", INSTANCES)
@pytest.mark.parametrize("method,space", FAMILIES)
def test_solve_matches_reference_in_float64(method, space, kind, scenarios):
    _, res, ref = _solve_pair(method, space, kind, scenarios, f64=True)
    assert res.trace_f.dtype == np.float64
    np.testing.assert_allclose(res.trace_f, ref.trace_f, rtol=F64_RTOL)
    np.testing.assert_allclose(res.trace_gap, ref.trace_gap, rtol=F64_RTOL,
                               atol=F64_RTOL * np.abs(ref.trace_gap).max())
    np.testing.assert_allclose(res.x, ref.x, atol=1e-8)


@pytest.mark.parametrize("kind,scenarios", INSTANCES)
@pytest.mark.parametrize("method,space", FAMILIES)
def test_solve_matches_reference_in_float32(method, space, kind, scenarios):
    pt, res, ref = _solve_pair(method, space, kind, scenarios, f64=False)
    h = HORIZON[method + ("_z" if space == "z" else "")]
    lead = () if scenarios == 1 else (scenarios,)
    assert res.trace_f.shape == lead + (200,) and res.x.shape == lead + (pt.partition.n_flat,)
    assert res.iterations == ref.iterations == 200 and res.stop_reason == "max_iter"
    np.testing.assert_allclose(res.trace_f[..., :h], ref.trace_f[..., :h], rtol=1e-3)
    # past the horizon the ends agree to a decade
    assert np.all(np.abs(np.log10(res.objective / ref.objective)) <= 1.0)
    x = np.atleast_2d(res.x)
    offs = np.concatenate([[0], np.cumsum(pt.partition.sizes)[:-1]])
    assert x.min() >= 0.0
    np.testing.assert_allclose(np.add.reduceat(x, offs, axis=-1), 1.0, atol=1e-5)
    # the solver's fp32 objective against the float64 objective of the x it
    # returns.  apgd carries the residual at its extrapolated point
    # incrementally, and after 100 steps its objective has drifted from its
    # x's by 1.7e-3 on the ELL instance here (the reference's by 2.3e-3)
    np.testing.assert_allclose(pt.objective_np(res.x), res.objective, atol=1e-6,
                               rtol=5e-3 if method == "apgd" else 1e-3)
    # monotone within a chunk, as the reference: apgd by its safeguard, the
    # others by the exact step along their direction clipped to [0, 1].  The
    # refresh at a chunk's start replaces the incremental residual by the
    # exact one, and the objective may rise there by its drift (1.6e-4 for
    # z-space L-BFGS on the ELL instance, in the reference as here)
    tf = np.atleast_2d(res.trace_f).reshape(-1, 2, 100)
    assert np.all(np.diff(tf, axis=-1) <= 1e-5 * np.abs(tf[..., :-1]) + 1e-7)
    assert np.all(tf[:, 1, -1] <= tf[:, 0, -1] * (1 + 1e-4))
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.fixture(scope="module")
def tiny_oracle():
    prob = tsyn.tiny_dense(seed=0, num_blocks=50, dim=8, m=400)
    orc = bt.oracle_solve(prob, tol_gap=1e-11, max_iter=20000)
    assert orc.gap <= 1e-11
    return prob, orc


# the reference's targets (tests/test_solvers.py): FW converges O(1/k) and EG
# similarly sublinearly on a general QP; the rest must hit the 1e-6 parity bar
@pytest.mark.parametrize("method,target", [
    ("apgd", 1e-6), ("eg", 1e-4), ("frank_wolfe", 1e-3), ("afw", 1e-6), ("lbfgs", 1e-6),
])
def test_solver_reaches_oracle_tiny(tiny_oracle, method, target):
    prob, orc = tiny_oracle
    res = bt.solve(prob, method=method, tol=1e-8, max_iter=6000, chunk=200, device="cpu")
    rel = (float(res.objective) - orc.objective) / max(1.0, abs(orc.objective))
    assert rel <= target, (method, float(res.objective), orc.objective, rel)
    x = np.asarray(res.x, np.float64)
    off = 0
    for n in prob.partition.sizes:
        assert abs(x[off:off + n].sum() - 1) < 1e-4
        assert (x[off:off + n] >= -1e-6).all()
        off += n
