"""One PGD step of the PyTorch port against ``bsls_tpu.solvers.pgd.step`` from
the same numpy state, on the layout that the reference's ``prepare`` built;
the FW gap and both Lipschitz estimates."""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu.ops.layout as JL
import bsls_tpu.solvers.base as JB
import bsls_tpu.solvers.pgd as JP
import bsls_tpu_torch.ops.layout as TL
import bsls_tpu_torch.solvers.base as TB
import bsls_tpu_torch.solvers.pgd as TP
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu_torch.convert import device_problem_from_numpy, state_from_numpy
from torch_port_helpers import flatten_device_problem, flatten_state, small_instance

# fp32 on both sides, sums in another order; f and gap are sums over m and n
RTOL = 1e-4


def _close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.abs(want).max(), 1e-6),
                               err_msg=name)


def _jax_steps(dj, opts, L_est, n, multi):
    """State after ``n`` reference steps (so that BB has a history)."""
    if multi:
        st = jax.vmap(lambda b: JP.init(replace(dj, b=b), L_est, opts))(dj.b)
        one = jax.jit(jax.vmap(lambda b, s: JP.step(replace(dj, b=b), s, L_est, opts)))
        for _ in range(n):
            st = one(dj.b, st)
        return st, lambda s: one(dj.b, s)
    st = JP.init(dj, L_est, opts)
    one = jax.jit(lambda s: JP.step(dj, s, L_est, opts))
    for _ in range(n):
        st = one(st)
    return st, one


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("scenarios", [1, 3])
@pytest.mark.parametrize("line_search", ["exact", "bb", "bbm", "fixed", "pava"])
def test_step_matches_reference(kind, scenarios, line_search):
    dj = JL.prepare(small_instance(jsyn, kind, scenarios), layout="gather")
    dt = device_problem_from_numpy(flatten_device_problem(dj), device="cpu")
    zs = line_search == "pava"
    L_est = float((JB.power_lipschitz_z if zs else JB.power_lipschitz)(
        replace(dj, b=dj.b[0]) if scenarios > 1 else dj))
    step_size = 0.5 / L_est if line_search == "fixed" else 0.0
    jo = JB.SolveOptions(method="pgd", line_search=line_search, step_size=step_size)
    to = TB.SolveOptions(method="pgd", line_search=line_search, step_size=step_size)

    st_j, one = _jax_steps(dj, jo, jnp.float32(L_est), 2, scenarios > 1)
    st_t = state_from_numpy(flatten_state(st_j), device="cpu")
    assert st_t.k == 2 and st_t.r.shape == (scenarios, dt.num_rows)
    before = flatten_state(st_t)

    want = flatten_state(one(st_j))
    got = flatten_state(TP.step(dt, st_t, L_est, to))
    for name in ("r", "f", "gap", "x_prev", "g_prev"):
        w = want[name] if scenarios > 1 else want[name][None]
        _close(got[name], w, name)
    for i in range(len(dt.buckets)):
        w = want[f"xp[{i}]"] if scenarios > 1 else want[f"xp[{i}]"][None]
        _close(got[f"xp[{i}]"], w, f"xp[{i}]")
    assert got["k"] == 3
    # the step updates in place only buffers it made itself
    after = flatten_state(st_t)
    for name, a in before.items():
        np.testing.assert_array_equal(after[name], a, err_msg=name)


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("scenarios", [1, 3])
def test_init_refresh_and_fw_gap_match_reference(kind, scenarios):
    dj = JL.prepare(small_instance(jsyn, kind, scenarios), layout="gather")
    dt = device_problem_from_numpy(flatten_device_problem(dj), device="cpu")
    opts = TB.SolveOptions()
    st = TP.init(dt, 1.0, opts)
    if scenarios > 1:
        sj = jax.vmap(lambda b: JP.init(replace(dj, b=b), 1.0, JB.SolveOptions()))(dj.b)
    else:
        sj = JP.init(dj, 1.0, JB.SolveOptions())
    _close(st.f.numpy(), np.atleast_1d(np.asarray(sj.f)), "f")
    _close(st.r.numpy(), np.asarray(sj.r).reshape(scenarios, -1), "r")
    assert torch.isinf(st.gap).all()
    st2 = TP.refresh(dt, replace(st, r=torch.zeros_like(st.r)), 1.0, opts)
    np.testing.assert_array_equal(st2.r.numpy(), st.r.numpy())

    rng = np.random.default_rng(12)
    g = rng.standard_normal((scenarios, dt.n_pf)).astype(np.float32)
    x = rng.random((scenarios, dt.n_pf)).astype(np.float32)
    got = TB.fw_gap(dt, torch.from_numpy(g), torch.from_numpy(x),
                    TL.flat_to_padded(dt, torch.from_numpy(g))).numpy()
    want = [float(JB.fw_gap(dj, jnp.asarray(g[s]), jnp.asarray(x[s]),
                            JL.flat_to_padded(dj, jnp.asarray(g[s])))) for s in range(scenarios)]
    _close(got, want, "fw_gap")


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("zspace", [False, True])
def test_power_lipschitz_matches_reference(kind, zspace):
    dj = JL.prepare(small_instance(jsyn, kind), layout="gather")
    dt = device_problem_from_numpy(flatten_device_problem(dj), device="cpu")
    jf, tf = ((JB.power_lipschitz_z, TB.power_lipschitz_z) if zspace
              else (JB.power_lipschitz, TB.power_lipschitz))
    want = float(jf(dj))
    # the reference's start vector, handed over as numpy
    v0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (dj.n_pf,), dtype=jnp.float32))
    assert tf(dt, v0=v0) == pytest.approx(want, rel=1e-3)
    # the port's own generator: another start, the same eigenvalue to the
    # accuracy of 30 power steps on these small instances
    own = tf(dt, seed=0)
    assert own == tf(dt, seed=0)
    assert own == pytest.approx(want, rel=0.05)
    with pytest.raises(ValueError):
        tf(dt, v0=v0[:-1])
    assert TB.uses_zspace("pgd", "pava") and TB.uses_zspace("pgd", "exact", "z")
    assert not TB.uses_zspace("pgd", "exact")
