"""The captured chunk's ground on the CPU (``bsls_tpu_torch/solvers/graph.py``)
and PGD's iteration count on the device.

* ``PGDState.k`` is an int32 tensor: the bb/bbm/pava traces match
  ``bsls_tpu`` over the first 30 iterations (where the first iteration's
  1/L step is chosen by ``torch.where`` on k), a solve resumed at k = 100
  (from this package's checkpoint and from one holding k as a scalar, as
  files did before k moved onto the device) matches the reference's
  uninterrupted run, and ``convert.py`` carries the reference's k.
* ``chunk_key`` and ``ProgramCache``: what hits and what misses, the bound,
  and a freed operator.
* ``ChunkProgram``'s input binding without a capture: calls with another b,
  sqrt(rho) and L through its buffers equal the eager runner, and what a call
  returns is not touched by the next.

The capture and the replay themselves need the card: ``chip_smoke.py`` holds
every graphed path against the eager runner there."""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu
import bsls_tpu.ops.layout as JL
import bsls_tpu.solvers.pgd as JP
import bsls_tpu_torch as bt
import bsls_tpu_torch.solvers.base as TB
import bsls_tpu_torch.solvers.graph as G
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu_torch.convert import state_from_numpy
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.models.problem import Problem, ScaledMatrix, VStackMatrix
from bsls_tpu_torch.utils.checkpoint import latest_checkpoint, load_state, save_state
from torch_port_helpers import flatten_state, small_instance
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# float64 on both sides: the PGD traces agree to rounding
F64_RTOL = 1e-9


def _pair(kind, scenarios, line_search, max_iter, chunk, **extra):
    """The port's and the reference's float64 solve of one instance with one
    Lipschitz value."""
    pt, pj = small_instance(tsyn, kind, scenarios), small_instance(jsyn, kind, scenarios)
    dpt = bt.prepare(pt, layout="gather", device="cpu", dtype=torch.float64)
    power = TB.power_lipschitz_z if line_search == "pava" else TB.power_lipschitz
    kw = dict(method="pgd", line_search=line_search, tol=0.0, chunk=chunk,
              lipschitz=power(dpt))
    res = bt.solve(dpt, max_iter=max_iter, **kw, **extra)
    with jax.enable_x64(True):
        dpj = JL.prepare(pj, layout="gather", dtype=jnp.float64)
        ref = bsls_tpu.solve(dpj, dtype=jnp.float64, max_iter=max_iter, **kw)
    return dpt, kw, res, ref


@pytest.mark.parametrize("kind,scenarios", [("dense", 1), ("ell", 3)])
@pytest.mark.parametrize("line_search", ["bb", "bbm", "pava"])
def test_pgd_first_iterations_match_reference(kind, scenarios, line_search):
    _, _, res, ref = _pair(kind, scenarios, line_search, 30, 10)
    assert res.trace_f.shape == ref.trace_f.shape
    np.testing.assert_allclose(res.trace_f, ref.trace_f, rtol=F64_RTOL)
    np.testing.assert_allclose(res.x, ref.x, atol=1e-10)


# pava's Barzilai-Borwein iteration amplifies rounding even in float64: past
# some 80 iterations the port and the reference part by up to 7e-6 over
# iterations 100-130 of the ELL instance, and the reference run against
# itself with lipschitz * (1 + 1e-12) by up to 2.7e-5 there.  The resumed
# window is held to the reference at this, and to the port's own
# uninterrupted run exactly.
RESUME_RTOL = {"bb": F64_RTOL, "pava": 1e-4}


@pytest.mark.parametrize("legacy", [False, True], ids=["tensor_k", "scalar_k"])
@pytest.mark.parametrize("line_search", ["bb", "pava"])
def test_pgd_resume_at_100_matches_reference(tmp_path, line_search, legacy):
    path = str(tmp_path / "ck.npz")
    dpt, kw, whole, ref = _pair("ell", 3, line_search, 130, 10)
    first = bt.solve(dpt, max_iter=100, checkpoint_path=path, checkpoint_every=1, **kw)
    assert first.iterations == 100
    if legacy:
        # the file as it was written while PGDState.k was a Python int
        st, meta = load_state(latest_checkpoint(path), TB._get_solver("pgd").init(
            dpt, kw["lipschitz"], TB.SolveOptions(line_search=line_search)))
        assert st.k.tolist() == [100] * 3
        save_state(path, dataclasses.replace(st, k=100), meta=meta)
        k_leaf = len(dpt.buckets) + 3  # after xp[...], r, f and gap
        assert np.load(path)[f"leaf_{k_leaf}"].shape == ()
    resumed = bt.solve(dpt, max_iter=130, resume=True, checkpoint_path=path, **kw)
    assert resumed.iterations == 130 and resumed.trace_f.shape == (3, 30)
    np.testing.assert_array_equal(resumed.trace_f, whole.trace_f[:, 100:])
    np.testing.assert_array_equal(resumed.x, whole.x)
    np.testing.assert_allclose(resumed.trace_f, ref.trace_f[:, 100:],
                               rtol=RESUME_RTOL[line_search])


@pytest.mark.parametrize("scenarios", [1, 3])
def test_convert_carries_reference_k(scenarios):
    pj = small_instance(jsyn, "dense", scenarios)
    dj = JL.prepare(pj, layout="gather")
    opts = bsls_tpu.solvers.base.SolveOptions(method="pgd", line_search="bb")
    L_est = jnp.float32(1.0)
    if scenarios > 1:
        init = jax.vmap(lambda b: JP.init(dataclasses.replace(dj, b=b), L_est, opts))(dj.b)
        step = jax.vmap(lambda b, s: JP.step(dataclasses.replace(dj, b=b), s, L_est, opts))
        st = init
        for _ in range(7):
            st = step(dj.b, st)
    else:
        st = JP.init(dj, L_est, opts)
        for _ in range(7):
            st = JP.step(dj, st, L_est, opts)
    assert np.asarray(st.k).shape == ((scenarios,) if scenarios > 1 else ())
    got = state_from_numpy(flatten_state(st), device="cpu")
    assert got.k.dtype == torch.int32 and got.k.tolist() == [7] * scenarios


# ------------------------------------------------------------ the cache key


def _dp(scenarios=3, dtype=torch.float32):
    return bt.prepare(small_instance(tsyn, "ell", scenarios), layout="gather", device="cpu",
                      dtype=dtype)


def _stacked(scale=1.5, scenarios=3, seed=3):
    """A stacked operator [A; scale C] as the augmented-Lagrangian loop
    prepares it."""
    prob = tsyn.with_scenarios(
        tsyn.traffic_like(seed=seed, num_blocks=30, m=150, num_eq=8, noise=0.3), scenarios)
    b = np.concatenate([prob.b, np.broadcast_to(prob.d, (scenarios, prob.C.shape[0]))], -1)
    st = Problem(A=VStackMatrix(top=prob.A, bottom=ScaledMatrix(prob.C, scale)), b=b,
                 partition=prob.partition)
    return bt.prepare(st, layout="gather", device="cpu")


def _state(dp, method="pgd", line_search="exact"):
    opts = TB.SolveOptions(method=method, line_search=line_search)
    return TB._get_solver(method).init(dp, 1.0, opts), opts


def test_chunk_key_hits_and_misses():
    dp = _dp()
    st, opts = _state(dp)
    key = G.chunk_key(opts, 10, dp, st)
    # another b, another tol or max_iter, another state of the same shapes: one key
    same = [
        G.chunk_key(opts, 10, dataclasses.replace(dp, b=dp.b + 1.0), st),
        G.chunk_key(dataclasses.replace(opts, tol=0.5, max_iter=7), 10, dp, st),
        G.chunk_key(opts, 10, dp, dataclasses.replace(st, f=st.f * 2)),
    ]
    assert all(k == key for k in same)
    st64, _ = _state(_dp(dtype=torch.float64))
    dp2 = dataclasses.replace(dp, b=dp.b[:2])
    other = {
        "method": G.chunk_key(dataclasses.replace(opts, method="apgd"), 10, dp, st),
        "options": G.chunk_key(dataclasses.replace(opts, line_search="bbm"), 10, dp,
                               st),
        "chunk": G.chunk_key(opts, 20, dp, st),
        "shape": G.chunk_key(opts, 10, dp2, _state(dp2)[0]),  # the same operator, S = 2
        "dtype": G.chunk_key(opts, 10, dp, st64),
        "operator": G.chunk_key(opts, 10, _dp(), st),  # equal values, new tensors
        "b_shape": G.chunk_key(opts, 10, dataclasses.replace(dp, b=dp.b[:2]), st),
    }
    for what, k in other.items():
        assert k != key, what


def test_chunk_key_of_a_stacked_operator():
    dp = _stacked()
    st, opts = _state(dp)
    key = G.chunk_key(opts, 10, dp, st)
    # a new sqrt(rho) and a new b each outer: the same program
    outer = dataclasses.replace(dp, b=dp.b * 0.5, A=dataclasses.replace(
        dp.A, bottom_scale=torch.tensor(2.5)))
    assert G.chunk_key(opts, 10, outer, st) == key
    assert G.problem_inputs(outer)[1].item() == 2.5
    assert G.chunk_key(opts, 10, _stacked(), st) != key  # re-prepared


def test_state_fields_must_be_tensors():
    dp = _dp()
    st, opts = _state(dp)
    with pytest.raises(TypeError, match="on the device"):
        G.chunk_key(opts, 10, dp, dataclasses.replace(st, k=3))


def test_program_cache_bound_and_freed_operator():
    cache = G.ProgramCache(2)
    ops = {name: [torch.zeros(2)] for name in "abc"}
    made = []

    def get(name):
        return cache.get(name, ops[name], lambda: made.append(name) or name)

    assert [get("a"), get("b"), get("a")] == ["a", "b", "a"]
    assert made == ["a", "b"] and cache.stats["hits"] == 1
    get("c")  # the bound: "b", used least recently, goes
    assert len(cache) == 2 and cache.stats["evictions"] == 1
    get("a")
    get("b")
    assert made == ["a", "b", "c", "b"]
    # an operator freed: its entry goes at the next get; a new tensor under a
    # reused key is a miss, never the old program
    del ops["b"]
    gc.collect()
    get("a")
    assert len(cache) == 1 and cache.stats["evictions"] == 3
    ops["b"] = [torch.zeros(2)]
    get("b")
    assert made[-1] == "b" and len(made) == 5
    cache.clear()
    assert len(cache) == 0


# ------------------------------------------------------------ the binding


@pytest.mark.parametrize("method,line_search", [("pgd", "bb"), ("pgd", "pava"),
                                                ("lbfgs", "exact"), ("afw", "exact")])
def test_program_binding_equals_eager(method, line_search):
    dp = _stacked()
    mod = TB._get_solver(method)
    opts = TB.SolveOptions(method=method, line_search=line_search)
    L0 = TB.power_lipschitz(dp)
    st0 = mod.init(dp, L0, opts)
    prog = G.ChunkProgram(dp, mod, opts, L0, 5, st0)
    calls = [(dp, L0), (dataclasses.replace(dp, b=dp.b * 0.7, A=dataclasses.replace(
        dp.A, bottom_scale=torch.tensor(2.0))), 1.7 * L0),
        (dataclasses.replace(dp, b=dp.b + 0.1), torch.tensor(2.0 * L0))]
    outs, st = [], st0
    for dpc, Lc in calls:
        got, (tf, tg) = prog.run(dpc, st, Lc)
        want, (wf, wg) = TB.make_chunk_runner(dpc, mod, opts, Lc, 5)(st)
        torch.testing.assert_close(tf, wf, rtol=0, atol=0)
        torch.testing.assert_close(tg, wg, rtol=0, atol=0)
        for a, b in zip(G._state_leaves(got)[1], G._state_leaves(want)[1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        outs.append((got, tf.clone(), [t.clone() for t in G._state_leaves(got)[1]]))
        st = got
    # every call's result stands after the later calls
    for got, tf, leaves in outs:
        for a, b in zip(G._state_leaves(got)[1], leaves):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the program holds copies: the caller's b and state may change
    assert prog._inputs[0].data_ptr() != dp.b.data_ptr()


def test_eager_runner_takes_l_as_tensor():
    dp = _dp()
    st, opts = _state(dp, line_search="bb")
    L0 = TB.power_lipschitz(dp)
    a = TB.make_chunk_runner(dp, TB._get_solver("pgd"), opts, L0, 4)(st)
    b = TB.make_chunk_runner(dp, TB._get_solver("pgd"), opts, torch.tensor(L0), 4)(st)
    torch.testing.assert_close(a[1][0], b[1][0], rtol=0, atol=0)


def test_graph_runner_refuses_the_cpu():
    dp = _dp()
    st, opts = _state(dp)
    with pytest.raises(ValueError, match="CUDA"):
        G.graph_runner(dp, TB._get_solver("pgd"), opts, 1.0, 10, st)
    assert G.graph_stats()["captures"] == 0

