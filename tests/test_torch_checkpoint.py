"""Checkpoint / resume of the PyTorch port (``bsls_tpu_torch.utils.checkpoint``,
``solve(checkpoint_path=, resume=)`` and the equality-constrained loop's
outer checkpoint): every family's state round trips leaf for leaf, a file of
another dtype or structure is refused, rotation names and the newest
checkpoint agree with ``bsls_tpu.utils.checkpoint``, a resumed solve matches
an uninterrupted one, and a solver process killed with SIGKILL resumes from
its last atomic checkpoint."""
import dataclasses
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import bsls_tpu.utils.checkpoint as JCK
import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.layout as TL
import bsls_tpu_torch.utils.checkpoint as TCK
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.solvers.base import SolveOptions, _get_solver, power_lipschitz
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# method, line search: one case per state class (FWState with and without
# the pairwise diag)
FAMILIES = [("pgd", "bb"), ("apgd", "exact"), ("lbfgs", "exact"), ("eg", "exact"),
            ("frank_wolfe", "exact"), ("afw", "exact")]


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


def _tiny(scenarios=2):
    prob = tsyn.tiny_dense(seed=1, num_blocks=12, dim=5, m=60)
    return tsyn.with_scenarios(prob, scenarios, seed=2) if scenarios > 1 else prob


def _state(method, line_search, steps=3):
    dp = TL.prepare(_tiny(), device="cpu")
    mod = _get_solver(method)
    opts = SolveOptions(method=method, line_search=line_search)
    L_est = power_lipschitz(dp)
    st = mod.init(dp, L_est, opts)
    fresh = st
    for _ in range(steps):
        st = mod.step(dp, st, L_est, opts)
    return fresh, st


def _leaves(st):
    _, leaves = TCK._flatten(st)
    return leaves


@pytest.mark.parametrize("method,line_search", FAMILIES)
def test_state_round_trips_leaf_for_leaf(tmp_path, method, line_search):
    fresh, st = _state(method, line_search)
    path = str(tmp_path / "ck.npz")
    TCK.save_state(path, st, meta={"iteration": 3})
    back, meta = TCK.load_state(path, fresh)
    assert meta == {"iteration": 3} and type(back) is type(st)
    for f in dataclasses.fields(st):
        a, b = getattr(st, f.name), getattr(back, f.name)
        if a is None:
            assert b is None, f.name
            continue
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            if isinstance(x, torch.Tensor):
                assert isinstance(y, torch.Tensor) and y.device == x.device, f.name
                assert (y.shape, y.dtype) == (x.shape, x.dtype), f.name
                assert torch.equal(x, y), f.name
            else:
                assert type(y) is type(x) and y == x, f.name
    assert len(_leaves(back)) == len(_leaves(st))


def test_load_refuses_another_dtype_shape_or_structure(tmp_path):
    fresh, st = _state("pgd", "exact")
    path = str(tmp_path / "ck.npz")
    TCK.save_state(path, st)
    as64 = dataclasses.replace(fresh, f=fresh.f.double())
    with pytest.raises(ValueError, match="dtype"):
        TCK.load_state(path, as64)
    wider = dataclasses.replace(fresh, gap=torch.zeros(5))
    with pytest.raises(ValueError, match="shape"):
        TCK.load_state(path, wider)
    # the same field names under another class (EGState), and another class
    # altogether, are refused by their structure
    eg_fresh, _ = _state("eg", "exact", steps=0)
    with pytest.raises(ValueError, match="EGState"):
        TCK.load_state(path, eg_fresh)
    lb_fresh, _ = _state("lbfgs", "exact", steps=0)
    with pytest.raises(ValueError, match="PGDState"):
        TCK.load_state(path, lb_fresh)
    TCK.save_state(path, {"lam": np.zeros(3), "x": np.zeros(4)})
    with pytest.raises(ValueError, match="dict"):
        TCK.load_state(path, {"lam": np.zeros(3), "y": np.zeros(4)})
    with pytest.raises(ValueError, match="dtype"):
        TCK.load_state(path, {"lam": np.zeros(3, np.float32), "x": np.zeros(4)})


def test_rotation_names_and_latest_checkpoint_agree_with_reference(tmp_path):
    state = {"lam": np.arange(3.0), "x": np.ones(4)}
    path = str(tmp_path / "run" / "ck.npz")
    assert TCK.latest_checkpoint(path) is None and JCK.latest_checkpoint(path) is None
    for it in (100, 200, 300, 1200):
        TCK.save_state(path, state, meta={"iteration": it}, keep=2)
    names = sorted(os.listdir(tmp_path / "run"))
    assert names == ["ck.it000000300.npz", "ck.it000001200.npz"]
    assert TCK.latest_checkpoint(path) == JCK.latest_checkpoint(path)
    assert TCK.latest_checkpoint(path).endswith("ck.it000001200.npz")
    back, meta = TCK.load_state(TCK.latest_checkpoint(path), state)
    assert meta["iteration"] == 1200 and np.array_equal(back["lam"], state["lam"])
    # without rotation the plain file is the newest, in both packages
    plain = str(tmp_path / "plain.npz")
    TCK.save_state(plain, state, meta={"iteration": 5})
    assert os.listdir(tmp_path).count("plain.npz") == 1
    assert TCK.latest_checkpoint(plain) == JCK.latest_checkpoint(plain) == plain
    stem = str(tmp_path / "plain")
    assert TCK.latest_checkpoint(stem) == JCK.latest_checkpoint(stem) == plain


@pytest.mark.parametrize("method,line_search", [("pgd", "exact"), ("lbfgs", "exact"),
                                                ("afw", "exact")])
def test_solve_resume_matches_an_uninterrupted_run(tmp_path, method, line_search):
    prob = _tiny()
    kw = dict(method=method, line_search=line_search, tol=0.0, chunk=50, device="cpu",
              lipschitz=power_lipschitz(TL.prepare(prob, device="cpu")))
    ck = str(tmp_path / "ck.npz")
    full = bt.solve(prob, max_iter=400, **kw)
    first = bt.solve(prob, max_iter=200, checkpoint_path=ck, checkpoint_every=1,
                     checkpoint_keep=2, **kw)
    assert sorted(os.listdir(tmp_path)) == ["ck.it000000150.npz", "ck.it000000200.npz"]
    resumed = bt.solve(prob, max_iter=400, checkpoint_path=ck, checkpoint_every=2,
                       checkpoint_keep=2, resume=True, **kw)
    assert first.iterations == 200 and resumed.iterations == 400
    assert resumed.trace_f.shape == (2, 200) and list(resumed.chunk_iters) == [250, 300, 350, 400]
    np.testing.assert_array_equal(resumed.trace_f, full.trace_f[:, 200:])
    np.testing.assert_array_equal(resumed.x, full.x)
    # the end of the resumed run is saved too; a resume at max_iter runs nothing
    assert TCK.latest_checkpoint(ck).endswith("it000000400.npz")
    again = bt.solve(prob, max_iter=400, checkpoint_path=ck, resume=True, **kw)
    assert again.iterations == 400 and again.trace_f.shape == (2, 0)
    np.testing.assert_array_equal(again.x, full.x)


def test_solve_without_resume_ignores_an_old_checkpoint(tmp_path):
    prob = _tiny(1)
    ck = str(tmp_path / "ck.npz")
    bt.solve(prob, max_iter=100, chunk=50, checkpoint_path=ck, checkpoint_every=1, device="cpu")
    res = bt.solve(prob, max_iter=100, chunk=50, checkpoint_path=ck, device="cpu")
    assert res.iterations == 100 and res.trace_f.shape == (100,)


def _eq_small():
    return tsyn.traffic_like(seed=0, num_blocks=12, m=60, num_eq=4)


def test_eq_outer_checkpoint_and_resume(tmp_path):
    """The AL loop saves {lam, x} (float64) and its outer state per outer;
    resumed with the same op_cache (so the stacked operator and its
    constants are those of the first run) it continues the uninterrupted
    run outer for outer."""
    prob = _eq_small()
    kw = dict(method="pgd", tol=1e-12, eq_tol=1e-12, max_iter=10_000, inner_iters=100,
              chunk=50, device="cpu")
    cache = {}
    full = bt.solve_equality_constrained(prob, outer_iters=4, op_cache=cache, **kw)
    ck = str(tmp_path / "eq.npz")
    first = bt.solve_equality_constrained(prob, outer_iters=2, op_cache=cache,
                                          checkpoint_path=ck, checkpoint_every=1, **kw)
    state, meta = TCK.load_state(ck, {"lam": np.zeros(4), "x": np.zeros(prob.partition.n_flat)})
    assert meta["iteration"] == 2 and meta["total_iters"] == first.iterations == 200
    assert meta["rho"] == first.eq_rho and meta["viol"] == first.eq_violation
    np.testing.assert_array_equal(state["lam"], first.eq_lam)
    np.testing.assert_array_equal(state["x"], first.x.astype(np.float64))
    resumed = bt.solve_equality_constrained(prob, outer_iters=4, op_cache=cache,
                                            checkpoint_path=ck, resume=True, **kw)
    assert resumed.iterations == full.iterations == 400
    np.testing.assert_array_equal(resumed.x, full.x)
    np.testing.assert_array_equal(resumed.eq_lam, full.eq_lam)
    assert resumed.eq_rho == full.eq_rho
    # solve() forwards all four options to the eq path
    res = bt.solve(prob, method="pgd", tol=1e-12, max_iter=100, chunk=50, device="cpu",
                   checkpoint_path=str(tmp_path / "via_solve"), checkpoint_every=1,
                   checkpoint_keep=1)
    assert os.listdir(tmp_path).count("via_solve.it000000001.npz") == 1
    assert res.iterations == 100


def test_eq_resume_of_an_exhausted_budget(tmp_path):
    """Resuming an eq solve whose checkpointed inner iterations already meet
    max_iter returns the checkpointed state (stop_reason "budget_exhausted");
    a larger budget continues from it.  The port's copy of the reference's
    test_equality_constrained_resume_exhausted_budget."""
    prob = tsyn.traffic_like(num_blocks=40, m=200, num_eq=10, noise=0.0)
    ck = str(tmp_path / "eq_ck")
    kw = dict(method="apgd", tol=1e-7, checkpoint_path=ck, checkpoint_every=1, device="cpu")
    first = bt.solve(prob, max_iter=120, chunk=40, **kw)
    assert first.iterations >= 120  # the budget binds on this instance
    resumed = bt.solve(prob, max_iter=120, chunk=40, resume=True, **kw)
    assert resumed.stop_reason == "budget_exhausted"
    assert not resumed.converged
    assert resumed.x.shape == first.x.shape
    np.testing.assert_allclose(np.asarray(resumed.x, np.float64),
                               np.asarray(first.x, np.float64), rtol=1e-5, atol=1e-6)
    cont = bt.solve(prob, max_iter=1000, chunk=200, resume=True, **kw)
    assert cont.iterations > 120
    assert float(cont.objective) <= float(first.objective) + 1e-8


def test_kill_and_resume(tmp_path):
    """SIGKILL a solver subprocess mid-run, then resume from its last
    atomic checkpoint and match the uninterrupted objective (the port's
    copy of tests/test_harness.py::test_kill_and_resume, on the CPU)."""
    ck = str(tmp_path / "kill_ck.npz")
    script = f"""
import time
import bsls_tpu_torch as bt
prob = bt.synthetic.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
# throttle chunks so that the parent's SIGKILL lands well before iteration
# 400 (a resume from any checkpoint below 400 follows the same trajectory)
bt.solve(prob, method="pgd", tol=0.0, max_iter=100000, chunk=50, device="cpu",
         checkpoint_path={ck!r}, checkpoint_every=1, callback=lambda it, st: time.sleep(0.3))
"""
    proc = subprocess.Popen([sys.executable, "-c", script], cwd=REPO,
                            env={**os.environ, "OMP_NUM_THREADS": "1"},
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 120
        while time.time() < deadline and not os.path.exists(ck):
            if proc.poll() is not None:
                raise AssertionError("the subprocess exited before its first checkpoint")
            time.sleep(0.1)
        assert os.path.exists(ck), "no checkpoint appeared in time"
        os.kill(proc.pid, signal.SIGKILL)  # the exact PID, never a pattern
    finally:
        proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    _, meta = TCK.load_state(ck, _state_like(ck))
    assert 0 < meta["iteration"] < 400
    prob = tsyn.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
    full = bt.solve(prob, method="pgd", tol=0.0, max_iter=400, chunk=50, device="cpu")
    resumed = bt.solve(prob, method="pgd", tol=0.0, max_iter=400, chunk=50, device="cpu",
                       checkpoint_path=ck, checkpoint_every=1, resume=True)
    assert resumed.iterations == 400 and resumed.trace_f.shape[0] < 400
    np.testing.assert_allclose(float(resumed.objective), float(full.objective), rtol=1e-5,
                               atol=1e-8)


def _state_like(ck):
    """A fresh pgd state of the kill test's instance, to read its meta."""
    prob = tsyn.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
    dp = TL.prepare(prob, device="cpu")
    mod = _get_solver("pgd")
    return mod.init(dp, 1.0, SolveOptions())
