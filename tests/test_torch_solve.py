"""The slice as a whole: ``bsls_tpu_torch.solve`` on the CPU against
``bsls_tpu.solve`` on the same instance with the same Lipschitz value, and
against the float64 oracle."""
import numpy as np
import pytest
import torch

import bsls_tpu
import bsls_tpu.ops.layout as JL
import bsls_tpu_torch as bt
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.solvers.base import StopTracker, power_lipschitz, power_lipschitz_z
from torch_port_helpers import KERNELS, small_instance
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _lipschitz(prob, line_search):
    dp = bt.prepare(prob, layout="gather", device="cpu")
    return (power_lipschitz_z if line_search == "pava" else power_lipschitz)(dp)


def _feasible(x, sizes, atol=1e-6):
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    assert x.min() >= 0.0
    np.testing.assert_allclose(np.add.reduceat(x, offs, axis=-1), 1.0, atol=atol)


@pytest.mark.parametrize("kind,scenarios,line_search", [
    ("dense", 1, "exact"), ("dense", 3, "pava"), ("dense", 3, "exact"),
    ("ell", 3, "exact"), ("ell", 1, "pava"), ("ell", 1, "exact"),
])
def test_solve_matches_reference_solve(kind, scenarios, line_search):
    pt = small_instance(tsyn, kind, scenarios)
    pj = small_instance(jsyn, kind, scenarios)
    L_est = _lipschitz(pt, line_search)
    kw = dict(method="pgd", line_search=line_search, tol=0.0, max_iter=200, chunk=100,
              lipschitz=L_est)
    # layout="gather" on both sides: for S < 16 "auto" may pick the banded
    # layout, which tests/test_torch_banded.py covers
    res = bt.solve(bt.prepare(pt, layout="gather", device="cpu"), **kw)
    ref = bsls_tpu.solve(JL.prepare(pj, layout="gather"), **kw)
    lead = () if scenarios == 1 else (scenarios,)
    assert res.trace_f.shape == lead + (200,) and res.x.shape == lead + (pt.partition.n_flat,)
    assert res.iterations == ref.iterations == 200 and not res.converged
    assert res.stop_reason == ref.stop_reason == "max_iter"
    if line_search == "exact":
        # fp32 on both sides with sums in another order, 200 steps deep
        np.testing.assert_allclose(res.trace_f, ref.trace_f, rtol=1e-3)
        np.testing.assert_allclose(res.x, ref.x, atol=1e-4)
        np.testing.assert_allclose(res.objective, ref.objective, rtol=1e-3)
    else:
        # pava takes Barzilai-Borwein trial steps, and that iteration is
        # chaotic: the reference run against itself with lipschitz * (1 + 1e-6)
        # leaves rtol 1e-3 after some 60 steps and ends 17% apart on the ELL
        # instance (and by 86% under another thread count).  So the traces are
        # held together while rounding has not yet been amplified, and the
        # ends only to one decade, after the five to seven decades both descend.
        np.testing.assert_allclose(res.trace_f[..., :30], ref.trace_f[..., :30], rtol=1e-3)
        assert np.all(np.abs(np.log10(res.objective / ref.objective)) <= 1.0)
        assert np.all(res.trace_f[..., -1] < 1e-2 * res.trace_f[..., 0])
    _feasible(res.x, pt.partition.sizes)
    # the device's fp32 objective against the float64 objective of the x it returns
    np.testing.assert_allclose(pt.objective_np(res.x), res.objective, rtol=1e-3, atol=1e-6)
    assert np.all(np.diff(res.trace_f, axis=-1) <= 1e-5 * np.abs(res.trace_f[..., :-1]) + 1e-7)
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_converged_solve_reaches_the_oracle(kind):
    prob = small_instance(tsyn, kind)
    orc = bt.oracle_solve(prob)
    res = bt.solve(prob, line_search="bbm", tol=0.0, max_iter=1500, chunk=500, device="cpu")
    f64 = prob.objective_np(res.x)
    assert f64 >= orc.objective - 1e-9
    assert f64 - orc.objective <= 1e-4 * max(1.0, abs(orc.objective))
    _feasible(res.x, prob.partition.sizes)


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_stop_rule_matches_reference(kind):
    pt, pj = small_instance(tsyn, kind, 3), small_instance(jsyn, kind, 3)
    L_est = _lipschitz(pt, "exact")
    kw = dict(method="pgd", line_search="exact", tol=1e-4, max_iter=3000, chunk=100,
              lipschitz=L_est)
    res = bt.solve(bt.prepare(pt, layout="gather", device="cpu"), **kw)
    ref = bsls_tpu.solve(JL.prepare(pj, layout="gather"), **kw)
    assert res.converged and ref.converged
    assert res.stop_reason == ref.stop_reason
    assert abs(res.iterations - ref.iterations) <= 100  # at most one chunk apart
    assert res.chunk_iters[-1] == res.iterations and len(res.chunk_times) == len(res.chunk_iters)
    assert res.steady_iters_per_sec() > 0


def test_stop_tracker_rules():
    gap = StopTracker(1e-3, "gap")
    assert not gap.update(np.array([1.0, 1.0]), np.array([1e-4, 1e-2]))
    assert gap.update(np.array([1.0, 1.0]), np.array([1e-4, 1e-4])) and gap.reason == "gap"
    stall = StopTracker(1e-3, "auto")
    assert not stall.update(1.0, 1.0)
    assert not stall.update(1.0, 1.0)
    assert stall.update(1.0, 1.0) and stall.reason == "stall"
    assert StopTracker(0.0, "stall").rule == "gap"
    with pytest.raises(ValueError):
        StopTracker(1e-3, "never")


def test_warm_start_device_problem_and_callbacks(tmp_path):
    prob = small_instance(tsyn, "ell", 3)
    dp = bt.prepare(prob, device="cpu")
    cold = bt.solve(dp, tol=0.0, max_iter=100, chunk=50)  # a DeviceProblem runs where it lies
    seen = []
    from bsls_tpu_torch.utils.metrics import MetricsWriter

    with MetricsWriter(str(tmp_path / "m.jsonl")) as mw:
        warm = bt.solve(prob, tol=0.0, max_iter=50, chunk=50, x0=cold.x, device="cpu",
                        callback=lambda it, st: seen.append((it, st.k.tolist())), metrics=mw)
    assert seen == [(50, [50] * 3)]
    assert (tmp_path / "m.jsonl").read_text().count('"kind": "chunk"') == 1
    assert np.all(warm.trace_f[:, 0] <= cold.trace_f[:, -1] * (1 + 1e-4))
    single = small_instance(tsyn, "dense")
    res = bt.solve(single, tol=0.0, max_iter=20, chunk=10, x0=bt.oracle_solve(single).x,
                   device="cpu", space="z", dtype=torch.float32)
    assert res.x.ndim == 1 and res.trace_f.shape == (20,)
    t6 = res.time_to_gap(float(res.trace_f[-1]), rel=1.0)
    assert t6 is not None and t6 >= 0.0
