"""The fused chunk of the PyTorch port against the JAX package: the plain
version of the kernel against ``pgd_chunk_fused`` in interpret mode, the
eligibility gate case by case, and ``solve`` with the gate set against the
reference's ``solve`` with the gate set."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu
import bsls_tpu.ops.layout as JL
import bsls_tpu.solvers.mega as jmega
import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.layout as TL
import bsls_tpu_torch.solvers.mega as tmega
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu.ops.pallas.megastep_kernel import pgd_chunk_fused, split_slots
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.ops.chunkkernel import pgd_chunk, pgd_chunk_plain
from bsls_tpu_torch.solvers.base import SolveOptions, power_lipschitz
from torch_port_helpers import KERNELS

SMALL = dict(seed=0, num_blocks=40, dim=8, m=320)


def _clear():
    jmega.use_mega.cache_clear()
    tmega.use_mega.cache_clear()


@pytest.fixture()
def gate(monkeypatch):
    """Sets the gate for one test in both packages and takes it away again,
    so that no other test of the run sees it."""
    monkeypatch.delenv("BSLS_NO_MEGA", raising=False)
    monkeypatch.setenv("BSLS_MEGA", "1")
    _clear()
    yield monkeypatch
    monkeypatch.undo()
    _clear()


@pytest.mark.parametrize("steps", [1, 200])
def test_plain_chunk_matches_pallas_interpret(steps):
    dt = TL.prepare(tsyn.tiny_dense(**SMALL), device="cpu")
    dj = JL.prepare(jsyn.tiny_dense(**SMALL))
    assert len(dt.buckets) == 1
    bk = dt.buckets[0]
    t0 = 1.0 / power_lipschitz(dt)
    x0 = TL.feasible_init(dt)[0]
    x, f = pgd_chunk(dt.A.data, dt.b, x0, bk.sizes, bk.radius, t0, steps)
    B, w = bk.mask.shape
    A3, At3 = split_slots(dj.A.data, B, w)
    xj, fj = pgd_chunk_fused(A3, At3, dj.b, jnp.asarray(x0.numpy()), dj.buckets[0].sizes,
                             dj.buckets[0].radius, t0, steps=steps, interpret=True)
    assert x.shape == (B, w) and f.shape == (steps,)
    # fp32 on both sides, sums in another order, bisection against the exact
    # threshold: the limits of tests/test_pallas.py for this kernel
    rel = np.abs(f.numpy() - np.asarray(fj)) / np.maximum(1e-9, np.abs(np.asarray(fj)))
    assert rel.max() < 1e-3
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=2e-5)
    assert x.numpy()[bk.mask.numpy() > 0].min() >= 0
    np.testing.assert_allclose((x * bk.mask).sum(-1).numpy(), bk.radius.numpy(), rtol=1e-5)
    np.testing.assert_array_equal(
        pgd_chunk_plain(dt.A.data, dt.b, x0, bk.sizes, bk.radius, t0, steps)[1].numpy(), f.numpy())


def test_chunk_wrapper_checks_its_arguments():
    dt = TL.prepare(tsyn.tiny_dense(seed=1, num_blocks=6, dim=4, m=30), device="cpu")
    bk = dt.buckets[0]
    x0 = TL.feasible_init(dt)[0]
    with pytest.raises(ValueError, match="shapes do not match"):
        pgd_chunk(dt.A.data, dt.b[:-1], x0, bk.sizes, bk.radius, 0.1, 5)
    with pytest.raises(ValueError, match="shapes do not match"):
        pgd_chunk(dt.A.data, dt.b, x0, bk.sizes[:-1], bk.radius, 0.1, 5)
    with pytest.raises(ValueError, match="steps"):
        pgd_chunk(dt.A.data, dt.b, x0, bk.sizes, bk.radius, 0.1, 0)
    with pytest.raises(ValueError, match="expected A"):
        pgd_chunk(dt.A.data, dt.b[None], x0, bk.sizes, bk.radius, 0.1, 5)


CASES = {
    "dense_exact": (lambda s: s.tiny_dense(seed=0, num_blocks=30, dim=6, m=200), "pgd", "exact", "x", True),
    "wrong_method": (lambda s: s.tiny_dense(seed=0, num_blocks=30, dim=6, m=200), "apgd", "exact", "x", False),
    "wrong_line_search": (lambda s: s.tiny_dense(seed=0, num_blocks=30, dim=6, m=200), "pgd", "bb", "x", False),
    "z_space": (lambda s: s.tiny_dense(seed=0, num_blocks=30, dim=6, m=200), "pgd", "exact", "z", False),
    "multi_rhs": (lambda s: s.with_scenarios(s.tiny_dense(seed=0, num_blocks=30, dim=6, m=200), 4),
                  "pgd", "exact", "x", False),
    "sparse": (lambda s: s.medium_sparse(seed=1, num_blocks=50, m=500), "pgd", "exact", "x", False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_eligibility_gate_matches_reference(name, gate):
    make, method, line_search, space, want = CASES[name]
    import bsls_tpu.solvers.base as JBase

    dt = TL.prepare(make(tsyn), device="cpu")
    dj = JL.prepare(make(jsyn))
    to = SolveOptions(method=method, line_search=line_search, space=space)
    jo = JBase.SolveOptions(method=method, line_search=line_search, space=space)
    assert tmega.mega_eligible(dt, method, to) == want
    assert jmega.mega_eligible(dj, method, jo) == want
    assert (tmega.make_mega_runner(dt, method, to, 1.0, 10) is not None) == want


def test_gate_is_off_by_default_and_no_mega_wins(gate):
    dt = TL.prepare(tsyn.tiny_dense(seed=0, num_blocks=30, dim=6, m=200), device="cpu")
    opts = SolveOptions()
    assert tmega.mega_eligible(dt, "pgd", opts)
    gate.setenv("BSLS_NO_MEGA", "1")
    _clear()
    assert not tmega.use_mega() and not jmega.use_mega()
    gate.delenv("BSLS_NO_MEGA")
    gate.delenv("BSLS_MEGA")
    _clear()
    assert not tmega.use_mega() and not tmega.mega_eligible(dt, "pgd", opts)


def test_size_and_shape_limits(gate):
    opts = SolveOptions()
    ragged = TL.prepare(bt.Problem.from_arrays(
        np.random.default_rng(0).standard_normal((20, 9)), np.ones(20), np.array([2, 3, 4])),
        device="cpu")
    assert len(ragged.buckets) > 1 and not tmega.mega_eligible(ragged, "pgd", opts)
    dt = TL.prepare(tsyn.tiny_dense(seed=0, num_blocks=30, dim=6, m=200), device="cpu")
    gate.setattr(tmega, "MAX_A_BYTES", dt.A.data.numel() * 4 - 1)
    assert not tmega.mega_eligible(dt, "pgd", opts)
    f64 = TL.prepare(tsyn.tiny_dense(seed=0, num_blocks=30, dim=6, m=200), dtype=torch.float64,
                     device="cpu")
    assert not tmega.mega_eligible(f64, "pgd", opts)


def test_gated_solve_matches_reference_gated_solve(gate):
    pt, pj = tsyn.tiny_dense(**SMALL), jsyn.tiny_dense(**SMALL)
    L_est = power_lipschitz(TL.prepare(pt, device="cpu"))
    kw = dict(method="pgd", line_search="exact", max_iter=200, chunk=100, tol=0,
              lipschitz=L_est)
    bt.reset_launch_counts()
    res = bt.solve(pt, device="cpu", **kw)
    ref = bsls_tpu.solve(pj, **kw)
    # the gap trace repeats the boundary value: that is how the runner shows
    assert np.all(res.trace_gap[:100] == res.trace_gap[99])
    assert np.all(np.asarray(ref.trace_gap)[:100] == np.asarray(ref.trace_gap)[99])
    np.testing.assert_allclose(res.trace_f, np.asarray(ref.trace_f), rtol=1e-3)
    np.testing.assert_allclose(res.x, ref.x, atol=2e-4)
    np.testing.assert_allclose(res.trace_gap[[99, 199]], np.asarray(ref.trace_gap)[[99, 199]],
                               rtol=2e-3)
    assert np.isfinite(float(res.gap)) and res.iterations == 200
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)  # the CPU took the plain version

    # against the port's own eager path
    gate.setenv("BSLS_NO_MEGA", "1")
    _clear()
    eager = bt.solve(pt, device="cpu", **kw)
    assert not np.all(eager.trace_gap[:100] == eager.trace_gap[99])
    np.testing.assert_allclose(res.trace_f, eager.trace_f, rtol=1e-3)
    np.testing.assert_allclose(res.x, eager.x, atol=2e-4)
    assert res.trace_gap.shape == eager.trace_gap.shape


def test_gated_solve_keeps_the_eager_path_where_not_eligible(gate):
    prob = tsyn.with_scenarios(tsyn.tiny_dense(**SMALL), 2)
    res = bt.solve(prob, device="cpu", max_iter=20, chunk=10, tol=0)
    assert res.trace_f.shape == (2, 20)
    assert not np.all(res.trace_gap[:, :10] == res.trace_gap[:, 9:10])
    warm = bt.solve(tsyn.tiny_dense(**SMALL), device="cpu", max_iter=20, chunk=10, tol=0,
                    x0=bt.oracle_solve(tsyn.tiny_dense(**SMALL)).x, step_size=1e-3)
    assert warm.trace_f.shape == (20,) and np.all(np.diff(warm.trace_f) <= 1e-7)
