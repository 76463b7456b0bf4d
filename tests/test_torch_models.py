"""Host layer of the PyTorch port against the JAX package: the same seed
gives the same instance, and ``prepare`` builds the same device arrays."""
import os

import numpy as np
import pytest
import torch

import bsls_tpu
import bsls_tpu.ops.layout as JL
import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.layout as TL
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu_torch.models import synthetic as tsyn
from torch_port_helpers import flatten_device_problem, small_instance

GENERATORS = {
    "tiny_dense": lambda s: s.tiny_dense(seed=5, num_blocks=10, dim=4, m=40),
    "medium_sparse": lambda s: s.medium_sparse(seed=5, num_blocks=50, m=300),
    "medium_banded": lambda s: s.medium_banded(seed=5, num_blocks=50, m=400, spread=20),
    "traffic_like": lambda s: s.traffic_like(seed=5, num_blocks=30, m=100, num_eq=5),
    "large_sharded": lambda s: s.large_sharded(seed=5, num_blocks=40, dim=4, m=128,
                                              num_scenarios=2),
    "with_scenarios": lambda s: s.with_scenarios(
        s.medium_sparse(seed=5, num_blocks=50, m=300), 3, seed=6),
    "make_config": lambda s: s.make_config("tiny", seed=2, num_blocks=6, dim=3, m=20),
}


def _matrix_arrays(M):
    if hasattr(M, "data"):
        return {"data": M.data}
    return {"rows": M.rows, "vals": M.vals, "num_rows": np.asarray(M.num_rows)}


@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_same_seed_same_problem(name):
    pj, pt = GENERATORS[name](jsyn), GENERATORS[name](tsyn)
    assert type(pj.A).__name__ == type(pt.A).__name__
    for k, a in _matrix_arrays(pj.A).items():
        np.testing.assert_array_equal(a, _matrix_arrays(pt.A)[k])
    np.testing.assert_array_equal(pj.b, pt.b)
    np.testing.assert_array_equal(pj.x_true, pt.x_true)
    np.testing.assert_array_equal(pj.partition.sizes, pt.partition.sizes)
    assert len(pj.partition.buckets) == len(pt.partition.buckets)
    for bj, bk in zip(pj.partition.buckets, pt.partition.buckets):
        assert bj.width == bk.width
        np.testing.assert_array_equal(bj.pad_to_flat, bk.pad_to_flat)
        np.testing.assert_array_equal(bj.block_ids, bk.block_ids)
    if pj.C is not None:
        np.testing.assert_array_equal(pj.C.data, pt.C.data)
        np.testing.assert_array_equal(pj.d, pt.d)


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("scenarios", [1, 3])
@pytest.mark.parametrize("equilibrate", [True, False])
def test_prepare_matches_reference(kind, scenarios, equilibrate):
    dj = flatten_device_problem(JL.prepare(
        small_instance(jsyn, kind, scenarios), layout="gather", equilibrate=equilibrate))
    dt = flatten_device_problem(TL.prepare(
        small_instance(tsyn, kind, scenarios), equilibrate=equilibrate, layout="gather",
        device="cpu"))
    assert sorted(dj) == sorted(dt)
    for key, want in dj.items():
        got = dt[key]
        if want is None or isinstance(want, int):
            assert got == want, key
        elif want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want, err_msg=key)  # exact
        else:
            # values: both stage through the same float32 numpy buffers
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=key)


def test_prepare_block_multiple_dummy_rows():
    sizes = np.array([3, 2, 4, 4, 1])
    A = np.random.default_rng(0).standard_normal((20, int(sizes.sum())))
    b = np.arange(20.0)
    pj = bsls_tpu.Problem.from_arrays(A, b, sizes, block_multiple=4)
    pt = bt.Problem.from_arrays(A, b, sizes, block_multiple=4)
    dj = flatten_device_problem(JL.prepare(pj, layout="gather"))
    dt = flatten_device_problem(TL.prepare(pt, device="cpu"))
    assert any((dt[k] == 0).any() for k in dt if k.endswith(".sizes"))  # dummy rows
    for key in dj:
        if isinstance(dj[key], np.ndarray):
            np.testing.assert_allclose(dt[key], dj[key], rtol=1e-6, err_msg=key)


def test_prepare_unported_raise():
    # the banded layout needs a sparse A; an unknown layout is an error too
    with pytest.raises(ValueError, match="banded"):
        TL.prepare(small_instance(tsyn, "dense"), layout="banded", device="cpu")
    with pytest.raises(ValueError, match="unknown layout"):
        TL.prepare(small_instance(tsyn, "ell"), layout="paged", device="cpu")
    # an equality-constrained problem goes to solve() (the augmented-
    # Lagrangian loop prepares its stacked operator); the grid instance of
    # config "traffic" is ported (tests/test_torch_traffic.py)
    with pytest.raises(ValueError, match=r"solve\(\)"):
        TL.prepare(GENERATORS["traffic_like"](tsyn), device="cpu")
    assert tsyn.make_config("traffic", nx=4, ny=4, num_od=6, num_eq=2).C.shape[0] == 2


def test_npz_roundtrip_and_cross_load(tmp_path):
    for kind in ("dense", "ell"):
        pt = small_instance(tsyn, kind, 3)
        path = str(tmp_path / f"{kind}.npz")
        pt.save_npz(path)
        back = bt.Problem.load(path)
        other = bsls_tpu.Problem.load(path)  # the reference reads the same file
        for q in (back, other):
            np.testing.assert_array_equal(q.b, pt.b)
            np.testing.assert_array_equal(q.partition.sizes, pt.partition.sizes)
            for k, a in _matrix_arrays(pt.A).items():
                np.testing.assert_array_equal(_matrix_arrays(q.A)[k], a)
    with pytest.raises(NotImplementedError):
        bt.Problem.load("instance.mat")


def test_oracle_matches_reference_oracle():
    pj, pt = small_instance(jsyn, "ell"), small_instance(tsyn, "ell")
    oj = bsls_tpu.oracle_solve(pj, max_iter=400)
    ot = bt.oracle_solve(pt, max_iter=400)
    np.testing.assert_allclose(ot.x, oj.x, rtol=0, atol=1e-12)
    assert ot.objective == pytest.approx(oj.objective, rel=1e-12)
    g = np.random.default_rng(1).standard_normal(pt.partition.n_flat)
    x = tsyn.random_block_x(np.random.default_rng(2), pt.partition.sizes)
    from bsls_tpu.models.oracle import fw_gap_np as jgap
    assert bt.models.fw_gap_np(g, x, pt.partition.sizes) == jgap(g, x, pj.partition.sizes)


def test_native_engine_matches_numpy_fallback():
    from bsls_tpu_torch import native

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 17, size=200)
    idx = rng.integers(0, 1000, size=200).astype(np.int32)
    vals = rng.standard_normal(200).astype(np.float32)
    cols, out = native.group_ell(keys, idx, vals, 17)
    cols_np, out_np = native._group_ell_numpy(
        keys.astype(np.int64), idx, vals, 17)
    np.testing.assert_array_equal(cols, cols_np)
    np.testing.assert_array_equal(out, out_np)
    import scipy.sparse as sp

    M = sp.random(30, 12, density=0.2, random_state=1, format="csc")
    ell = bt.EllMatrix.from_scipy(M)
    np.testing.assert_allclose(ell.to_scipy().toarray(), M.toarray())
    x = rng.standard_normal(12)
    np.testing.assert_allclose(ell.matvec(x), M @ x, atol=1e-12)


def test_config_loads_reference_files_and_rejects_unported():
    from bsls_tpu_torch.utils.config import RunConfig, load_config

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "configs", "medium-pgd.json"))
    assert (cfg.config, cfg.method, cfg.line_search) == ("medium", "pgd", "exact")
    with pytest.raises(NotImplementedError, match="checkpoint_path"):
        RunConfig.from_dict({"config": "tiny", "checkpoint_path": "ck"})
    with pytest.raises(NotImplementedError, match="mesh_block"):
        RunConfig.from_dict({"config": "tiny", "mesh_block": 8})
    assert load_config("tiny", device="cpu").device == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
