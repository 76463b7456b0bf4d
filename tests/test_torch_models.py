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
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

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
    # a .mat goes to the MATLAB loader: a file that is neither a classic
    # nor an HDF5 one surfaces scipy's error in both packages
    junk = tmp_path / "junk.mat"
    junk.write_bytes(b"not a MATLAB file" * 16)
    for load in (bt.Problem.load, bsls_tpu.Problem.load):
        with pytest.raises(ValueError):
            load(str(junk))


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
    # the checkpoint and profile fields are ported: they load as given
    cfg = RunConfig.from_dict({"config": "tiny", "checkpoint_path": "ck", "checkpoint_every": 2,
                               "resume": True, "profile_dir": "prof"})
    assert (cfg.checkpoint_path, cfg.checkpoint_every, cfg.resume, cfg.profile_dir) == (
        "ck", 2, True, "prof")
    # the mesh fields are ported too; a field of no counterpart still raises
    cfg = RunConfig.from_dict({"config": "tiny", "mesh_block": 8, "mesh_scenario": 2})
    assert (cfg.mesh_block, cfg.mesh_scenario) == (8, 2)
    assert load_config("large").chunk == 50 and load_config("large").mesh_block == 0
    with pytest.raises(NotImplementedError, match="unroll"):
        RunConfig.from_dict({"config": "tiny", "unroll": 4})
    assert load_config("tiny", device="cpu").device == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def _assert_same_problem(pt, pj):
    """A problem loaded by the port and by the reference: array for array."""
    np.testing.assert_array_equal(pt.b, pj.b)
    np.testing.assert_array_equal(pt.partition.sizes, pj.partition.sizes)
    assert pt.shape == pj.shape and pt.name == pj.name
    for k, a in _matrix_arrays(pj.A).items():
        np.testing.assert_array_equal(_matrix_arrays(pt.A)[k], a)
    for name in ("d", "x_true"):
        a, b = getattr(pt, name), getattr(pj, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (pt.C is None) == (pj.C is None)
    if pt.C is not None:
        for k, a in _matrix_arrays(pj.C).items():
            np.testing.assert_array_equal(_matrix_arrays(pt.C)[k], a)


def _mat_instance(seed, fmt):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    sizes = np.array([3, 4, 2])
    n = int(sizes.sum())
    A = sp.random(12, n, density=0.5, random_state=seed, format=fmt)
    x_true = np.concatenate([rng.dirichlet(np.ones(s)) for s in sizes])
    C = rng.standard_normal((2, n))
    return sizes, A, x_true, A @ x_true, C, C @ x_true


@pytest.mark.parametrize("with_c", [False, True])
def test_mat_v5_loads_like_the_reference(tmp_path, with_c):
    """A classic .mat (scipy.io.savemat, sparse A) through both packages."""
    from scipy.io import savemat

    sizes, A, x_true, b, C, d = _mat_instance(9, "csr")
    arrays = {"A": A, "b": b, "block_sizes": sizes, "x_true": x_true}
    if with_c:
        arrays.update(C=C, d=d)
    path = str(tmp_path / "inst.mat")
    savemat(path, arrays)
    pt, pj = bt.Problem.load(path), bsls_tpu.Problem.load(path)
    _assert_same_problem(pt, pj)
    assert pt.shape == (12, int(sizes.sum())) and (pt.C is not None) == with_c
    np.testing.assert_allclose(pt.A.matvec(x_true), b, atol=1e-10)


@pytest.mark.parametrize("c_rows", [2, 1])
def test_mat73_loads_like_the_reference(tmp_path, c_rows):
    """A MATLAB v7.3 (HDF5) file in MATLAB's own layout (the reference's
    tests/test_models.py::test_mat73_loader): sparse A as a CSC group with a
    MATLAB_sparse row count, dense arrays transposed, the 512-byte userblock
    with the MATLAB header (with one C row: stored (n, 1), loaded (1, n))."""
    import h5py

    sizes, A, x_true, b, C, d = _mat_instance(11, "csc")
    path = str(tmp_path / "inst73.mat")
    with h5py.File(path, "w", userblock_size=512) as f:
        g = f.create_group("A")
        g.attrs["MATLAB_sparse"] = np.uint64(A.shape[0])
        g.create_dataset("data", data=A.data)
        g.create_dataset("ir", data=A.indices.astype(np.uint64))
        g.create_dataset("jc", data=A.indptr.astype(np.uint64))
        f.create_dataset("b", data=b.reshape(1, -1))
        f.create_dataset("block_sizes", data=sizes.astype(np.float64).reshape(1, -1))
        f.create_dataset("C", data=C[:c_rows].T)
        f.create_dataset("d", data=d[:c_rows].reshape(1, -1))
        f.create_dataset("x_true", data=x_true.reshape(1, -1))
    with open(path, "r+b") as fh:
        fh.write(b"MATLAB 7.3 MAT-file" + b" " * 105 + bytes([0, 2, ord("I"), ord("M")]))
    pt, pj = bt.Problem.load(path), bsls_tpu.Problem.load(path)
    _assert_same_problem(pt, pj)
    assert pt.C.shape == (c_rows, int(sizes.sum()))
    np.testing.assert_allclose(pt.C.matvec(x_true), d[:c_rows], atol=1e-10)


def test_mat73_without_h5py_names_it(tmp_path, monkeypatch):
    """h5py is needed only for v7.3 files, and its absence is an ImportError
    that names it, not a fall-back to anything."""
    import builtins

    import h5py

    path = str(tmp_path / "bare.mat")
    with h5py.File(path, "w") as f:  # a bare HDF5 file: scipy raises ValueError
        f.create_dataset("b", data=np.zeros((1, 3)))
    real_import = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        bt.Problem.load(path)
