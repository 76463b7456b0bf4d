"""The port's sharded encodings against the reference's, with no processes.

Each rank of a mesh prepares and uploads only its own slice of the problem
(``bsls_tpu_torch.parallel.sharding``); the reference ``device_put``s global
arrays onto a mesh of the 8 virtual CPU devices of ``tests/conftest.py``.
Here a rank's slice is made directly (a ``Mesh`` holding one rank's
coordinates and no process group) and held against the reference's global
array sliced at that rank, for every encoding; the per-rank partial products
must sum to the unsharded product; and a world of one (gloo on an in-process
store) must solve as the unsharded solve does.
"""
import jax
import numpy as np
import pytest
import torch

import bsls_tpu as jb
import bsls_tpu_torch as bt
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu.ops import layout as JL
from bsls_tpu.parallel import make_mesh as jmesh
from bsls_tpu.parallel import sharding as JS
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.ops import layout as TL
from bsls_tpu_torch.parallel import mesh as TM
from bsls_tpu_torch.parallel import sharding as TS
from bsls_tpu_torch.solvers import base as TB
from torch_port_helpers import _arr
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def rank_view(shape: dict, coords: dict) -> TM.Mesh:
    """One rank's view of a mesh, without process groups."""
    return TM.Mesh(shape=dict(shape), coords=dict(coords),
                   groups=dict.fromkeys(TM.AXES), device=torch.device("cpu"), device_mesh=None)


def ranks(row=1, block=1, scenario=1):
    shape = {"row": row, "block": block, "scenario": scenario}
    for r in range(row):
        for b in range(block):
            for s in range(scenario):
                yield rank_view(shape, {"row": r, "block": b, "scenario": s})


def instances(syn, kind):
    if kind == "dense":
        return syn.tiny_dense(seed=2, num_blocks=16, dim=4, m=35)
    if kind == "ell":
        return syn.medium_sparse(seed=3, num_blocks=40, m=96)
    if kind == "uniform":
        return syn.large_sharded(seed=0, num_blocks=16, dim=4, m=64, num_scenarios=2,
                                 block_multiple=2, noise=1e-3)
    if kind == "banded":
        return syn.medium_banded(seed=6, num_blocks=32, m=2048, spread=100)
    if kind == "banded_resid":  # wide spread: some columns spill to the residual ELL
        return syn.medium_banded(seed=6, num_blocks=32, m=2048, spread=600)
    raise KeyError(kind)


# (name, instance kind, mesh shape, mode)
ENCODINGS = [
    ("col_ell", "ell", dict(block=4), "col"),
    ("col_ell_scen", "uniform", dict(block=2, scenario=2), "col"),
    ("col_dense", "dense", dict(block=4), "col"),
    ("row_dense", "dense", dict(block=4), "rows"),
    ("row_ell", "ell", dict(block=4), "rows"),
    ("grid_ell", "ell", dict(row=2, block=2), "grid"),
    ("grid_dense", "dense", dict(row=2, block=2), "grid"),
    ("banded", "banded", dict(block=4), "col"),
    ("banded_resid", "banded_resid", dict(block=2, scenario=1), "col"),
]


def port_shard(prob, view, mode, dtype=torch.float64):
    if mode == "col":
        layout = "banded" if prob.name.startswith("medium_banded") else "gather"
        return TS.shard_problem(prob, view, dtype=dtype, layout=layout)
    if mode == "rows":
        return TS.shard_problem_rows(prob, view, dtype=dtype)
    return TS.shard_problem_2d(prob, view, dtype=dtype)


def ref_shard(prob, shape, mode):
    size = int(np.prod(list(shape.values())))
    mesh = jmesh(devices=jax.devices()[:size], **shape)
    with jax.enable_x64(True):
        import jax.numpy as jnp

        if mode == "col":
            layout = "banded" if prob.name.startswith("medium_banded") else "gather"
            dp, _ = JS.shard_problem(prob, mesh, dtype=jnp.float64, layout=layout)
        elif mode == "rows":
            dp, _ = JS.shard_problem_rows(prob, mesh, dtype=jnp.float64)
        else:
            dp, _ = JS.shard_problem_2d(prob, mesh, dtype=jnp.float64)
        return jax.tree_util.tree_map(np.asarray, dp)


def _even(a, k, n, axis=0):
    size = a.shape[axis] // n
    return np.take(a, range(k * size, (k + 1) * size), axis=axis)


def _pad_cols(a, width):
    return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, width - a.shape[-1])])


def _ell_expected(A, mode, r, c, nr, nc):
    """The reference's arrays of tile (r, c) of a DeviceEll, in the port's
    local shapes."""
    if mode == "col":
        return dict(rows=_even(A.rows, c, nc), vals=_even(A.vals, c, nc),
                    mv_cols=A.mv_cols[c:c + 1], mv_vals=A.mv_vals[c:c + 1])
    if mode == "rows":
        return dict(rows=A.rows[r], vals=A.vals[r], mv_cols=A.mv_cols[r:r + 1],
                    mv_vals=A.mv_vals[r:r + 1])
    return dict(rows=A.rows[r, c], vals=A.vals[r, c], mv_cols=A.mv_cols[r, c][None],
                mv_vals=A.mv_vals[r, c][None])


@pytest.mark.parametrize("name,kind,shape,mode", ENCODINGS, ids=[e[0] for e in ENCODINGS])
def test_shard_slices_match_reference(name, kind, shape, mode):
    pt, pj = instances(tsyn, kind), instances(jsyn, kind)
    ref = ref_shard(pj, shape, mode)
    full = {"row": 1, "block": 1, "scenario": 1, **shape}
    nr = full["row"] if mode == "grid" else (full["block"] if mode == "rows" else 1)
    nc = 1 if mode == "rows" else full["block"]
    seen = 0
    for view in ranks(**shape):
        dp, _ = port_shard(pt, view, mode)
        assert hasattr(dp.A, "bands") == kind.startswith("banded")
        c = view.coords["block"] if mode != "rows" else 0
        r = view.coords["row"] if mode == "grid" else (view.coords["block"] if mode == "rows"
                                                      else 0)
        s, ns = view.coords["scenario"], full["scenario"]
        # buckets and perm follow the column shard; b the scenario and row shard
        for bt_, bj in zip(dp.buckets, ref.buckets):
            np.testing.assert_array_equal(_arr(bt_.mask), _even(bj.mask, c, nc))
            np.testing.assert_array_equal(_arr(bt_.sizes), _even(bj.sizes, c, nc))
            np.testing.assert_allclose(_arr(bt_.radius), _even(bj.radius, c, nc), rtol=1e-15)
        np.testing.assert_array_equal(_arr(dp.perm), _even(ref.perm, c, nc))
        bj = _even(np.atleast_2d(ref.b), s, ns)
        np.testing.assert_allclose(_arr(dp.b), _even(bj, r, nr, axis=1), rtol=1e-15)
        A, Aj = dp.A, ref.A
        if hasattr(Aj, "bands"):
            gl = Aj.bands[0].shape[0] // nc
            assert A.pages == Aj.pages and A.page_off == c * gl
            assert (A.back, A.wpages) == (Aj.back, Aj.wpages)
            for band, bandj in zip(A.bands, Aj.bands):
                np.testing.assert_allclose(_arr(band), bandj[c * gl:(c + 1) * gl], rtol=1e-15)
            A, Aj = A.resid, Aj.resid
            assert (A is None) == (Aj is None) == (kind == "banded")
        if Aj is None:
            pass
        elif hasattr(Aj, "data"):
            want = _even(_even(Aj.data, c, nc, axis=1), r, nr, axis=0)
            np.testing.assert_allclose(_arr(A.data), want, rtol=1e-15)
        else:
            for key, want in _ell_expected(Aj, mode, r, c, nr, nc).items():
                got = _arr(getattr(A, key))
                if key.startswith("mv"):
                    assert got.shape == want.shape, (key, got.shape, want.shape)
                np.testing.assert_allclose(got, want, rtol=1e-15, err_msg=key)
        seen += 1
    assert seen == TM.Mesh(shape=full, coords={}, groups={}, device=None,
                           device_mesh=None).size


@pytest.mark.parametrize("n", [1, 2, 4])
def test_pf_perm_matches_reference(n):
    from bsls_tpu_torch.models.partition import BlockPartition as TP

    sizes = np.random.default_rng(0).integers(1, 9, size=37)
    for bm in (1, n):
        want = JL.build_pf_perm(jb.BlockPartition.from_sizes(sizes, block_multiple=n), n)
        got = TL.build_pf_perm(TP.from_sizes(sizes, block_multiple=n), n)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="block_multiple"):
        TL.build_pf_perm(TP.from_sizes(np.full(3, 2)), 2)


@pytest.mark.parametrize("name,kind,shape,mode", ENCODINGS, ids=[e[0] for e in ENCODINGS])
def test_partial_products_sum_to_the_unsharded_product(name, kind, shape, mode):
    """Sum over column shards, concatenation over row shards: A x of the
    per-rank slices equals the host product, and each column shard's A^T r
    partials summed over the row shards equal its slice of the host A^T r
    (1e-6 relative, fp32)."""
    prob = instances(tsyn, kind)
    rng = np.random.default_rng(1)
    x = rng.random(prob.partition.n_flat)
    m = prob.A.shape[0]
    r = rng.standard_normal(m)
    y_want, g_want = prob.A.matvec(x), prob.A.rmatvec(r)
    full = {"row": 1, "block": 1, "scenario": 1, **shape}
    nr = full["row"] if mode == "grid" else (full["block"] if mode == "rows" else 1)
    m_pad = m + (-m) % nr
    m_loc = m_pad // nr
    y, g_parts = np.zeros(m_pad), {}
    for view in ranks(**shape):
        if view.coords["scenario"]:
            continue
        dp, _ = port_shard(prob, view, mode, dtype=torch.float32)
        rk = view.coords["row"] if mode == "grid" else (view.coords["block"] if mode == "rows"
                                                       else 0)
        rows = slice(rk * m_loc, (rk + 1) * m_loc)
        A = dp.A
        u = TL.padded_to_flat(dp, TL.inject_user_flat(dp, torch.as_tensor(x).float()[None]))
        y[rows] += TL.matvec(A, u)[0].double().numpy()
        r_loc = torch.as_tensor(np.pad(r, (0, m_pad - m))[rows]).float()[None]
        acc = g_parts.setdefault(view.coords["block"] if mode != "rows" else 0, [0.0, None])
        acc[0] = acc[0] + TL.rmatvec(A, r_loc)[0].double().numpy()
        acc[1] = TL.inject_user_grad(dp, torch.as_tensor(g_want).float()[None])[0].numpy()
    np.testing.assert_allclose(y[:m], y_want, rtol=1e-6, atol=1e-6 * np.abs(y_want).max())
    assert not y[m:].any()
    for got, want in g_parts.values():
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def world_of_one():
    # one thread: these solves are many small ops, which a pool of threads
    # only slows when the test workers share the cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bt.init_distributed("gloo")
    yield bt.make_mesh(block=1, device="cpu")
    torch.set_num_threads(threads)


# (instance kind, solve options): a world of one solves as the unsharded solve
WORLD1 = [
    ("ell", dict(method="pgd")),
    ("dense", dict(method="apgd")),
    ("uniform", dict(method="lbfgs")),
    ("banded", dict(method="pgd", line_search="bbm")),
    ("uniform", dict(method="pgd", line_search="pava")),
    ("ell", dict(method="afw", shard_rows=True)),
]


@pytest.mark.parametrize("kind,kw", WORLD1, ids=[f"{k}-{'-'.join(map(str, v.values()))}"
                                                for k, v in WORLD1])
def test_world_of_one_equals_the_unsharded_solve(world_of_one, kind, kw):
    """float64: the same steps, sums taken in another order at most."""
    prob = instances(tsyn, kind)
    kw = dict(kw)
    rows = kw.pop("shard_rows", False)
    dp = bt.prepare(prob, device="cpu", dtype=torch.float64)
    power = TB.power_lipschitz_z if kw.get("line_search") == "pava" else TB.power_lipschitz
    common = dict(tol=0.0, max_iter=60, chunk=20, lipschitz=power(dp), dtype=torch.float64, **kw)
    want = bt.solve(prob, device="cpu", **common)
    got = bt.solve(prob, mesh=world_of_one, shard_rows=rows, **common)
    assert got.x.shape == want.x.shape and got.iterations == 60
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-9)
    # a mesh keeps the traces' scenario axis for one right-hand side, as the
    # reference's solve_sharded does
    assert got.trace_f.shape == (np.atleast_2d(want.trace_f)).shape
    np.testing.assert_allclose(got.trace_f.reshape(want.trace_f.shape), want.trace_f,
                               rtol=1e-9)
    np.testing.assert_allclose(got.x, want.x, atol=1e-8)


@pytest.mark.parametrize("rows", [False, True], ids=["col", "rows"])
def test_a_mesh_result_carries_the_phases_and_counts_of_one_device(world_of_one, rows):
    """One solve body: a mesh result has the single-device ``phases`` and
    the layout's ``gather_counts``."""
    prob = instances(tsyn, "ell")
    kw = dict(tol=0.0, max_iter=40, chunk=20, layout="gather")
    want = bt.solve(prob, device="cpu", **kw)
    got = bt.solve(prob, mesh=world_of_one, shard_rows=rows, **kw)
    assert list(got.phases) == list(want.phases) == ["power", "init", "chunks", "result"]
    dp = TS.placement(prob, world_of_one, layout="gather", shard_rows=rows).dp
    assert TL.gather_counts(dp.A).keys() == {"gather_slots", "gather_nnz"}
    assert got.counts == {"chunks": 2, "captures": 0, "fused_steps": 0, **TL.gather_counts(dp.A)}


@pytest.mark.parametrize("entry", ["solve", "solve_sharded", "Endpoint.solve"])
def test_refine_tol_alone_polishes_with_the_default_round_cap(world_of_one, monkeypatch,
                                                              entry):
    prob = instances(tsyn, "dense")
    seen = []

    def polish(problem, dp, res, rounds=3, cg_iters=30, target_rel_gap=None):
        seen.append((rounds, target_rel_gap))
        return res

    monkeypatch.setattr(TB, "refine_polish", polish)
    kw = dict(tol=0.0, max_iter=20, refine_tol=1e-7)
    if entry == "solve":
        bt.solve(prob, device="cpu", chunk=10, **kw)
    elif entry == "solve_sharded":
        TS.solve_sharded(prob, world_of_one, chunk=10, **kw)
    else:
        bt.Endpoint(prob, method="pgd", chunk=10, device="cpu").solve(prob.b, **kw)
    assert seen == [(TB.DEFAULT_REFINE_ROUNDS, 1e-7)]

