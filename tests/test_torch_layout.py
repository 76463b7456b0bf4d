"""Gather layout of the PyTorch port against the JAX package and against a
scipy float64 product: matrix products in every encoding, the flat/padded
conversions, user-order extraction and injection, the feasible start."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu.ops.layout as JL
import bsls_tpu_torch.ops.layout as TL
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu_torch.convert import device_problem_from_numpy
from bsls_tpu_torch.models import synthetic as tsyn
from torch_port_helpers import flatten_device_problem, small_instance

# fp32 sums taken in another order than XLA's or scipy's
RTOL = 1e-5


def _pair(kind, scenarios=1):
    """(host problem, JAX DeviceProblem, port DeviceProblem on the CPU)."""
    prob = small_instance(tsyn, kind, scenarios)
    dj = JL.prepare(small_instance(jsyn, kind, scenarios), layout="gather")
    dt = TL.prepare(prob, layout="gather", device="cpu")
    return prob, dj, dt


def _close(got, want, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    atol = RTOL * (np.abs(want).max() if scale is None else scale)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)


def _scaled_scipy(prob, dt):
    """float64 CSR of the equilibrated, PF-permuted, row-permuted operator."""
    import scipy.sparse as sp

    A = sp.csr_matrix(prob.A.to_scipy()).astype(np.float64)
    c = TL.block_scales(prob)
    A = A @ sp.diags(1.0 / np.repeat(c, prob.partition.sizes))
    perm = dt.perm.numpy()
    sel = perm >= 0
    Apf = sp.lil_matrix((A.shape[0], perm.size))
    Apf[:, np.nonzero(sel)[0]] = A[:, perm[sel]]
    Apf = sp.csr_matrix(Apf)
    return Apf if dt.row_perm is None else Apf[dt.row_perm.numpy()]


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("scenarios", [1, 3])
def test_matvec_rmatvec_match_reference_and_scipy(kind, scenarios):
    prob, dj, dt = _pair(kind, scenarios)
    rng = np.random.default_rng(7)
    lead = () if scenarios == 1 else (scenarios,)
    x = rng.standard_normal(lead + (dt.n_pf,)).astype(np.float32)
    r = rng.standard_normal(lead + (dt.num_rows,)).astype(np.float32)
    mv_j = (lambda v: JL.matvec(dj.A, v)) if scenarios == 1 else jax.vmap(lambda v: JL.matvec(dj.A, v))
    rmv_j = (lambda v: JL.rmatvec(dj.A, v)) if scenarios == 1 else jax.vmap(lambda v: JL.rmatvec(dj.A, v))
    y = TL.matvec(dt.A, torch.from_numpy(x)).numpy()
    g = TL.rmatvec(dt.A, torch.from_numpy(r)).numpy()
    assert y.shape == lead + (dt.num_rows,) and g.shape == lead + (dt.n_pf,)
    _close(y, mv_j(jnp.asarray(x)))
    _close(g, rmv_j(jnp.asarray(r)))
    A64 = _scaled_scipy(prob, dt)
    _close(y, (A64 @ x.astype(np.float64).T).T)
    _close(g, (A64.T @ r.astype(np.float64).T).T)


@pytest.mark.parametrize("encoding", ["bucketed", "plain_ell", "no_row_copy", "no_rt"])
@pytest.mark.parametrize("scenarios", [1, 3])
def test_every_ell_encoding_gives_the_same_product(encoding, scenarios, monkeypatch):
    prob = small_instance(tsyn, "ell")
    perm = TL.build_pf_perm(prob.partition)
    if encoding == "no_row_copy":
        monkeypatch.setattr(TL, "ROW_ELL_MAX_K", 1)  # forces the index_add path
    A = TL.to_device_matrix(prob.A, perm, row_bucket=encoding in ("bucketed", "no_rt"),
                            device="cpu")
    if encoding == "no_rt":
        A = TL.DeviceEll(rows=A.rows, vals=A.vals, mv_cols=A.mv_cols, mv_vals=A.mv_vals,
                         num_rows=A.num_rows)
    assert isinstance(A.mv_cols, tuple) == (encoding in ("bucketed", "no_rt"))
    assert (A.mv_cols is None) == (encoding == "no_row_copy")
    assert (A.rt_rows is not None) == (encoding == "bucketed")
    rng = np.random.default_rng(8)
    lead = () if scenarios == 1 else (scenarios,)
    x = rng.standard_normal(lead + (perm.size,))
    r = rng.standard_normal(lead + (prob.A.num_rows,))
    # the bucketed encodings live in the nnz-sorted row order
    out = {}
    TL.to_device_matrix(prob.A, perm, row_bucket=True, device="cpu", _out=out)
    rp = out["row_perm"] if isinstance(A.mv_cols, tuple) else np.arange(prob.A.num_rows)
    sel = perm >= 0
    M = np.zeros((prob.A.num_rows, perm.size))
    M[:, sel] = prob.A.to_scipy().toarray()[:, perm[sel]]
    M = M[rp]
    _close(TL.matvec(A, torch.from_numpy(x.astype(np.float32))).numpy(), x @ M.T)
    _close(TL.rmatvec(A, torch.from_numpy(r.astype(np.float32))).numpy(), r @ M)


def test_gather_dot_segments_bound_the_temporary(monkeypatch):
    rng = np.random.default_rng(9)
    vals = torch.from_numpy(rng.standard_normal((37, 5)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 50, size=(37, 5)).astype(np.int32))
    vec = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    want = (vals[None] * vec[:, idx.long()]).sum(-1)
    whole = TL.gather_dot(vals, idx, vec)
    monkeypatch.setattr(TL, "_GATHER_CHUNK_ELEMS", 4 * 5 * 3)  # 4 rows a segment
    parts = TL.gather_dot(vals, idx, vec)
    np.testing.assert_allclose(whole.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(parts.numpy(), whole.numpy())
    np.testing.assert_array_equal(TL.gather_dot(vals, idx, vec[1]).numpy(), whole[1].numpy())


@pytest.mark.parametrize("kind", ["dense", "ell"])
@pytest.mark.parametrize("scenarios", [1, 3])
def test_conversions_match_reference(kind, scenarios):
    prob, dj, dt = _pair(kind, scenarios)
    rng = np.random.default_rng(10)
    lead = () if scenarios == 1 else (scenarios,)
    x_pf = rng.standard_normal(lead + (dt.n_pf,)).astype(np.float32)
    vm = (lambda f: f) if scenarios == 1 else jax.vmap

    xp_t = TL.flat_to_padded(dt, torch.from_numpy(x_pf))
    xp_j = vm(lambda v: JL.flat_to_padded(dj, v))(jnp.asarray(x_pf))
    for a, b in zip(xp_t, xp_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(TL.padded_to_flat(dt, xp_t).numpy(), x_pf)

    # extraction: masked slots only, equilibration undone; S > 1 included
    xm_t = tuple(x * bk.mask for x, bk in zip(xp_t, dt.buckets))
    xm_j = tuple(x * bk.mask for x, bk in zip(xp_j, dj.buckets))
    xu_t = TL.extract_user_flat(dt, xm_t).numpy()
    xu_j = np.asarray(vm(lambda p: JL.extract_user_flat(dj, p))(xm_j))
    assert xu_t.shape == lead + (prob.partition.n_flat,)
    np.testing.assert_allclose(xu_t, xu_j, rtol=1e-6, atol=1e-7)

    # injection is the inverse of extraction on the real slots
    back = TL.inject_user_flat(dt, torch.from_numpy(xu_t))
    back_j = vm(lambda v: JL.inject_user_flat(dj, v))(jnp.asarray(xu_j))
    for a, b, m in zip(back, back_j, xm_t):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(a.numpy(), m.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_feasible_init_matches_reference(kind):
    _, dj, dt = _pair(kind)
    for a, b, bk in zip(TL.feasible_init(dt), JL.feasible_init(dj), dt.buckets):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-7)
        np.testing.assert_allclose(a.sum(-1).numpy(), bk.radius.numpy(), rtol=1e-6)
    batched = TL.feasible_init(dt, scenarios=3)
    assert all(x.shape == (3,) + tuple(bk.mask.shape) for x, bk in zip(batched, dt.buckets))


def test_feasible_init_dummy_rows_are_zero():
    import bsls_tpu_torch as bt

    sizes = np.array([3, 2, 4, 4, 1])
    A = np.random.default_rng(0).standard_normal((20, int(sizes.sum())))
    dt = TL.prepare(bt.Problem.from_arrays(A, np.ones(20), sizes, block_multiple=4),
                    device="cpu")
    for x, bk in zip(TL.feasible_init(dt), dt.buckets):
        dummy = bk.sizes == 0
        assert dummy.any() or bk.sizes.numel() % 4 == 0
        assert float(x[dummy].abs().sum()) == 0.0
        assert torch.isfinite(x).all()


@pytest.mark.parametrize("kind", ["dense", "ell"])
def test_convert_carries_the_reference_layout_across(kind):
    """The port's products on the arrays that the reference's prepare built."""
    _, dj, dt = _pair(kind, 3)
    dc = device_problem_from_numpy(flatten_device_problem(dj), device="cpu")
    want = flatten_device_problem(dt)
    got = flatten_device_problem(dc)
    assert sorted(got) == sorted(want)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((3, dt.n_pf)).astype(np.float32))
    _close(TL.matvec(dc.A, x).numpy(), TL.matvec(dt.A, x).numpy())
    assert type(dc.A).__name__ == type(dt.A).__name__
