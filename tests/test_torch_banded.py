"""Banded layout of the PyTorch port against the JAX package: the host split,
``prepare``, the two page contractions (plain versions against the Pallas
kernels in interpret mode and against the einsum), the products on a banded
operator, the ``auto`` policy, RCM reordering, and the slice as a whole:
``solve`` on a banded instance against ``bsls_tpu.solve``."""
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu
import bsls_tpu.ops.banded as JB
import bsls_tpu.ops.layout as JL
import bsls_tpu.ops.quadratic as JQ
import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.banded as TB
import bsls_tpu_torch.ops.layout as TL
import bsls_tpu_torch.ops.quadratic as TQ
from bsls_tpu.models import reorder as jreorder
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu.ops.pallas.banded_kernels import band_grmv_pallas, band_zmv_pallas
from bsls_tpu_torch.convert import device_problem_from_numpy
from bsls_tpu_torch.models import reorder as treorder
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.ops import pagekernels
from bsls_tpu_torch.solvers.base import power_lipschitz
from torch_port_helpers import KERNELS, flatten_device_problem, small_instance


def _pair(scenarios=1, **kw):
    """(host problem, reference DeviceProblem, port DeviceProblem on the CPU),
    both under ``layout="auto"`` on the small corridor instance."""
    prob = small_instance(tsyn, "banded", scenarios)
    dj = JL.prepare(small_instance(jsyn, "banded", scenarios), **kw)
    dt = TL.prepare(prob, device="cpu", **kw)
    assert isinstance(dj.A, JB.DeviceBanded) and isinstance(dt.A, TB.DeviceBanded)
    return prob, dj, dt


def _assert_same_fields(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if w is None or isinstance(w, (int, tuple)):
            assert g == w, key
        elif w.dtype.kind in "iu" or key.startswith("A.bands") or ".vals" in key:
            np.testing.assert_array_equal(g, w, err_msg=key)  # exact
        else:
            # radius, b: both stage through the same float32 numpy buffers
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=key)


# ------------------------------------------------------------- host split


def _corridor_columns(seed, Mp=5, seg_c=(3, 4), k=4, spread=150):
    """PF column-ELL data with the ladder shape build_banded_split expects:
    segment i has Mp groups of seg_c[i] columns whose rows lie near page g."""
    rng = np.random.default_rng(seed)
    m = Mp * 128 - 37
    seg_lens = [Mp * c for c in seg_c]
    rows, vals = [], []
    for L, c in zip(seg_lens, seg_c):
        g = np.arange(L) // c
        r = g[:, None] * 128 + rng.integers(-spread, spread + 129, size=(L, k))
        rows.append(np.clip(r, 0, m - 1).astype(np.int32))
        v = rng.uniform(0.5, 2.0, size=(L, k)).astype(np.float32)
        v[rng.random((L, k)) < 0.25] = 0.0  # padding entries and empty columns
        vals.append(v)
    return np.concatenate(rows), np.concatenate(vals), m, seg_lens


@pytest.mark.parametrize("seed,spread", [(0, 60), (1, 150), (2, 500), (3, 2000)])
def test_build_banded_split_matches_reference(seed, spread):
    rows, vals, m, seg_lens = _corridor_columns(seed, spread=spread)
    want = JB.build_banded_split(rows, vals, m, seg_lens)
    got = TB.build_banded_split(rows, vals, m, seg_lens)
    assert got[1:4] == want[1:4]  # back, wpages, fit fraction
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[4][0], want[4][0])
    np.testing.assert_array_equal(got[4][1], want[4][1])
    np.testing.assert_array_equal(TB.block_window_key(rows, vals), JB.block_window_key(rows, vals))
    # the split loses nothing: band + residual is the operator
    back, wpages = got[1], got[2]
    dense = np.zeros((m + 8 * 128, rows.shape[0]))
    np.add.at(dense, (rows, np.arange(rows.shape[0])[:, None]), vals)
    rebuilt = np.zeros_like(dense)
    np.add.at(rebuilt, (got[4][0], np.arange(rows.shape[0])[:, None]), got[4][1])
    off = 0
    for band, L in zip(got[0], seg_lens):
        Mp, C, W = band.shape
        assert W == wpages * 128 and L == Mp * C
        for g in range(Mp):
            lo = (g - back) * 128
            for c in range(C):
                w = np.nonzero(band[g, c])[0]
                rebuilt[lo + w, off + g * C + c] += band[g, c, w]
        off += L
    np.testing.assert_allclose(rebuilt, dense, rtol=1e-6)


@pytest.mark.parametrize("scenarios", [1, 3])
@pytest.mark.parametrize("equilibrate", [True, False])
def test_prepare_banded_matches_reference(scenarios, equilibrate):
    _, dj, dt = _pair(scenarios, equilibrate=equilibrate)
    _assert_same_fields(flatten_device_problem(dt), flatten_device_problem(dj))
    assert dt.row_perm is None and dt.b.shape == np.asarray(dj.b).shape
    assert dt.A.seg_lens == tuple(b.shape[0] * b.shape[1] for b in dt.A.bands)
    assert dt.A.pages == dt.A.bands[0].shape[0] == -(-dt.num_rows // TB.PAGE)


def test_prepare_banded_with_a_residual_matches_reference():
    """A wide spread leaves columns outside every window: the residual ELL
    (row copy, col-nnz buckets) must be the reference's too."""
    kw = dict(seed=4, num_blocks=300, m=6000, spread=500)
    dj = JL.prepare(jsyn.medium_banded(**kw), layout="banded")
    dt = TL.prepare(tsyn.medium_banded(**kw), layout="banded", device="cpu")
    assert dt.A.resid is not None and int((dt.A.resid.vals != 0).sum()) > 0
    _assert_same_fields(flatten_device_problem(dt), flatten_device_problem(dj))


def test_band_cap_environment_variable_is_read(monkeypatch):
    monkeypatch.setenv("BSLS_BAND_CAP", "0.9")
    dj = JL.prepare(small_instance(jsyn, "banded"), layout="banded")
    dt = TL.prepare(small_instance(tsyn, "banded"), layout="banded", device="cpu")
    _assert_same_fields(flatten_device_problem(dt), flatten_device_problem(dj))
    monkeypatch.setenv("BSLS_BAND_CAP", "none")
    uncapped = TL.prepare(small_instance(tsyn, "banded"), layout="banded", device="cpu")
    # the cap lowers the padded page load (at the price of a wider window)
    assert sum(b.shape[1] for b in dt.A.bands) < sum(b.shape[1] for b in uncapped.A.bands)


# --------------------------------------------------------- page contractions


@pytest.mark.parametrize("S", [1, 3])
@pytest.mark.parametrize("shape", [(6, 10, 32), (5, 1, 128), (3, 7, 384)])
def test_plain_page_contractions_match_pallas_and_einsum(S, shape):
    rng = np.random.default_rng(7)
    Mp, C, W = shape
    band = rng.standard_normal((Mp, C, W)).astype(np.float32)
    xg = rng.standard_normal((S, Mp, C)).astype(np.float32)
    rw = rng.standard_normal((S, Mp, W)).astype(np.float32)
    tb = torch.from_numpy(band)
    z = pagekernels.band_zmv(tb, torch.from_numpy(xg)).numpy()
    g = pagekernels.band_grmv(tb, torch.from_numpy(rw)).numpy()
    # unit-scale data, sums of C or W products in another order: atol 2e-5
    np.testing.assert_allclose(z, np.einsum("gcw,sgc->sgw", band, xg), atol=2e-5)
    np.testing.assert_allclose(g, np.einsum("gcw,sgw->sgc", band, rw), atol=2e-5 * np.sqrt(W / 32))
    zj = band_zmv_pallas(jnp.asarray(band), jnp.asarray(xg), interpret=True)
    gj = band_grmv_pallas(jnp.asarray(band), jnp.asarray(rw), interpret=True)
    np.testing.assert_allclose(z, np.asarray(zj), atol=2e-5)
    np.testing.assert_allclose(g, np.asarray(gj), atol=2e-5 * np.sqrt(W / 32))
    np.testing.assert_array_equal(z, pagekernels.band_zmv_plain(tb, torch.from_numpy(xg)).numpy())


def test_page_wrappers_take_views_check_shapes_and_launch_nothing_on_the_cpu():
    rng = np.random.default_rng(8)
    band = torch.from_numpy(rng.standard_normal((4, 3, 256)).astype(np.float32))
    # the segment of a PF-flat vector and the sliding windows of a padded r
    x_pf = torch.from_numpy(rng.standard_normal((2, 30)).astype(np.float32))
    seg = x_pf[:, 5:17].reshape(2, 4, 3)
    assert not seg.is_contiguous()
    rp = torch.from_numpy(rng.standard_normal((2, 6 * 128)).astype(np.float32))
    Rw = rp.as_strided((2, 4, 256), (rp.stride(0), 128, 1))
    bt.reset_launch_counts()
    z = pagekernels.band_zmv(band, seg)
    g = pagekernels.band_grmv(band, Rw)
    np.testing.assert_allclose(z.numpy(), np.einsum("gcw,sgc->sgw", band.numpy(), seg.numpy()),
                               atol=2e-5)
    # the window view is the reference's concatenation of shifted page slices
    pages = rp.view(2, 6, 128)
    cat = torch.cat([pages[:, j:j + 4] for j in range(2)], dim=2)
    np.testing.assert_array_equal(Rw.numpy(), cat.numpy())
    np.testing.assert_allclose(g.numpy(), np.einsum("gcw,sgw->sgc", band.numpy(), cat.numpy()),
                               atol=1e-4)
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)
    with pytest.raises(ValueError, match="does not match"):
        pagekernels.band_zmv(band, Rw)
    with pytest.raises(ValueError, match="does not match"):
        pagekernels.band_grmv(band, seg)
    with pytest.raises(TypeError):
        pagekernels.band_zmv(band, seg.double())


# ------------------------------------------------------ products on the band


@pytest.mark.parametrize("scenarios", [1, 3])
def test_banded_products_match_reference_and_host(scenarios):
    prob, dj, dt = _pair(scenarios)
    rng = np.random.default_rng(9)
    lead = () if scenarios == 1 else (scenarios,)
    vm = (lambda f: f) if scenarios == 1 else jax.vmap
    # A @ x from a user-space x, as tests/test_banded.py does
    x = rng.random(lead + (prob.partition.n_flat,))
    xt = torch.from_numpy(x.astype(np.float32))
    xf = TL.padded_to_flat(dt, TL.inject_user_flat(dt, xt))
    xfj = vm(lambda v: JL.padded_to_flat(dj, JL.inject_user_flat(dj, v)))(jnp.asarray(x, jnp.float32))
    np.testing.assert_allclose(xf.numpy(), np.asarray(xfj), rtol=1e-6, atol=1e-7)
    y = TL.matvec(dt.A, xf).numpy()
    y_ref = np.asarray(vm(lambda v: JL.matvec(dj.A, v))(xfj))
    y_host = np.stack([prob.A.matvec(v) for v in x.reshape(-1, x.shape[-1])]).reshape(y.shape)
    scale = max(1.0, np.abs(y_host).max())
    assert y.shape == lead + (dt.num_rows,)
    np.testing.assert_allclose(y / scale, y_ref / scale, atol=1e-5)
    np.testing.assert_allclose(y / scale, y_host / scale, atol=1e-5)

    # A^T r, mapped back to the user's columns
    r = rng.standard_normal(lead + (dt.num_rows,)).astype(np.float32)
    g = TL.rmatvec(dt.A, torch.from_numpy(r)).numpy()
    g_ref = np.asarray(vm(lambda v: JL.rmatvec(dj.A, v))(jnp.asarray(r)))
    assert g.shape == lead + (dt.n_pf,)
    perm = dt.perm.numpy()
    sel = perm >= 0
    rad = np.concatenate([
        np.repeat(bk.radius.numpy()[:, None], bk.mask.shape[1], 1).reshape(-1)
        for bk in dt.buckets])
    g_user = np.zeros(lead + (prob.partition.n_flat,))
    g_user[..., perm[sel]] = g[..., sel] * rad[sel]
    g_host = np.stack([prob.A.rmatvec(v.astype(np.float64))
                       for v in r.reshape(-1, r.shape[-1])]).reshape(g_user.shape)
    scale = max(1.0, np.abs(g_host).max())
    np.testing.assert_allclose(g / scale, g_ref / scale, atol=1e-5)
    np.testing.assert_allclose(g_user / scale, g_host / scale, atol=1e-5)


def test_banded_products_with_residual_and_extraction_roundtrip():
    kw = dict(seed=4, num_blocks=300, m=6000, spread=500)
    prob = tsyn.with_scenarios(tsyn.medium_banded(**kw), 2, seed=5)
    dt = TL.prepare(prob, layout="banded", device="cpu")
    dg = TL.prepare(prob, layout="gather", device="cpu")
    assert dt.A.resid is not None
    rng = np.random.default_rng(10)
    xu = torch.from_numpy(rng.random((2, prob.partition.n_flat)).astype(np.float32))
    xb = TL.inject_user_flat(dt, xu)
    # extraction goes through perm alone, on the regrouped partition
    np.testing.assert_allclose(TL.extract_user_flat(dt, xb).numpy(), xu.numpy(), rtol=1e-5,
                               atol=1e-7)
    yb = TL.matvec(dt.A, TL.padded_to_flat(dt, xb)).numpy()
    yg = TL.matvec(dg.A, TL.padded_to_flat(dg, TL.inject_user_flat(dg, xu))).numpy()
    inv = np.argsort(dg.row_perm.numpy())  # the gather layout sorts rows by nnz
    scale = np.abs(yb).max()
    np.testing.assert_allclose(yb / scale, yg[:, inv] / scale, atol=1e-5)
    # both Lipschitz estimates see the same operator
    assert power_lipschitz(dt) == pytest.approx(power_lipschitz(dg), rel=0.05)


@pytest.mark.parametrize("kind", ["banded", "dense", "ell"])
def test_diag_quad_matches_reference(kind):
    kw = {} if kind == "banded" else dict(layout="gather")
    dj = JL.prepare(small_instance(jsyn, kind), **kw)
    dt = TL.prepare(small_instance(tsyn, kind), device="cpu", **kw)
    for a, b in zip(TQ.diag_quad(dt), JQ.diag_quad(dj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("scenarios", [1, 3])
def test_convert_carries_the_reference_band_across(scenarios):
    _, dj, dt = _pair(scenarios)
    dc = device_problem_from_numpy(flatten_device_problem(dj), device="cpu")
    _assert_same_fields(flatten_device_problem(dc), flatten_device_problem(dt))
    assert isinstance(dc.A, TB.DeviceBanded) and dc.A.pages == dt.A.pages
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((2, dt.n_pf)).astype(np.float32))
    np.testing.assert_array_equal(TL.matvec(dc.A, x).numpy(), TL.matvec(dt.A, x).numpy())


# ----------------------------------------------------------------- policy

POLICY = {
    "banded_at_4": (lambda s: s.with_scenarios(small_instance(s, "banded"), 4, seed=7), "auto", True),
    "gather_at_16": (lambda s: s.with_scenarios(small_instance(s, "banded"), 16, seed=7), "auto", False),
    "forced_at_16": (lambda s: s.with_scenarios(small_instance(s, "banded"), 16, seed=7), "banded", True),
    "gather_when_asked": (lambda s: small_instance(s, "banded"), "gather", False),
    "uniform_random_rejected": (lambda s: s.medium_sparse(seed=3, num_blocks=200, m=4000), "auto", False),
}


@pytest.mark.parametrize("name", sorted(POLICY))
def test_layout_policy_matches_reference(name):
    make, layout, banded = POLICY[name]
    dt = TL.prepare(make(tsyn), layout=layout, device="cpu")
    dj = JL.prepare(make(jsyn), layout=layout)
    assert isinstance(dt.A, TB.DeviceBanded) == banded
    assert isinstance(dj.A, JB.DeviceBanded) == banded
    assert (dt.row_perm is None) == banded  # only the gather layout sorts the rows


def test_banded_layout_on_a_dense_matrix_raises():
    with pytest.raises(ValueError, match="banded"):
        TL.prepare(small_instance(tsyn, "dense"), layout="banded", device="cpu")
    with pytest.raises(ValueError, match="banded"):
        JL.prepare(small_instance(jsyn, "dense"), layout="banded")
    # under "auto" a dense A simply keeps its own layout
    assert isinstance(TL.prepare(small_instance(tsyn, "dense"), device="cpu").A, TL.DeviceDense)


def test_rcm_reordering_matches_reference_and_recovers_bandability():
    kw = dict(num_blocks=300, m=3000, spread=100, seed=6)

    def shuffled(syn, ell_cls):
        prob = syn.medium_banded(**kw)
        perm = np.random.default_rng(1).permutation(prob.A.shape[0])
        rank = np.empty(perm.size, np.int64)
        rank[perm] = np.arange(perm.size)
        A = ell_cls(rows=rank[np.asarray(prob.A.rows)].astype(np.int32),
                    vals=np.asarray(prob.A.vals), num_rows=prob.A.num_rows)
        return replace(prob, A=A, b=np.asarray(prob.b)[perm])

    pt, pj = shuffled(tsyn, bt.EllMatrix), shuffled(jsyn, bsls_tpu.EllMatrix)
    assert treorder.estimate_bandability(pt.A) == jreorder.estimate_bandability(pj.A) < 0.2
    assert not isinstance(TL.prepare(pt, device="cpu").A, TB.DeviceBanded)
    np.testing.assert_array_equal(treorder.rcm_row_permutation(pt.A),
                                  jreorder.rcm_row_permutation(pj.A))
    qt, qj = treorder.reorder_rows_rcm(pt), jreorder.reorder_rows_rcm(pj)
    np.testing.assert_array_equal(qt.A.rows, qj.A.rows)
    np.testing.assert_array_equal(qt.b, qj.b)
    assert qt.name == qj.name and qt.name.endswith("+rcm")
    assert treorder.estimate_bandability(qt.A) == jreorder.estimate_bandability(qj.A) > 0.9
    assert isinstance(TL.prepare(qt, device="cpu").A, TB.DeviceBanded)
    dense = treorder.reorder_rows_rcm(small_instance(tsyn, "dense"))
    assert dense.A.data.shape == (64, 60)
    with pytest.raises(TypeError):
        treorder.estimate_bandability(dense.A)


# ------------------------------------------------------- the slice as a whole


@pytest.mark.parametrize("scenarios", [1, 3])
def test_banded_solve_matches_reference_solve(scenarios):
    pt, dj, dt = _pair(scenarios)
    L_est = power_lipschitz(dt)
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=200, chunk=100,
              lipschitz=L_est)
    bt.reset_launch_counts()
    res = bt.solve(pt, device="cpu", **kw)  # a host Problem: "auto" picks the band
    ref = bsls_tpu.solve(dj, **kw)
    lead = () if scenarios == 1 else (scenarios,)
    assert res.trace_f.shape == lead + (200,) and res.x.shape == lead + (pt.partition.n_flat,)
    # the tolerances tests/test_torch_solve.py holds the gather layout to:
    # fp32 on both sides with sums in another order, 200 steps deep
    np.testing.assert_allclose(res.trace_f, ref.trace_f, rtol=1e-3)
    np.testing.assert_allclose(res.x, ref.x, atol=1e-4)
    np.testing.assert_allclose(res.objective, ref.objective, rtol=1e-3)
    offs = np.concatenate([[0], np.cumsum(pt.partition.sizes)[:-1]])
    assert res.x.min() >= 0.0
    np.testing.assert_allclose(np.add.reduceat(res.x, offs, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(pt.objective_np(res.x), res.objective, rtol=1e-3, atol=1e-6)
    assert np.all(np.diff(res.trace_f, axis=-1) <= 1e-5 * np.abs(res.trace_f[..., :-1]) + 1e-7)
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)


def test_forced_banded_and_gather_solves_agree():
    """Two encodings of one operator: a fixed-budget solve must agree closely
    (rtol 5e-4, as tests/test_banded.py asks of the reference)."""
    prob = small_instance(tsyn, "banded")
    rb = bt.solve(TL.prepare(prob, layout="banded", device="cpu"), tol=0.0, max_iter=300)
    rg = bt.solve(TL.prepare(prob, layout="gather", device="cpu"), tol=0.0, max_iter=300)
    np.testing.assert_allclose(float(rb.objective), float(rg.objective), rtol=5e-4, atol=1e-6)
    np.testing.assert_allclose(rb.x, rg.x, atol=1e-3)


def test_preset_and_cli_layout_flag():
    from bsls_tpu.utils.config import PRESETS as JPRESETS
    from bsls_tpu_torch.cli import build_parser, main
    from bsls_tpu_torch.utils.config import PRESETS, load_config

    want, got = JPRESETS["medium-banded"], PRESETS["medium-banded"]
    assert (got.config, got.method, got.line_search) == (want.config, want.method, want.line_search)
    assert load_config("medium-banded", layout="gather").layout == "gather"
    assert build_parser().parse_args([]).layout is None
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--layout", "paged"])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(repo, "configs", "medium-pgd.json")
    assert load_config(path).layout == "auto"
    small = dict(num_blocks=300, m=3000, spread=120)
    args = ["--device", "cpu", "--preset", "medium-banded", "--max-iter", "100"]
    for flag, layout in ([], "banded"), (["--layout", "gather"], "gather"):
        import bsls_tpu_torch.utils.config as C

        cfg = replace(C.PRESETS["medium-banded"], instance_kwargs=small, seed=2)
        old = C.PRESETS["medium-banded"]
        C.PRESETS["medium-banded"] = cfg
        try:
            out = main(args + flag)
        finally:
            C.PRESETS["medium-banded"] = old
        assert out["layout"] == layout and out["iterations"] == 100
        assert out["config"] == "medium_banded" and out["line_search"] == "bbm"
