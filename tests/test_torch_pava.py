"""Bounded isotonic regression and the x<->z change of variable of the
PyTorch port against the JAX package (XLA function, Pallas kernel in
interpret mode) and the numpy reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu.ops.isotonic as JI
import bsls_tpu.ops.ztransform as JZ
import bsls_tpu_torch.ops.isotonic as TI
import bsls_tpu_torch.ops.ztransform as TZ
from bsls_tpu.ops.pallas.pava_kernel import pava_pallas_t
from bsls_tpu_torch.utils.refimpl import (
    pava_blocks_np, pava_np, x_to_z_np, z_to_x_np,
)

# tolerance of tests/test_pallas.py: prefix-sum differences in fp32
ATOL = 3e-5


def _case(w, B=29, seed=0):
    rng = np.random.default_rng(seed + w)
    y = (rng.standard_normal((B, w)) * 2).astype(np.float32)
    widths = rng.integers(0, w + 1, size=B).astype(np.int32)
    widths[:2] = 0  # blocks of size 1 have no z slot
    radius = rng.uniform(0.5, 3.0, size=B).astype(np.float32)
    mask = (np.arange(w)[None, :] < widths[:, None]).astype(np.float32)
    return y, widths, radius, mask


@pytest.mark.parametrize("w", [1, 3, 4, 8, 16])
def test_plain_pava_matches_xla_pallas_and_numpy(w):
    y, widths, radius, mask = _case(w)
    got = TI.pava_bounded(torch.from_numpy(y), torch.from_numpy(widths),
                          torch.from_numpy(radius)).numpy()
    padded = TI.pava_padded(torch.from_numpy(y), torch.from_numpy(mask), 0.0,
                            torch.from_numpy(radius)).numpy()
    np.testing.assert_array_equal(got, padded)
    xla = np.asarray(JI.pava_padded(jnp.asarray(y), jnp.asarray(mask), 0.0, jnp.asarray(radius)))
    np.testing.assert_allclose(got, xla, atol=ATOL)
    pallas = np.asarray(pava_pallas_t(
        jnp.asarray(y), jnp.asarray(widths), jnp.asarray(radius), tile=128, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL)
    for i in range(y.shape[0]):
        n = widths[i]
        want = pava_np(y[i, :n].astype(np.float64), lo=0.0, hi=float(radius[i])) if n else []
        np.testing.assert_allclose(got[i, :n], want, atol=ATOL)
        np.testing.assert_array_equal(got[i, n:], 0.0)
        assert np.all(np.diff(got[i, :n]) >= -1e-6)


@pytest.mark.parametrize("scenarios", [1, 3])
def test_plain_pava_scenario_axis_and_chunking(scenarios):
    y, widths, radius, mask = _case(8, B=50, seed=7)
    ys = np.stack([y + s for s in range(scenarios)])
    whole = TI.pava_padded(torch.from_numpy(ys), torch.from_numpy(mask), 0.0,
                           torch.from_numpy(radius))
    parts = TI.pava_padded(torch.from_numpy(ys), torch.from_numpy(mask), 0.0,
                           torch.from_numpy(radius), chunk=16)
    np.testing.assert_array_equal(whole.numpy(), parts.numpy())
    for s in range(scenarios):
        one = TI.pava_padded(torch.from_numpy(ys[s]), torch.from_numpy(mask), 0.0,
                             torch.from_numpy(radius))
        np.testing.assert_array_equal(whole[s].numpy(), one.numpy())


def test_pava_decreasing_and_unbounded_match_xla():
    y, widths, radius, mask = _case(6, seed=9)
    got = TI.pava_padded(torch.from_numpy(y), torch.from_numpy(mask), None, None,
                         increasing=False).numpy()
    want = np.asarray(JI.pava_padded(jnp.asarray(y), jnp.asarray(mask), None, None,
                                     increasing=False))
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_pava_blocks_numpy_reference():
    rng = np.random.default_rng(2)
    sizes = rng.integers(1, 7, size=15)
    y = rng.standard_normal(int(sizes.sum()))
    out = pava_blocks_np(y, sizes)
    assert out.min() >= 0.0 and out.max() <= 1.0


ZFUNCS = ["zmask", "x_to_z_padded", "z_to_x_padded", "dz_adjoint_padded", "dz_forward_padded"]


@pytest.mark.parametrize("name", ZFUNCS)
@pytest.mark.parametrize("scenarios", [1, 3])
def test_ztransform_matches_reference(name, scenarios):
    rng = np.random.default_rng(5)
    B, w = 21, 8
    sizes = rng.integers(1, w + 1, size=B)
    sizes[-2:] = 0  # dummy rows
    mask = (np.arange(w)[None, :] < sizes[:, None]).astype(np.float32)
    radius = rng.uniform(0.5, 2.0, size=B).astype(np.float32)
    a = rng.standard_normal((scenarios, B, w)).astype(np.float32)
    if scenarios == 1:
        a = a[0]
    args_t = (torch.from_numpy(a), torch.from_numpy(mask))
    args_j = (jnp.asarray(a), jnp.asarray(mask))
    if name == "zmask":
        args_t, args_j = args_t[1:], args_j[1:]
    elif name == "z_to_x_padded":
        args_t += (torch.from_numpy(radius),)
        args_j += (jnp.asarray(radius),)
    got = getattr(TZ, name)(*args_t).numpy()
    want = np.asarray(getattr(JZ, name)(*args_j))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_ztransform_roundtrip_and_adjoint():
    rng = np.random.default_rng(6)
    sizes = rng.integers(1, 9, size=12)
    x = np.concatenate([rng.dirichlet(np.ones(n)) for n in sizes])
    np.testing.assert_allclose(z_to_x_np(x_to_z_np(x, sizes), sizes), x, atol=1e-12)
    mask = torch.from_numpy((np.arange(8)[None, :] < sizes[:, None]).astype(np.float32))
    dz = torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((12, 8)).astype(np.float32))
    lhs = (TZ.dz_forward_padded(dz, mask) * g * mask).sum()
    rhs = (dz * TZ.zmask(mask) * TZ.dz_adjoint_padded(g * mask, mask)).sum()
    assert float(lhs) == pytest.approx(float(rhs), rel=1e-5, abs=1e-5)
