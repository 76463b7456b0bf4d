"""Block-simplex projection of the PyTorch port (the plain version, which the
CUDA kernel is held against on the card) against the JAX package's XLA
function, its Pallas kernel in interpret mode, and the numpy reference."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu_torch as bt
from bsls_tpu.ops.pallas.projection_kernel import proj_simplex_pallas_t
from bsls_tpu.ops.projection import proj_simplex_padded as proj_jax
from bsls_tpu.utils.refimpl import proj_simplex_np as proj_np_ref
from bsls_tpu_torch.ops import rowkernels
from bsls_tpu_torch.ops.projection import proj_blocks, proj_simplex_padded
from bsls_tpu_torch.utils.refimpl import proj_blocks_np, proj_simplex_np
from torch_port_helpers import KERNELS

# tolerance of tests/test_pallas.py: the Pallas kernel bisects in fp32
ATOL = 3e-5


def _case(w, B=37, seed=0, dummy=True):
    """Ragged widths, per-row radius, dummy rows, a batch that is no multiple
    of any tile."""
    rng = np.random.default_rng(seed + w)
    v = (rng.standard_normal((B, w)) * 3).astype(np.float32)
    widths = rng.integers(1, w + 1, size=B).astype(np.int32)
    if dummy:
        widths[-3:] = 0
    radius = rng.uniform(0.5, 5.0, size=B).astype(np.float32)
    radius[widths == 0] = 1.0
    mask = (np.arange(w)[None, :] < widths[:, None]).astype(np.float32)
    return v, widths, radius, mask


@pytest.mark.parametrize("w", [1, 3, 4, 8, 16])
def test_plain_projection_matches_xla_pallas_and_numpy(w):
    v, widths, radius, mask = _case(w)
    got = proj_simplex_padded(torch.from_numpy(v), torch.from_numpy(mask),
                              torch.from_numpy(radius)).numpy()
    xla = np.asarray(proj_jax(jnp.asarray(v), jnp.asarray(mask), jnp.asarray(radius)))
    np.testing.assert_allclose(got, xla, atol=ATOL)
    pallas = np.asarray(proj_simplex_pallas_t(
        jnp.asarray(v), jnp.asarray(widths), jnp.asarray(radius), tile=128, interpret=True))
    np.testing.assert_allclose(got, pallas, atol=ATOL * radius.max())
    for i in range(v.shape[0]):
        n = widths[i]
        want = radius[i] * proj_simplex_np(v[i, :n].astype(np.float64) / radius[i]) if n else []
        np.testing.assert_allclose(got[i, :n], want, atol=ATOL)
        np.testing.assert_array_equal(got[i, n:], 0.0)  # padding and dummy rows
    real = widths > 0
    np.testing.assert_allclose(got[real].sum(-1), radius[real], rtol=1e-5)


@pytest.mark.parametrize("scenarios", [1, 3])
def test_plain_projection_with_scenario_axis(scenarios):
    v, widths, radius, mask = _case(8, seed=5)
    vs = np.stack([v * (s + 1) for s in range(scenarios)])
    got = proj_simplex_padded(torch.from_numpy(vs), torch.from_numpy(mask),
                              torch.from_numpy(radius)).numpy()
    for s in range(scenarios):
        one = proj_simplex_padded(torch.from_numpy(vs[s]), torch.from_numpy(mask),
                                  torch.from_numpy(radius)).numpy()
        np.testing.assert_array_equal(got[s], one)


def test_refimpl_copy_matches_reference_refimpl():
    rng = np.random.default_rng(3)
    sizes = rng.integers(1, 9, size=20)
    v = rng.standard_normal(int(sizes.sum())) * 2
    np.testing.assert_array_equal(proj_simplex_np(v[:7]), proj_np_ref(v[:7]))
    out = proj_blocks_np(v, sizes)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    np.testing.assert_allclose(np.add.reduceat(out, offs[:-1]), 1.0, rtol=1e-12)


def test_proj_blocks_on_cpu_takes_plain_version_and_launches_nothing():
    prob = bt.synthetic.medium_sparse(seed=1, num_blocks=40, m=200)
    dp = bt.prepare(prob, layout="gather", device="cpu")
    bt.reset_launch_counts()
    rng = np.random.default_rng(4)
    xp = tuple(torch.from_numpy(rng.standard_normal((3,) + tuple(bk.mask.shape)).astype(np.float32))
               for bk in dp.buckets)
    out = proj_blocks(xp, dp.buckets)
    for o, bk in zip(out, dp.buckets):
        np.testing.assert_allclose(o.sum(-1).numpy(), bk.radius.expand(3, -1).numpy(), rtol=1e-5)
        assert float((o * (1 - bk.mask)).abs().sum()) == 0.0
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """A wrapper never falls back: a tensor it cannot launch on raises."""
    v, widths, radius, _ = _case(4)
    with pytest.raises(ValueError, match="CUDA"):
        rowkernels.proj_simplex_rows(torch.from_numpy(v), torch.from_numpy(widths),
                                     torch.from_numpy(radius))
    with pytest.raises(ValueError, match="CUDA"):
        rowkernels.pava_rows(torch.from_numpy(v), torch.from_numpy(widths),
                             torch.from_numpy(radius))
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)
