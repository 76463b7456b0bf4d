"""Block-simplex projection of the PyTorch port (the plain version, which the
CUDA kernel is held against on the card) against the JAX package's XLA
function, its Pallas kernel in interpret mode, and the numpy reference; the
sort-free threshold of the CUDA kernel, written here in numpy, against the
same two; and what the grouped wrapper refuses and hands its launcher."""
import contextlib
import dataclasses
import types

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
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

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


def _sort_free(v, widths, radius):
    """The threshold of csrc/proj_simplex_rows.cu in float32, without a sort:
    tau = max_i (sum_{u_j >= u_i} u_j - r) / #{u_j >= u_i} over the valid
    slots, then one Newton correction on the support it selects."""
    B, w = v.shape
    valid = np.arange(w)[None, :] < widths[:, None]
    u = np.where(valid, v, np.float32(-3e38)).astype(np.float32)
    ge = (u[:, None, :] >= u[:, :, None]) & valid[:, None, :]  # (B, i, j): u_j >= u_i
    S = np.where(ge, u[:, None, :], np.float32(0)).sum(-1, dtype=np.float32)
    C = ge.sum(-1).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):  # rows with n = 0
        cand = np.where(valid, (S - radius[:, None]) / C, -np.inf)
    tau = np.where(widths > 0, cand.max(-1), 0).astype(np.float32)
    o = np.where(valid, np.maximum(v - tau[:, None], 0), 0).astype(np.float32)
    tau += (o.sum(-1) - radius) / np.maximum((o > 0).sum(-1), 1)
    return np.where(valid, np.maximum(v - tau[:, None], 0), 0).astype(np.float32)


@pytest.mark.parametrize("w", [1, 3, 5, 12, 33, 100, 128])
def test_sort_free_threshold_matches_xla_and_pallas(w):
    """Ties (values rounded to one decimal), n = 0 and n = 1 rows, and the
    rest ragged, at fp32 tolerance 1e-5 x radius."""
    rng = np.random.default_rng(70 + w)
    B = 40
    v = np.round(rng.standard_normal((B, w)) * 3, 1).astype(np.float32)
    v[::2] = (rng.standard_normal((B // 2, w)) * 3).astype(np.float32)  # untied rows
    widths = rng.integers(1, w + 1, size=B).astype(np.int32)
    widths[:3] = (0, 1, w)
    radius = rng.uniform(0.5, 5.0, size=B).astype(np.float32)
    mask = (np.arange(w)[None, :] < widths[:, None]).astype(np.float32)
    got = _sort_free(v, widths, radius)
    xla = np.asarray(proj_jax(jnp.asarray(v), jnp.asarray(mask), jnp.asarray(radius)))
    pallas = np.asarray(proj_simplex_pallas_t(
        jnp.asarray(v), jnp.asarray(widths), jnp.asarray(radius), tile=128, interpret=True))
    for ref in (xla, pallas):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * radius.max())
    assert np.all(got[0] == 0.0) and np.all(got[1, 1:] == 0.0)
    np.testing.assert_allclose(got[1, 0], radius[1], rtol=1e-6)
    real = widths > 0
    np.testing.assert_allclose(got[real].sum(-1), radius[real], rtol=1e-5)


def _meta_bucket(S, Bk, w, device="cpu"):
    return (torch.zeros((S, Bk, w), device=device),
            torch.ones(Bk, dtype=torch.int32, device=device),
            torch.ones(Bk, device=device))


@pytest.mark.parametrize("case", ["cpu", "mixed_devices", "width_129", "int_values",
                                  "too_many_rows"])
def test_proj_simplex_buckets_refuses(case):
    """A bucket list the kernel does not take raises, and nothing launches."""
    buckets = [_meta_bucket(2, 5, 4), _meta_bucket(2, 3, 12)]
    want = (ValueError, "CUDA")
    if case == "mixed_devices":
        buckets[1] = _meta_bucket(2, 3, 12, device="meta")
        want = (ValueError, "different devices")
    elif case == "width_129":
        buckets[1] = _meta_bucket(2, 3, 129)
        want = (ValueError, "width 129")
    elif case == "int_values":
        buckets[0] = (buckets[0][0].int(),) + buckets[0][1:]
        want = (TypeError, "float32")
    elif case == "too_many_rows":  # S * Bk past the kernel's 32-bit row index
        buckets[0] = _meta_bucket(2 ** 21, 2 ** 11, 4, device="meta")
        buckets[1] = _meta_bucket(2, 3, 12, device="meta")
        want = (ValueError, "rows in one bucket")
    bt.reset_launch_counts()
    with pytest.raises(want[0], match=want[1]):
        rowkernels.proj_simplex_buckets(*zip(*buckets))
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)


def test_proj_simplex_buckets_hands_every_bucket_to_one_launch(monkeypatch):
    """The descriptor arrays the wrapper hands ``bsls_proj_simplex_buckets``
    (the library replaced by a recorder): buckets in order, empty ones left
    out, scenarios folded, at most MAX_BUCKETS a launch, one count a
    launch."""
    calls = []

    def launcher(v, out, widths, radius, S, Bk, w, nb, stream):
        calls.append({"v": list(v[:nb]), "out": list(out[:nb]), "widths": list(widths[:nb]),
                      "radius": list(radius[:nb]), "S": list(S[:nb]), "Bk": list(Bk[:nb]),
                      "w": list(w[:nb])})
        return 0

    monkeypatch.setattr(rowkernels, "_buckets_fn", lambda: launcher)
    monkeypatch.setattr(rowkernels, "_on_one_cuda_device", lambda name, ts: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    shapes = [(3, 7, 2), (3, 0, 4), (3, 11, 12)] + [(3, 4 + i, 1 + i) for i in range(8)]
    buckets = [_meta_bucket(*sh) for sh in shapes]
    xs, sizes, radii = zip(*buckets)
    bt.reset_launch_counts()
    outs = rowkernels.proj_simplex_buckets(xs, sizes, radii)
    counts = bt.launch_counts()
    bt.reset_launch_counts()
    assert [tuple(o.shape) for o in outs] == shapes
    live = [i for i, sh in enumerate(shapes) if sh[1]]
    assert len(calls) == counts["proj_simplex_rows"] == 2
    assert [len(c["w"]) for c in calls] == [rowkernels.MAX_BUCKETS, len(live) - 8]
    got = {k: sum((c[k] for c in calls), []) for k in calls[0]}
    assert got["v"] == [xs[i].data_ptr() for i in live]
    assert got["out"] == [outs[i].data_ptr() for i in live]
    assert got["widths"] == [sizes[i].data_ptr() for i in live]
    assert got["radius"] == [radii[i].data_ptr() for i in live]
    assert got["S"] == [3] * len(live)
    assert got["Bk"] == [shapes[i][1] for i in live] and got["w"] == [shapes[i][2] for i in live]


def test_proj_blocks_on_cpu_at_the_eq_buckets_launches_nothing():
    """The four buckets of a traffic-like instance (widths 2, 4, 8 and its
    largest block) through the plain version on the CPU, against the XLA
    projection of the reference."""
    prob = bt.synthetic.traffic_like(seed=0, num_blocks=60, m=300, num_eq=3)
    dp = bt.prepare(dataclasses.replace(prob, C=None, d=None), layout="gather", device="cpu")
    assert len(dp.buckets) >= 3
    rng = np.random.default_rng(8)
    xp = tuple(torch.from_numpy((rng.standard_normal((2,) + tuple(bk.mask.shape)) * 3)
                                .astype(np.float32)) for bk in dp.buckets)
    bt.reset_launch_counts()
    out = proj_blocks(xp, dp.buckets)
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)
    for o, x, bk in zip(out, xp, dp.buckets):
        want = np.asarray(proj_jax(jnp.asarray(x.numpy()), jnp.asarray(bk.mask.numpy()),
                                   jnp.asarray(bk.radius.numpy())))
        np.testing.assert_allclose(o.numpy(), want, atol=ATOL)
