"""Bounded isotonic regression and the x<->z change of variable of the
PyTorch port against the JAX package (XLA function, Pallas kernel in
interpret mode) and the numpy reference; the arithmetic of each form of the
CUDA kernel, restated in numpy, against the same; and what the grouped
wrapper refuses and hands its launcher."""
import contextlib
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu.ops.isotonic as JI
import bsls_tpu.ops.ztransform as JZ
import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.isotonic as TI
import bsls_tpu_torch.ops.ztransform as TZ
from bsls_tpu.ops.pallas.pava_kernel import pava_pallas_t
from bsls_tpu_torch.ops import rowkernels
from bsls_tpu_torch.utils.refimpl import (
    pava_blocks_np, pava_np, x_to_z_np, z_to_x_np,
)
from torch_port_helpers import KERNELS
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

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


# Inputs of the kinds the kernel meets, made from a seed with numpy: (y, widths,
# radius) for a (B, w) bucket.  "solve_like" is the trial point z - t D^T g of a
# z-space step on a seeded least-squares instance, through the reference's
# z-transform (widths = block sizes - 1, as the solver passes them); "plateaus"
# has runs of equal values and segments with exactly tied means; "large" has
# values of a few hundred with radii of the same size, as the solve path gives
# the kernel; "full_and_tiny" has every row at n = w, 0 and 1.
PAVA_KINDS = ["solve_like", "plateaus", "large", "full_and_tiny"]
# every form of the kernel: thread forms (1-12), stack forms of 128, 64 and 32
# rows a block (13-32, 33-64, 65-128), the last width of each among them
PAVA_WIDTHS = [1, 2, 3, 4, 5, 8, 12, 16, 17, 24, 32, 33, 64, 100, 128]


def _pava_inputs(kind, w, B=37, seed=11):
    rng = np.random.default_rng([seed, w, PAVA_KINDS.index(kind)])
    radius = rng.uniform(0.5, 3.0, size=B).astype(np.float32)
    widths = rng.integers(0, w + 1, size=B).astype(np.int32)
    if kind == "solve_like":
        sizes = rng.integers(1, w + 1, size=B)
        mask = (np.arange(w)[None, :] < sizes[:, None]).astype(np.float32)
        n = int(sizes.sum())
        m = 3 * n
        A = rng.standard_normal((m, n)) / np.sqrt(m)
        x = np.zeros((B, w))
        for i, k in enumerate(sizes):
            x[i, :k] = radius[i] * rng.dirichlet(np.ones(k))
        b = A @ x[mask > 0] + 0.1 * rng.standard_normal(m)
        g = np.zeros((B, w))
        g[mask > 0] = A.T @ (A @ x[mask > 0] - b)
        z = np.asarray(JZ.x_to_z_padded(jnp.asarray(x, jnp.float32), jnp.asarray(mask)))
        gz = np.asarray(JZ.dz_adjoint_padded(jnp.asarray(g, jnp.float32), jnp.asarray(mask)))
        y = (z - 4.0 * w * w * gz).astype(np.float32)  # a trial step of 1 / L_z, L_z ~ w^2
        widths = np.maximum(sizes - 1, 0).astype(np.int32)
    elif kind == "plateaus":
        y = rng.integers(-2, 3, size=(B, w)).astype(np.float32) * 0.5 * radius[:, None]
        y[: B // 4] = 0.5 * radius[: B // 4, None]  # constant rows
        if w >= 3:  # [2a, 0, a, ...]: the first two pool to mean a, tied with the third
            y[B // 4: B // 2, :3] = np.array([2.0, 0.0, 1.0], np.float32) * radius[B // 4: B // 2, None]
    elif kind == "large":
        radius = rng.uniform(100.0, 400.0, size=B).astype(np.float32)
        y = (rng.standard_normal((B, w)) * 150.0 + 0.5 * radius[:, None]).astype(np.float32)
    else:
        y = (rng.standard_normal((B, w)) * 2).astype(np.float32) * radius[:, None]
        widths[:] = w
        widths[1::3] = 0
        widths[2::3] = min(1, w)
    return y, widths, radius


def _pava_f64(y, widths, radius):
    out = np.zeros(y.shape)
    for i, n in enumerate(widths):
        if n:
            out[i, :n] = pava_np(y[i, :n].astype(np.float64), lo=0.0, hi=float(radius[i]))
    return out


def _stack_form_f32(y, widths, radius):
    """The arithmetic of the stack form of csrc/pava_rows.cu, restated in
    numpy float32 in the kernel's order, row by row: pool-adjacent-violators
    with the sum of the level that starts at slot p kept at slot p, the level
    starts as the bits of an integer, the top level's start, sum and mean
    held apart; a level's mean is its sum over its count (rounded here, the
    kernel's fast division is within 2 ulp of it), the same wherever it is
    needed; the fit expanded from the last slot down, clipped to [0, radius];
    a NaN among a row's fitted slots makes all of them NaN."""
    f = np.float32
    mean = lambda total, count: f(total / f(count))
    below = lambda bits, p: (bits & ((1 << p) - 1)).bit_length() - 1  # last start before p
    out = np.zeros(y.shape, f)
    for r in range(y.shape[0]):
        n = max(0, min(int(widths[r]), y.shape[1]))
        col = y[r].astype(f).copy()
        bits, bad, ts, tsum, tmean = 0, False, 0, f(0.0), f(0.0)
        for i in range(n):
            v = col[i]
            bad |= bool(np.isnan(v))
            cs, csum, cmean = i, v, v
            while cs > 0 and tmean > cmean:
                bits &= ~(1 << cs)
                csum = f(csum + tsum)
                cs = ts
                cmean = mean(csum, i + 1 - cs)
                if cs > 0:
                    ts = below(bits, cs)
                    tsum = col[ts]
                    tmean = mean(tsum, cs - ts)
            bits |= 1 << cs
            col[cs] = csum
            ts, tsum, tmean = cs, csum, cmean
        st, o = n, f(0.0)
        for i in range(n - 1, -1, -1):
            if i < st:
                end, st = st, below(bits, st)
                o = f(np.nan) if bad else min(max(mean(col[st], end - st), f(0.0)), f(radius[r]))
            col[i] = o
        col[n:] = 0.0
        out[r] = col
    return out


def _kernel_form_f32(y, widths, radius):
    """The arithmetic of the form the kernel takes at this width
    (``rowkernels.PAVA_PLAN``), restated."""
    form = rowkernels.PAVA_PLAN[y.shape[1]][0]
    return (_minimax_form_f32 if form == "thread" else _stack_form_f32)(y, widths, radius)


def _minimax_form_f32(y, widths, radius):
    """The arithmetic of the minimax form of csrc/pava_rows.cu, restated in
    numpy float32 in the kernel's order: slots past the width enter as +inf;
    for each end k and each start j <= k a running sum of y[j..k], times the
    reciprocal of k - j + 1, folded with max over j and min over k (numpy's
    fmax/fmin, which drop a NaN as fmaxf/fminf do); a NaN among a row's fitted
    slots makes all of them NaN."""
    f = np.float32
    B, w = y.shape
    x = np.where(np.arange(w)[None, :] < widths[:, None], y, f(np.inf)).astype(f)
    fit = np.full((B, w), np.inf, f)
    total = np.zeros((B, w), f)
    for k in range(w):
        run = None
        for j in range(k + 1):
            total[:, j] = x[:, k] if j == k else total[:, j] + x[:, k]
            mean = total[:, j] * (f(1.0) / f(k - j + 1))
            run = mean if j == 0 else np.fmax(run, mean)
            fit[:, j] = np.fmin(fit[:, j], run)
    out = np.minimum(np.maximum(fit, f(0.0)), radius[:, None].astype(f))
    inside = np.arange(w)[None, :] < widths[:, None]
    bad = np.isnan(np.where(inside, y, f(0.0))).any(axis=1)  # NaN among the fitted slots
    out = np.where(bad[:, None], f(np.nan), out)
    return np.where(inside, out, f(0.0))


@pytest.mark.parametrize("w", PAVA_WIDTHS)
@pytest.mark.parametrize("kind", PAVA_KINDS)
def test_plain_pava_against_references_on_kernel_inputs(kind, w):
    """The plain version (what the CPU path and the card's check use) against
    the reference's XLA function, its Pallas kernel in interpret mode and the
    float64 stack PAVA, within ATOL times the inputs' magnitude."""
    y, widths, radius = _pava_inputs(kind, w)
    mask = (np.arange(w)[None, :] < widths[:, None]).astype(np.float32)
    tol = ATOL * max(1.0, float(np.abs(y).max()), float(radius.max()))
    got = TI.pava_bounded(torch.from_numpy(y), torch.from_numpy(widths),
                          torch.from_numpy(radius)).numpy()
    np.testing.assert_allclose(got, _pava_f64(y, widths, radius), rtol=0, atol=tol)
    xla = np.asarray(JI.pava_padded(jnp.asarray(y), jnp.asarray(mask), 0.0, jnp.asarray(radius)))
    np.testing.assert_allclose(got, xla, rtol=0, atol=tol)
    pallas = np.asarray(pava_pallas_t(jnp.asarray(y), jnp.asarray(widths), jnp.asarray(radius),
                                      tile=128, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)
    assert np.all(got[mask == 0] == 0.0)
    assert np.all(np.diff(got, axis=1)[mask[:, 1:] > 0] >= -tol)


@pytest.mark.parametrize("w", PAVA_WIDTHS)
@pytest.mark.parametrize("kind", PAVA_KINDS)
def test_kernel_minimax_form_restated_matches_float64_pava(kind, w):
    """The kernel's own arithmetic at this width, restated (the minimax
    formula where the width takes a thread form, the stack where it takes a
    stack form): within ATOL times the inputs' magnitude of the float64 PAVA,
    of the plain version and of the reference's XLA function and Pallas
    kernel in interpret mode, exactly nondecreasing (each mean is computed
    once and reused) and inside [0, radius]."""
    y, widths, radius = _pava_inputs(kind, w)
    tol = ATOL * max(1.0, float(np.abs(y).max()), float(radius.max()))
    got = _kernel_form_f32(y, widths, radius)
    np.testing.assert_allclose(got, _pava_f64(y, widths, radius), rtol=0, atol=tol)
    plain = TI.pava_bounded(torch.from_numpy(y), torch.from_numpy(widths),
                            torch.from_numpy(radius)).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=tol)
    mask = (np.arange(w)[None, :] < widths[:, None]).astype(np.float32)
    xla = np.asarray(JI.pava_padded(jnp.asarray(y), jnp.asarray(mask), 0.0, jnp.asarray(radius)))
    np.testing.assert_allclose(got, xla, rtol=0, atol=tol)
    pallas = np.asarray(pava_pallas_t(jnp.asarray(y), jnp.asarray(widths), jnp.asarray(radius),
                                      tile=128, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=tol)
    inner = np.arange(1, w)[None, :] < widths[:, None]
    assert np.all(np.diff(got, axis=1)[inner] >= 0.0)
    assert np.all(got >= 0.0) and np.all(got <= radius[:, None])


@pytest.mark.parametrize("w", PAVA_WIDTHS)
def test_nan_rows_kernel_form_restated_matches_plain(w):
    """A NaN among a row's fitted slots makes all of them NaN in the plain
    version, in the kernel's arithmetic restated (the form of this width) and
    in the reference's Pallas kernel; a NaN in a padding slot changes
    nothing; the other rows keep their fit."""
    y, widths, radius = _pava_inputs("large", w)
    rng = np.random.default_rng(w)
    hit = np.zeros(len(widths), bool)
    for b in range(0, len(widths), 3):
        if widths[b] > 0:
            y[b, rng.integers(0, widths[b])] = np.nan
            hit[b] = True
        elif w > 1:
            y[b, rng.integers(0, w)] = np.nan  # padding only
    tol = ATOL * max(1.0, float(np.nanmax(np.abs(y))), float(radius.max()))
    plain = TI.pava_bounded(torch.from_numpy(y), torch.from_numpy(widths),
                            torch.from_numpy(radius)).numpy()
    got = _kernel_form_f32(y, widths, radius)
    inside = np.arange(w)[None, :] < widths[:, None]
    assert hit.any()
    np.testing.assert_array_equal(np.isnan(plain), hit[:, None] & inside)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(plain))
    pallas = np.asarray(pava_pallas_t(jnp.asarray(y), jnp.asarray(widths), jnp.asarray(radius),
                                      tile=128, interpret=True))
    np.testing.assert_array_equal(np.isnan(pallas), np.isnan(plain))
    np.testing.assert_allclose(got[~hit], _pava_f64(y[~hit], widths[~hit], radius[~hit]),
                               rtol=0, atol=tol)


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


def _meta_bucket(S, Bk, w, device="cpu"):
    return (torch.zeros((S, Bk, w), device=device),
            torch.ones(Bk, dtype=torch.int32, device=device),
            torch.ones(Bk, device=device))


@pytest.mark.parametrize("case", ["cpu", "mixed_devices", "width_129", "float64", "int_values"])
def test_pava_buckets_refuses(case):
    """A bucket list the kernel does not take raises, and nothing launches:
    tensors on the CPU (the wrapper never falls back), on two devices, a
    width past 128, float64 or integer values."""
    buckets = [_meta_bucket(2, 5, 4), _meta_bucket(2, 3, 12)]
    want = (ValueError, "CUDA")
    if case == "mixed_devices":
        buckets[1] = _meta_bucket(2, 3, 12, device="meta")
        want = (ValueError, "different devices")
    elif case == "width_129":
        buckets[1] = _meta_bucket(2, 3, 129)
        want = (ValueError, "width 129")
    elif case == "float64":
        buckets[0] = (buckets[0][0].double(), buckets[0][1], buckets[0][2].double())
        want = (TypeError, "float32")
    elif case == "int_values":
        buckets[0] = (buckets[0][0].int(),) + buckets[0][1:]
        want = (TypeError, "float32")
    bt.reset_launch_counts()
    with pytest.raises(want[0], match=want[1]):
        rowkernels.pava_buckets(*zip(*buckets))
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)


class _OnCard(torch.Tensor):
    """A CPU tensor that says it lies on the card: the branch of
    ``pava_blocks`` that launches, with the library replaced by a recorder."""

    @property
    def is_cuda(self):
        return True


def _eq_buckets():
    """The buckets of a traffic-like instance (widths 2, 4, 8 and its
    largest block), prepared on the CPU."""
    prob = bt.synthetic.traffic_like(seed=0, num_blocks=60, m=300, num_eq=3)
    dp = bt.prepare(dataclasses.replace(prob, C=None, d=None), layout="gather", device="cpu")
    assert len(dp.buckets) >= 3
    return dp.buckets


def test_pava_blocks_hands_every_bucket_to_one_launch(monkeypatch):
    """One ``pava_blocks`` call on the card hands every bucket to one launch
    of ``bsls_pava_buckets``: in order, scenarios folded, the z-space widths
    (block size - 1) the bucket keeps, one launch count."""
    calls = []

    def launcher(y, out, widths, radius, S, Bk, w, nb, stream):
        calls.append({"y": list(y[:nb]), "out": list(out[:nb]), "widths": list(widths[:nb]),
                      "radius": list(radius[:nb]), "S": list(S[:nb]), "Bk": list(Bk[:nb]),
                      "w": list(w[:nb])})
        return 0

    monkeypatch.setattr(rowkernels, "_pava_fn", lambda: launcher)
    monkeypatch.setattr(rowkernels, "_on_one_cuda_device", lambda name, ts: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: types.SimpleNamespace(cuda_stream=0))
    buckets = _eq_buckets()
    yp = tuple(torch.zeros((4,) + tuple(bk.mask.shape)).as_subclass(_OnCard) for bk in buckets)
    bt.reset_launch_counts()
    outs = TI.pava_blocks(yp, buckets)
    counts = bt.launch_counts()
    bt.reset_launch_counts()
    assert len(calls) == counts["pava_rows"] == 1
    assert counts == {**dict.fromkeys(KERNELS, 0), "pava_rows": 1}
    call, = calls
    assert call["y"] == [y.data_ptr() for y in yp]
    assert call["out"] == [o.data_ptr() for o in outs]
    assert call["widths"] == [bk.zwidths.data_ptr() for bk in buckets]
    assert call["radius"] == [bk.radius.data_ptr() for bk in buckets]
    assert call["S"] == [4] * len(buckets)
    assert call["Bk"] == [bk.mask.shape[0] for bk in buckets]
    assert call["w"] == [bk.width for bk in buckets]
    for bk in buckets:
        np.testing.assert_array_equal(bk.zwidths.numpy(), np.maximum(bk.sizes.numpy() - 1, 0))


def test_pava_blocks_on_cpu_at_the_eq_buckets_launches_nothing():
    """The same buckets through the plain version on the CPU: no launch, each
    bucket the one-bucket plain fit of its z-space widths, and within ATOL of
    the reference's XLA function."""
    buckets = _eq_buckets()
    rng = np.random.default_rng(12)
    yp = tuple(torch.from_numpy((rng.standard_normal((2,) + tuple(bk.mask.shape)) * 2)
                                .astype(np.float32)) for bk in buckets)
    bt.reset_launch_counts()
    out = TI.pava_blocks(yp, buckets)
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)
    for o, y, bk in zip(out, yp, buckets):
        widths = torch.clamp(bk.sizes - 1, min=0)
        assert torch.equal(o, TI.pava_bounded(y, widths, bk.radius))
        mask = (np.arange(bk.width)[None, :] < widths.numpy()[:, None]).astype(np.float32)
        want = np.asarray(JI.pava_padded(jnp.asarray(y.numpy()), jnp.asarray(mask), 0.0,
                                         jnp.asarray(bk.radius.numpy())))
        np.testing.assert_allclose(o.numpy(), want, rtol=0, atol=ATOL * float(bk.radius.max()))
