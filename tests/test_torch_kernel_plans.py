"""What can be held without a card of the two redesigned kernels of the
PyTorch port: the Python statements of the rules by which the C launchers pick
a kernel and size a launch (``pagekernels.grmv_path``, ``chunkkernel.chunk_plan``)
at the shapes ``chip_smoke.py`` runs on the card; the recurrence the fused chunk
now follows (gradient carried from step to step) against the plain loop; and
the plain loop against the reference's kernel on a ragged-width instance."""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu
import bsls_tpu.ops.layout as JL
import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.layout as TL
from bsls_tpu.ops.pallas.megastep_kernel import pgd_chunk_fused, split_slots
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.ops import chunkkernel, cudalib, pagekernels
from bsls_tpu_torch.ops.chunkkernel import (RESIDENT_MAX_BYTES, STATE_MAX_BYTES, chunk_plan,
                                            pgd_chunk_carried_plain, pgd_chunk_plain)
from bsls_tpu_torch.ops.pagekernels import GRMV_PATHS, grmv_path
from bsls_tpu_torch.solvers.base import power_lipschitz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "bsls_tpu_torch", "csrc")
SMS = 132  # blocks of a launch on an H100
# the limits chip_smoke.py holds the kernel to
CHUNK_TRACE_LIMIT, CHUNK_X_LIMIT = 1e-3, 2e-5

# (m, B, w) -> (resident, state in shared memory): tiny_dense and the random
# problems of chip_smoke.py
CHUNK_CASES = {
    (1000, 100, 10): (True, True), (37, 9, 1): (True, True), (1000, 61, 4): (True, True),
    (1531, 50, 10): (True, True), (1000, 33, 10): (True, True), (1000, 21, 33): (True, True),
    (37, 3, 10): (True, True), (1531, 7, 128): (True, True), (4096, 16, 128): (False, True),
    (900000, 2, 4): (False, False),
}


@pytest.mark.parametrize("shape", sorted(CHUNK_CASES))
def test_chunk_plan_at_the_shapes_of_the_chip_run(shape):
    m, B, w = shape
    n = B * w
    plan = chunk_plan(m, B, w, SMS)
    assert (plan["resident"], plan["local_state"]) == CHUNK_CASES[shape]
    rows, cols = plan["rows_per_block"], plan["cols_per_block"]
    assert rows * SMS >= m > (rows - 1) * SMS and cols == -(-B // SMS) * w
    state = (2 * rows + 3 * cols) * 4
    want = (state if plan["local_state"] else 0) + (rows * n * 4 if plan["resident"] else 0)
    assert plan["smem_bytes"] == want <= RESIDENT_MAX_BYTES
    # partial gradients, d, five shares per block, the state
    assert plan["scratch_floats"] == SMS * n + n + 5 * SMS + n + 2 * m


@pytest.mark.parametrize("B,w", [(100, 10), (16, 128), (331, 1)])
def test_chunk_plan_turns_to_streaming_at_the_limit(B, w):
    """The last m whose rows fit beside the state is resident, the next is not."""
    n, cols = B * w, -(-B // SMS) * w
    state = lambda rows: (2 * rows + 3 * cols) * 4
    rows = max(r for r in range(1, 400) if r * n * 4 + state(r) <= RESIDENT_MAX_BYTES)
    assert chunk_plan(rows * SMS, B, w, SMS)["resident"]
    over = chunk_plan(rows * SMS + 1, B, w, SMS)
    assert not over["resident"] and over["local_state"]
    assert over["smem_bytes"] == state(rows + 1) <= STATE_MAX_BYTES
    # 227 KB a block less the static buffers: about 26 MB of A over 132 blocks
    assert 24e6 < RESIDENT_MAX_BYTES * SMS < 27e6
    with pytest.raises(ValueError):
        chunk_plan(0, 1, 1, SMS)


# (band offset, R offset in bytes, S, Mp, W, stride_s, stride_g) -> kernel
GRMV_CASES = {
    "medium_banded_s1": ((0, 0, 1, 782, 512, 100480, 128), "ring"),
    "medium_banded_s4_windows": ((0, 0, 4, 782, 512, 100608, 128), "ring"),
    "contiguous_s33": ((0, 0, 33, 37, 1024, 37 * 1024, 1024), "ring"),
    "narrow_w4": ((0, 0, 4, 37, 4, 148, 4), "ring"),
    "w130_no_multiple_of_4": ((0, 0, 1, 37, 130, 4810, 130), "scalar"),
    "base_1_float_off": ((0, 4, 3, 37, 384, 5124, 128), "scalar"),
    "base_2_floats_off": ((0, 8, 3, 37, 384, 5124, 128), "scalar"),
    "odd_scenario_stride": ((0, 0, 3, 37, 384, 5121, 128), "scalar"),
    "odd_scenario_stride_s1": ((0, 0, 1, 37, 384, 5121, 128), "ring"),
    "odd_page_stride_one_page": ((0, 0, 1, 1, 512, 0, 7), "ring"),
    "band_off_boundary": ((8, 0, 1, 37, 512, 0, 512), "scalar"),
    "too_wide_for_the_ring": ((0, 0, 16, 5, 1536, 7680, 1536), "scalar"),
    "widest_ring_at_s16": ((0, 0, 16, 5, 1064, 5320, 1064), "ring"),
    "far_too_wide": ((0, 0, 16, 5, 4096, 20480, 4096), "scalar"),
}


@pytest.mark.parametrize("name", sorted(GRMV_CASES))
def test_grmv_path_rule(name):
    (band_off, r_off, S, Mp, W, ss, sg), want = GRMV_CASES[name]
    plan = grmv_path(1 << 20 | band_off, 1 << 21 | r_off, S, Mp, W, ss, sg)
    assert GRMV_PATHS[plan["path"]] == want
    if want == "ring":
        ns = min(16, 1 << (S - 1).bit_length())
        assert plan["tile_rows"] in (8, 16, 32) and 2 <= plan["stages"] <= 4
        assert plan["smem"] == ((plan["stages"] * plan["tile_rows"] + 2 * ns) * W * 4 + 128)
        assert plan["smem"] <= 227 * 1024
    else:
        assert plan["smem"] == 0


def test_grmv_path_of_real_tensors_on_the_cpu_path():
    """The rule reads what the wrapper hands the launcher: data_ptr and strides
    of the page windows of a padded residual."""
    rp = torch.zeros((3, 40 * 128 + 4))
    for off, want in ((0, "ring"), (1, "scalar"), (2, "scalar")):
        v = rp.as_strided((3, 37, 384), (rp.stride(0), 128, 1), off)
        plan = grmv_path(0, v.data_ptr() - rp.data_ptr(), 3, 37, 384, v.stride(0), v.stride(1))
        assert GRMV_PATHS[plan["path"]] == want
    band, v = torch.randn(5, 7, 130), torch.randn(2, 5, 130)
    torch.testing.assert_close(pagekernels.band_grmv(band, v),
                               torch.einsum("gcw,sgw->sgc", band, v))


def _ragged(seed=5, B=40, m=320):
    """One bucket of width 8 with block sizes 5..8, made the way
    ``synthetic.tiny_dense`` makes its instance, for both packages."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(5, 9, size=B)
    n = int(sizes.sum())
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    b = A @ tsyn.random_block_x(rng, sizes) + 1e-3 * rng.standard_normal(m)
    return A, b, sizes


@pytest.mark.parametrize("steps", [1, 120])
def test_plain_chunk_matches_pallas_interpret_on_ragged_widths(steps):
    A, b, sizes = _ragged()
    dt = TL.prepare(bt.Problem.from_arrays(A, b, sizes), device="cpu")
    dj = JL.prepare(bsls_tpu.Problem.from_arrays(A, b, sizes))
    assert len(dt.buckets) == 1 and isinstance(dt.A, TL.DeviceDense)
    bk = dt.buckets[0]
    B, w = bk.mask.shape
    assert w == 8 and int(bk.sizes.min()) < w  # ragged: some slots are padding
    t0 = 1.0 / power_lipschitz(dt)
    x0 = TL.feasible_init(dt)[0]
    x, f = pgd_chunk_plain(dt.A.data, dt.b, x0, bk.sizes, bk.radius, t0, steps)
    A3, At3 = split_slots(dj.A.data, B, w)
    xj, fj = pgd_chunk_fused(A3, At3, dj.b, jnp.asarray(x0.numpy()), dj.buckets[0].sizes,
                             dj.buckets[0].radius, t0, steps=steps, interpret=True)
    # the limits of tests/test_torch_mega.py for this pair: the reference
    # bisects where the port sorts
    rel = np.abs(f.numpy() - np.asarray(fj)) / np.maximum(1e-9, np.abs(np.asarray(fj)))
    assert rel.max() < 1e-3
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), atol=2e-5)
    assert float((x * (1 - bk.mask)).abs().max()) == 0.0
    np.testing.assert_allclose((x * bk.mask).sum(-1).numpy(), bk.radius.numpy(), rtol=1e-5)


@pytest.mark.parametrize("kind", ["tiny_dense", "ragged"])
def test_carried_gradient_recurrence_matches_the_plain_loop(kind):
    """g += t A^T (A d) instead of g = A^T r: 200 steps within the limits the
    kernel is held to on the card."""
    if kind == "tiny_dense":
        dt = TL.prepare(tsyn.tiny_dense(seed=0, num_blocks=40, dim=8, m=320), device="cpu")
    else:
        dt = TL.prepare(bt.Problem.from_arrays(*_ragged(seed=7)), device="cpu")
    bk = dt.buckets[0]
    args = (dt.A.data, dt.b, TL.feasible_init(dt)[0], bk.sizes, bk.radius,
            1.0 / power_lipschitz(dt))
    x, f = pgd_chunk_plain(*args, 200)
    xc, fc = pgd_chunk_carried_plain(*args, 200)
    assert not torch.equal(f, fc)  # another order of arithmetic, not the same code
    rel = ((f - fc).abs() / f.abs().clamp(min=1e-9)).max()
    assert float(rel) <= CHUNK_TRACE_LIMIT
    assert float((x - xc).abs().max()) <= CHUNK_X_LIMIT
    # one step is the same arithmetic up to the order of two sums
    x1, f1 = pgd_chunk_plain(*args, 1)
    y1, h1 = pgd_chunk_carried_plain(*args, 1)
    torch.testing.assert_close(x1, y1, atol=1e-6, rtol=0)
    torch.testing.assert_close(f1, h1, rtol=1e-5, atol=0)


def test_variant_entry_points_refuse_cpu_tensors():
    dt = TL.prepare(tsyn.tiny_dense(seed=1, num_blocks=6, dim=4, m=30), device="cpu")
    bk = dt.buckets[0]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        chunkkernel.pgd_chunk_variant(dt.A.data, dt.b, TL.feasible_init(dt)[0], bk.sizes,
                                      bk.radius, 0.1, 5, resident=True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        pagekernels.band_grmv_on_path(torch.zeros(2, 3, 8), torch.zeros(1, 2, 8), 0)
    assert cudalib._lib is None or not torch.cuda.is_available()


def test_constants_agree_with_the_cuda_sources():
    """The Python statements of the two rules use the constants of the .cu files."""
    def constants(path):
        with open(os.path.join(CSRC, path)) as fh:
            src = fh.read()
        return {k: eval(v, {}) for k, v in  # plain integer arithmetic only
                re.findall(r"constexpr int (k\w+) = ([0-9*+\- ()]+);", src)}

    chunk = constants("pgd_chunk.cu")
    assert chunk["kResidentMaxBytes"] == RESIDENT_MAX_BYTES
    assert chunk["kStateMaxBytes"] == STATE_MAX_BYTES
    pages = constants("band_pages.cu")
    assert pages["kRingBudget"] == pagekernels._RING_BUDGET
    assert pages["kRingInFlight"] == pagekernels._RING_IN_FLIGHT
    assert pages["kMaxStages"] == pagekernels._MAX_STAGES
    assert pages["kWindowSlots"] == pagekernels._WINDOW_SLOTS
    assert pages["kMaxTileRows"] == pagekernels._MAX_TILE_ROWS
    assert pages["kRingBarrierBytes"] == pagekernels._RING_BARRIER_BYTES
