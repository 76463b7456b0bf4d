"""What can be held without a card of the redesigned kernels of the PyTorch
port: the Python statements of the rules by which the C launchers pick a kernel
or a form and size a launch (``pagekernels.grmv_path``, ``chunkkernel.chunk_plan``,
``rowkernels.PAVA_PLAN``, ``rowkernels.PROJ_PLAN``) at the shapes
``chip_smoke.py`` runs on the card; the
recurrence the fused chunk now follows (gradient carried from step to step)
against the plain loop; and the plain loop against the reference's kernel on a
ragged-width instance."""
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
from bsls_tpu_torch.ops import chunkkernel, cudalib, pagekernels, rowkernels
from bsls_tpu_torch.ops.chunkkernel import (RESIDENT_MAX_BYTES, STATE_MAX_BYTES, chunk_plan,
                                            pgd_chunk_carried_plain, pgd_chunk_plain)
from bsls_tpu_torch.ops.pagekernels import GRMV_PATHS, grmv_path
from bsls_tpu_torch.solvers.base import power_lipschitz
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

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


def _source(name):
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _pava_source():
    return _source("pava_rows.cu")


def _code(src):
    """A CUDA source without its comments."""
    return "\n".join(line.split("//")[0] for line in src.splitlines())


def test_pava_forms_agree_with_the_cuda_switch():
    """``rowkernels.PAVA_PLAN`` states the table BSLS_PAVA_FORMS that both
    the kernel's switch and the launcher's choice of form expand: the thread
    form (the minimax fit in registers) and the stack form (pool adjacent
    violators in shared memory) with its rows a block; one C entry point for
    all buckets of a call, instantiated for 1, 2, 4 and kMaxBuckets
    descriptors."""
    src = _pava_source()
    table = src[src.index("#define BSLS_PAVA_FORMS(X)"):src.index("struct PavaBucket")]
    forms = tuple(tuple(int(v) for v in m) for m in re.findall(r"X\((\d+), (\d+), (\d+)\)", table))
    assert forms == rowkernels._PAVA_FORMS
    plan = {w: ("thread", 1, w, 128) if rows == 0 else ("stack", 1, 0, rows)
            for lo, hi, rows in forms for w in range(lo, hi + 1)}
    assert plan == rowkernels.PAVA_PLAN
    kernel = re.search(r"pava_buckets_kernel\(const __grid_constant__ PavaLaunch<NB> L\).*?\n\}",
                       src, re.S).group(0)
    assert "switch (bk.form)" in kernel and "BSLS_PAVA_FORMS(BSLS_FORM_CASE)" in kernel
    assert "BSLS_PAVA_FORMS(BSLS_FORM_CODE)" in src
    assert src.count('extern "C"') == 1 and 'extern "C" int bsls_pava_buckets(' in src
    launcher = src[src.index('extern "C" int bsls_pava_buckets('):]
    assert re.findall(r"launch_pava<(\w+)>", launcher) == ["1", "2", "4", "kMaxBuckets"]
    thread = re.search(r"void fit_rows_thread\(.*?\n\}", src, re.S).group(0)
    assert re.findall(r"fit_\w+", thread) == ["fit_rows_thread", "fit_minimax"]
    fit = re.search(r"void fit_rows\(.*?\n\}", src, re.S).group(0)
    assert "fit_rows_thread<LO>" in fit and "fit_rows_stack<R>" in fit


def _proj_source():
    return _source("proj_simplex_rows.cu")


def test_proj_plan_agrees_with_the_cuda_switch():
    """``rowkernels.PROJ_PLAN`` states the table BSLS_PROJ_FORMS that both the
    kernel's switch and the launcher's choice of form expand, and the caps
    are the source's."""
    src = _proj_source()
    table = src[src.index("#define BSLS_PROJ_FORMS(X)"):src.index("struct ProjBucket")]
    forms = tuple(tuple(int(v) for v in m)
                  for m in re.findall(r"X\((\d+), (\d+), (\d+), (\d+)\)", table))
    assert forms == rowkernels._PROJ_FORMS
    plan = {w: ("thread" if g == 1 else "group", g, k)
            for lo, hi, g, k in forms for w in range(lo, hi + 1)}
    assert plan == rowkernels.PROJ_PLAN
    kernel = re.search(r"proj_buckets_kernel\(const __grid_constant__ ProjLaunch<NB> L\).*?\n\}",
                       src, re.S).group(0)
    assert "switch (bk.form)" in kernel and "BSLS_PROJ_FORMS(BSLS_FORM_CASE)" in kernel
    assert "BSLS_PROJ_FORMS(BSLS_FORM_CODE)" in src
    assert src.count('extern "C"') == 1 and 'extern "C" int bsls_proj_simplex_buckets(' in src
    # one instantiation for 1, 2, 4 and kMaxBuckets descriptors
    launcher = src[src.index('extern "C" int bsls_proj_simplex_buckets('):]
    assert re.findall(r"launch_buckets<(\w+)>", launcher) == ["1", "2", "4", "kMaxBuckets"]
    # the caps both row kernels share (csrc/rows_common.cuh)
    header = _source("rows_common.cuh")
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", header))
    assert int(consts["kMaxBuckets"]) == rowkernels.MAX_BUCKETS
    rows = re.search(r"constexpr long long kMaxRows = \(1LL << (\d+)\) - \(1LL << (\d+)\);",
                     header)
    assert 2 ** int(rows.group(1)) - 2 ** int(rows.group(2)) == rowkernels.MAX_ROWS
    # the rows of a block, less one, fit below the cap's headroom
    assert max(128 // g for _, _, g, _ in forms) <= 2 ** int(rows.group(2))
    assert int(consts["kMaxWidth"]) == rowkernels.MAX_WIDTH


@pytest.mark.parametrize("form", rowkernels._PROJ_FORMS, ids=lambda f: f"w{f[0]}-{f[1]}")
def test_every_proj_width_has_a_register_form(form):
    """Each entry covers its widths with lanes x values slots and no value a
    lane to spare; a group fits a warp's shuffle segment and holds few values
    a lane (four arrays of them); a thread form is exactly its one width (its
    loads take the width as the row stride) and sorts at most 16 slots."""
    lo, hi, lanes, values = form
    assert 32 % lanes == 0 and lanes * values >= hi and lanes * (values - 1) < lo
    if lanes == 1:
        assert lo == hi == values <= 16
    else:
        assert values <= 4


def test_proj_plan_covers_every_width_without_the_generic_form():
    """Every width 1..MAX_WIDTH has one form, and the projection's source no
    longer reaches the local-memory row of proj_device.cuh or a remainder of
    the 64-bit row index."""
    assert sorted(rowkernels.PROJ_PLAN) == list(range(1, rowkernels.MAX_WIDTH + 1))
    assert {p[0] for p in rowkernels.PROJ_PLAN.values()} == {"thread", "group"}
    his = [f[1] for f in rowkernels._PROJ_FORMS]
    los = [f[0] for f in rowkernels._PROJ_FORMS]
    assert los == [1] + [h + 1 for h in his[:-1]] and his[-1] == rowkernels.MAX_WIDTH
    # the projection's source with the helpers it shares with PAVA
    code = _code(_proj_source() + _source("rows_common.cuh"))
    assert "proj_device.cuh" not in code and "proj_simplex_row(" not in code
    assert "kMaxWidth]" not in code and "row % " not in code
    # the one remainder by Bk left is 32-bit, of a block index in a small bucket
    assert re.findall(r"\w+ % \w*Bk", code) == ["b % Bk"]
    assert re.search(r"unsigned int block_of\(unsigned int b0, unsigned int off,", code)


@pytest.mark.parametrize("form", rowkernels._PAVA_FORMS, ids=lambda f: f"w{f[0]}-{f[1]}")
def test_every_pava_width_has_a_register_or_shared_form(form):
    """A thread form is exactly its one width (its loads take the width as
    the row stride) up to 16, its row and fit in registers; a stack form
    holds R rows a block in shared memory, R a whole number of warps that
    divides the block, at most 4096 values (about 17 KB, at least 13 blocks
    a multiprocessor in a launch that mixes forms, and under the 48 KB a
    launch takes without an opt-in)."""
    lo, hi, rows = form
    if rows == 0:
        assert lo == hi <= 16
    else:
        assert rows % 32 == 0 and 128 % rows == 0 and rows * hi <= 4096
        smem = hi * (rows + 1) * 4
        assert smem <= 48 * 1024 and (228 * 1024) // (smem + 1024) >= 13


def test_pava_plan_covers_every_width_without_the_generic_form():
    """Every width 1..MAX_WIDTH has one form, and PAVA's source no longer has
    the generic kernel, its stack in local memory (arrays of kMaxWidth a
    thread) or a remainder of the 64-bit row index."""
    assert sorted(rowkernels.PAVA_PLAN) == list(range(1, rowkernels.MAX_WIDTH + 1))
    assert {p[0] for p in rowkernels.PAVA_PLAN.values()} == {"thread", "stack"}
    his = [f[1] for f in rowkernels._PAVA_FORMS]
    los = [f[0] for f in rowkernels._PAVA_FORMS]
    assert los == [1] + [h + 1 for h in his[:-1]] and his[-1] == rowkernels.MAX_WIDTH
    code = _code(_pava_source())
    assert "pava_rows_generic" not in code and "pava_push" not in code
    assert "kMaxWidth]" not in code and "row % " not in code and "% Bk" not in code
    assert "extern __shared__ float sm[];" in code
