"""The ELL product kernel (``csrc/ell_products.cu``, wrapper
``ops/ellkernels.py``).

Without a card: the Python statement of the kernel's thread mapping
(``ell_plan``) and of the wrapper's split of a product into launches
(``ell_launches``), the constants they share with the source, the kernel's
index arithmetic run over numpy arrays (every output element written once,
every staged value read after it was written, the sums those of the plain
version), the wrapper's refusals before any launch, and the CPU path, which
never reaches the kernel.

Tests marked ``chip`` need an NVIDIA GPU and skip without one.  This file
imports nothing of JAX, so that they run on the card with
``python -m pytest tests/test_torch_ellkernel.py -m chip --noconftest -q``.
"""
import os
import re

import numpy as np
import pytest
import torch

import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.layout as TL
from bsls_tpu_torch.models.partition import BlockPartition
from bsls_tpu_torch.models.problem import ScaledMatrix, VStackMatrix
from bsls_tpu_torch.ops import cudalib, ellkernels
from bsls_tpu_torch.ops.ellkernels import MAX_GROUPS, THREADS, ell_launches, ell_plan
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "bsls_tpu_torch", "csrc", "ell_products.cu")
# the kernel against the plain version on the card: fp32 sums of the same
# products taken in another order (registers over k against the plain
# version's reduction), relative to the largest entry of the product
REL_LIMIT = 5e-4

# S -> (lanes a row, rows a warp, floats a lane, rows a tile) over an
# operand that a fresh allocation gives (16-byte aligned)
PLANS = {
    1: (1, 32, 1, 256), 2: (1, 32, 2, 256), 3: (4, 8, 1, 64), 4: (1, 32, 4, 256),
    31: (32, 1, 1, 32), 32: (8, 4, 4, 32), 33: (32, 1, 1, 32), 127: (32, 1, 1, 32),
    128: (32, 1, 4, 32), 129: (32, 1, 1, 32), 256: (32, 1, 4, 32),
}


@pytest.mark.parametrize("S", sorted(PLANS))
def test_ell_plan_at_the_widths_the_paths_use(S):
    lanes, rows_warp, floats, tile = plan = ell_plan(S)
    assert plan == PLANS[S]
    assert S % floats == 0 and lanes & (lanes - 1) == 0 and lanes * rows_warp == 32
    # the lanes of a row cover its scenarios, in chunks of lanes * floats
    # where S / floats passes 32 lanes
    assert lanes * floats >= S or lanes == 32
    assert lanes * floats < 2 * S or lanes == 1
    assert tile == max(32, THREADS // lanes) and tile & (tile - 1) == 0


def test_ell_plan_narrows_the_vector_on_a_misaligned_operand():
    assert ell_plan(128, align=8) == (32, 1, 2, 32)
    assert ell_plan(128, align=4) == (32, 1, 1, 32)
    assert ell_plan(32, align=8) == (16, 2, 2, 32)
    assert ell_plan(6) == (4, 8, 2, 64)


def test_constants_agree_with_the_cuda_source():
    with open(SOURCE) as fh:
        src = fh.read()
    consts = dict(re.findall(r"constexpr int (kEll\w+) = ([0-9]+);", src))
    assert int(consts["kEllThreads"]) == THREADS
    assert int(consts["kEllMaxGroups"]) == MAX_GROUPS
    assert int(consts["kEllMaxLanes"]) == ellkernels._MAX_LANES
    # the staging tile holds the widest tile a plan gives: rows x (lanes + 1)
    widest = max(tile * (lanes + 1) for lanes, _, _, tile in
                 (ell_plan(S) for S in range(2, 300)) if lanes > 1)
    assert re.search(r"kEllTileVectors = 32 \* \(kEllMaxLanes \+ 1\);", src)
    assert widest == 32 * (ellkernels._MAX_LANES + 1)


def test_ell_launches_packs_the_groups():
    # one launch: the zero rows, then the groups' sorted rows, empty ones out
    assert ell_launches([5, 0, 7], zeros=3) == [([0, 2], 0, 15, [3, 8])]
    assert ell_launches([4]) == [([0], 0, 4, [0])]
    # more than MAX_GROUPS groups: a launch per eight live groups, each
    # computing its window of sorted rows, the zeros in the first
    rows = [2, 3, 0, 1, 4, 5, 0, 6, 7, 1, 2, 3]
    (g0, lo0, hi0, s0), (g1, lo1, hi1, s1) = ell_launches(rows, zeros=4)
    starts = 4 + np.concatenate([[0], np.cumsum(rows)[:-1]])
    assert g0 == [0, 1, 3, 4, 5, 7, 8, 9] and g1 == [10, 11]
    assert (lo0, hi0) == (0, starts[9] + 1) and (lo1, hi1) == (starts[10], 4 + sum(rows))
    assert s0 == [starts[i] for i in g0] and s1 == [starts[i] for i in g1]
    assert hi0 == lo1
    # zero rows alone: one launch without groups; nothing at all: none
    assert ell_launches([], zeros=5) == [([], 0, 5, [])]
    assert ell_launches([0, 0]) == []


def _groups(rows, rng, n):
    """Row-major (rows_i, w_i) ELL groups of ascending width, with padding
    slots (index 0, value 0) as prepare() leaves them."""
    cols, vals = [], []
    for i, r in enumerate(rows):
        w = 1 + i % 5 + i // 5
        c = rng.integers(0, n, size=(r, w)).astype(np.int32)
        v = rng.standard_normal((r, w)).astype(np.float32)
        pad = rng.random((r, w)) < 0.2
        c[pad], v[pad] = 0, 0.0
        cols.append(torch.from_numpy(c))
        vals.append(torch.from_numpy(v))
    return cols, vals


def emulate(cols, vals, vt, zeros=0, rank=None, align=16):
    """The kernel of csrc/ell_products.cu run over numpy arrays: each launch
    of ``ell_launches``, each block of its grid, each thread's rows and
    stores, with the index arithmetic of ell_gather_dot_kernel.  Returns the
    (S, rows) output, the count of writes to each element, and the largest
    staging slot used."""
    cols = [c.numpy() for c in cols]
    vals = [v.numpy().astype(np.float64) for v in vals]
    x = vt.numpy().astype(np.float64)
    rk = None if rank is None else rank.numpy()
    S = x.shape[1]
    rows_out = zeros + sum(c.shape[0] for c in cols)
    out = np.full((S, rows_out), np.nan)
    writes = np.zeros((S, rows_out), np.int64)
    lanes, rows_warp, F, T = ell_plan(S, align)
    log_lanes = lanes.bit_length() - 1
    stride = (lanes + 1) * F
    top = 0
    for idx, lo, hi, starts in ell_launches([c.shape[0] for c in cols], zeros):
        first, end = (0, rows_out) if rk is not None else (lo, hi)
        tiles, chunks = -(-(end - first) // T), -(-S // (lanes * F))
        for bx in range(tiles):
            for by in range(chunks):
                p0, c0 = first + bx * T, by * lanes * F
                tile = np.full(32 * (ellkernels._MAX_LANES + 1) * F, np.nan)
                for tid in range(THREADS):
                    lane = tid & 31
                    v = lane & (lanes - 1)
                    c = c0 + v * F
                    t = (tid >> 5) * rows_warp + (lane >> log_lanes)
                    while t < T:
                        p = p0 + t
                        if p >= end:
                            break
                        q = rk[p] if rk is not None else p
                        if lo <= q < hi and c < S:
                            acc = np.zeros(F)
                            if q >= zeros:
                                i = sum(1 for j in range(1, len(idx)) if q >= starts[j])
                                g, r = idx[i], q - starts[i]
                                for k in range(cols[g].shape[1]):
                                    acc += vals[g][r, k] * x[cols[g][r, k], c:c + F]
                            if lanes == 1:
                                out[c:c + F, p] = acc
                                writes[c:c + F, p] += 1
                            else:
                                at = t * stride + v * F
                                tile[at:at + F] = acc
                                top = max(top, at + F)
                        t += (THREADS // 32) * rows_warp
                if lanes == 1:
                    continue
                for e in range(0, T * lanes):  # the store loop, every thread's share
                    t, vq = e & (T - 1), e >> (T.bit_length() - 1)
                    p, cq = p0 + t, c0 + vq * F
                    if p >= end or cq >= S:
                        continue
                    if rk is not None and not lo <= rk[p] < hi:
                        continue
                    at = t * stride + vq * F
                    assert not np.isnan(tile[at:at + F]).any(), "a staged slot read unwritten"
                    out[cq:cq + F, p] = tile[at:at + F]
                    writes[cq:cq + F, p] += 1
    return out, writes, top


# (label, group rows, zero rows, with a rank map)
LAYOUTS = {
    "row_groups": ([37, 60, 21], 0, False),       # A x: no map
    "col_groups": ([40, 33, 19, 8], 17, True),    # A^T r: zeros and the rank map
    "one_group": ([90], 0, False),
    "eleven_groups": ([9, 0, 7, 11, 3, 5, 0, 8, 6, 4, 10, 2, 5], 6, True),
    "eleven_groups_unmapped": ([9, 7, 11, 3, 5, 8, 6, 4, 10, 2, 5], 0, False),
    "zeros_only": ([], 23, True),
}


@pytest.mark.parametrize("S", sorted(PLANS))
@pytest.mark.parametrize("layout", ["row_groups", "col_groups"])
def test_kernel_arithmetic_against_the_plain_version(layout, S):
    _check_emulation(layout, S)


@pytest.mark.parametrize("S", [1, 32, 129])
@pytest.mark.parametrize("layout", ["one_group", "eleven_groups", "eleven_groups_unmapped",
                                    "zeros_only"])
def test_kernel_arithmetic_over_launches(layout, S):
    _check_emulation(layout, S)


def _check_emulation(layout, S, n=53):
    rows, zeros, mapped = LAYOUTS[layout]
    rng = np.random.default_rng(S * 31 + len(rows))
    cols, vals = _groups(rows, rng, n)
    total = zeros + sum(rows)
    rank = torch.from_numpy(rng.permutation(total).astype(np.int32)) if mapped else None
    vec = torch.from_numpy(rng.standard_normal((S, n)).astype(np.float32))
    want = TL._ell_product_plain(cols, vals, vec, zeros, rank).numpy()
    got, writes, top = emulate(cols, vals, vec.t().contiguous(), zeros, rank)
    assert (writes == 1).all()
    assert top <= 32 * (ellkernels._MAX_LANES + 1) * ell_plan(S)[2]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(want).max()))


def _no_launch(monkeypatch):
    def refused():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(cudalib, "load", refused)
    bt.reset_launch_counts()


def _args(dtype=torch.float32, idx_dtype=torch.int32):
    rng = np.random.default_rng(0)
    cols = (torch.from_numpy(rng.integers(0, 10, (6, 3)).astype(np.int32)).to(idx_dtype),)
    vals = (torch.randn(6, 3, dtype=dtype),)
    return cols, vals, torch.randn(10, 4, dtype=dtype)


def test_wrapper_refuses_before_any_launch(monkeypatch):
    _no_launch(monkeypatch)
    cols, vals, vt = _args()
    with pytest.raises(ValueError, match="CUDA device"):
        ellkernels.ell_gather_dot(cols, vals, vt)
    with pytest.raises(TypeError, match="float32"):
        ellkernels.ell_gather_dot(*_args(torch.float64))
    with pytest.raises(TypeError, match="int32"):
        ellkernels.ell_gather_dot(*_args(idx_dtype=torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        ellkernels.ell_gather_dot(cols, vals, torch.randn(4, 10).t())
    with pytest.raises(ValueError, match="contiguous"):
        ellkernels.ell_gather_dot((cols[0].t().contiguous().t(),), vals, vt)
    with pytest.raises(ValueError, match="different devices"):
        ellkernels.ell_gather_dot(cols, vals, vt.to("meta"))
    with pytest.raises(ValueError, match="rank"):
        ellkernels.ell_gather_dot(cols, vals, vt, zeros=2,
                                  rank=torch.arange(6, dtype=torch.int32))
    with pytest.raises(ValueError, match="group"):
        ellkernels.ell_gather_dot(cols, (vals[0][:, :2].contiguous(),), vt)
    assert bt.launch_counts()["ell_gather_dot"] == 0


def test_cpu_products_never_reach_the_kernel(monkeypatch):
    """The CPU takes the plain chain, bit for bit as before the kernel."""
    def refused(*a, **k):
        raise AssertionError("the kernel wrapper was called on CPU tensors")

    monkeypatch.setattr(ellkernels, "ell_gather_dot", refused)
    prob = bt.synthetic.medium_sparse(seed=3, num_blocks=60, m=300)
    dp = bt.prepare(bt.synthetic.with_scenarios(prob, 3, seed=2), device="cpu",
                    layout="gather")
    A = dp.A
    assert isinstance(A.mv_cols, tuple) and A.rt_rows is not None
    x = torch.randn(3, dp.n_pf)
    r = torch.randn(3, dp.num_rows)
    want_mv = torch.cat([TL._gather_dot_t(v, c, x.t().contiguous())
                         for c, v in zip(A.mv_cols, A.mv_vals)]).t()
    assert torch.equal(TL.matvec(A, x), want_mv)
    parts = [TL._gather_dot_t(v, c, r.t().contiguous()) for c, v in zip(A.rt_rows, A.rt_vals)]
    if A.rt_zeros:
        parts = [torch.zeros(A.rt_zeros, 3)] + parts
    want_rmv = torch.cat(parts).index_select(0, A.rt_inv).t()
    assert torch.equal(TL.rmatvec(A, r), want_rmv)
    assert torch.equal(TL.matvec(A, x[0]), TL.matvec(A, x[:1])[0])


# ----------------------------------------------------------------- the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m chip on the card)")
    return torch.device("cuda", 0)


def _close(got, want):
    """The kernel's product against the plain version's, relative to the
    largest entry of the plain one."""
    got, want = got.double().cpu(), want.double().cpu()
    assert got.shape == want.shape
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= REL_LIMIT, err
    return err


def _twin(A, device):
    """A device matrix's tensors moved to ``device``, tuples of them too."""
    import dataclasses

    def move(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        if isinstance(v, tuple):
            return tuple(move(u) for u in v)
        return v

    return dataclasses.replace(A, **{f.name: move(getattr(A, f.name))
                                     for f in dataclasses.fields(A) if f.init})


def _hold_products(A, n, m, S, dev, seed=0):
    """matvec and rmatvec of the kernel against the plain chain on the CPU
    twin of ``A``, at S scenarios (and at a single right-hand side for S = 1)."""
    gen = torch.Generator().manual_seed(seed)
    A_cpu = _twin(A, "cpu")
    shapes = [(S,)] + ([()] if S == 1 else [])
    errs = []
    for lead in shapes:
        x = torch.randn(*lead, n, generator=gen)
        r = torch.randn(*lead, m, generator=gen)
        errs.append(_close(TL.matvec(A, x.to(dev)), TL.matvec(A_cpu, x)))
        errs.append(_close(TL.rmatvec(A, r.to(dev)), TL.rmatvec(A_cpu, r)))
    return max(errs)


@pytest.fixture(scope="module")
def medium():
    return bt.synthetic.medium_sparse(seed=0)


@pytest.mark.chip
@pytest.mark.parametrize("S", [1, 32, 128])
def test_medium_row_and_column_groups_on_the_card(card, medium, S):
    dp = bt.prepare(medium, device=card, layout="gather")
    A = dp.A
    assert isinstance(A.mv_cols, tuple) and A.rt_rows is not None and A.rt_zeros > 0
    bt.reset_launch_counts()
    _hold_products(A, dp.n_pf, dp.num_rows, S, card)
    torch.cuda.synchronize()
    # one launch a product: matvec and rmatvec, twice more at S = 1 (1-D)
    assert bt.launch_counts()["ell_gather_dot"] == (4 if S == 1 else 2)


@pytest.mark.chip
def test_stacked_top_through_a_strided_slice_on_the_card(card):
    prob = bt.synthetic.traffic_like(seed=0, num_blocks=3000, m=12000)
    perm = TL.build_pf_perm(prob.partition)
    M = VStackMatrix(top=prob.A, bottom=ScaledMatrix(prob.C, 2.0))
    V = TL.to_device_matrix(M, perm, device=card)
    assert not isinstance(V.top.mv_cols, tuple) and V.top.mv_cols.shape[0] == 1
    gen = torch.Generator().manual_seed(1)
    r = torch.randn(128, V.split + prob.C.shape[0], generator=gen)
    x = torch.randn(128, perm.size, generator=gen)
    V_cpu = TL.to_device_matrix(M, perm, device="cpu")
    _close(TL.rmatvec(V, r.to(card)), TL.rmatvec(V_cpu, r))
    _close(TL.matvec(V, x.to(card)), TL.matvec(V_cpu, x))
    # the top alone, read through the strided slice r[..., :split]
    _close(TL.rmatvec(V.top, r.to(card)[..., :V.split]), TL.rmatvec(V_cpu.top, r[..., :V.split]))


@pytest.mark.chip
def test_column_sharded_local_ell_on_the_card(card):
    prob = bt.synthetic.medium_sparse(seed=3, num_blocks=3000, m=30000)
    part = BlockPartition.from_sizes(prob.partition.sizes, block_multiple=2)
    perm = TL.build_pf_perm(part, 2)
    for shard in ((0, 0), (0, 1)):
        A = TL.to_device_matrix(prob.A, perm, n_shards=2, shard=shard, device=card)
        assert A.rt_rows is None and A.mv_cols.shape[0] == 1
        _hold_products(A, perm.size // 2, prob.A.shape[0], 32, card, seed=shard[1])


@pytest.mark.chip
def test_more_groups_than_one_launch_takes_on_the_card(card):
    rows, zeros, _ = LAYOUTS["eleven_groups"]
    rng = np.random.default_rng(5)
    cols, vals = _groups([r * 400 for r in rows], rng, 5000)
    cols, vals = [c.to(card) for c in cols], [v.to(card) for v in vals]
    total = zeros + sum(c.shape[0] for c in cols)
    rank = torch.from_numpy(rng.permutation(total).astype(np.int32)).to(card)
    for S in (1, 32, 128):
        vec = torch.randn(S, 5000, device=card)
        bt.reset_launch_counts()
        got = TL._ell_product(cols, vals, vec, zeros, rank)
        assert bt.launch_counts()["ell_gather_dot"] == 2
        _close(got, TL._ell_product_plain(cols, vals, vec, zeros, rank))


@pytest.mark.chip
def test_graphed_solve_equals_its_eager_run_and_takes_two_launches_a_step(card, medium):
    from bsls_tpu_torch.solvers import base

    dp = bt.prepare(bt.synthetic.with_scenarios(medium, 32, seed=4), device=card,
                    layout="gather")

    def run(iters):
        return bt.solve(dp, method="pgd", line_search="exact", tol=0.0, max_iter=iters,
                        chunk=100)

    graphed = run(200)
    counts = {}
    for iters in (200, 400):  # from the graph cache: no capture
        bt.reset_launch_counts()
        run(iters)
        counts[iters] = bt.launch_counts()["ell_gather_dot"]
    # two chunks more: each an exact refresh of r (one product) and 100
    # steps of two products
    assert counts[400] - counts[200] == 2 * (1 + 2 * 100)
    program = base.chunk_program
    base.chunk_program = (lambda dp, solver, opts, L_est, steps, state:
                          base.make_chunk_runner(dp, solver, opts, L_est, steps))
    try:
        eager = run(200)
    finally:
        base.chunk_program = program
    assert np.array_equal(graphed.x, eager.x)
    assert np.array_equal(graphed.trace_f, eager.trace_f)
