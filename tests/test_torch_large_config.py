"""Config 4's shape (``perfbench/configs/large.json``: blocks of width 8,
routes of 6 distinct links, links of more than 128 routes on average) served
through ``Endpoint`` at S = 4 on the CPU against the benchmark's plain
float64 reference (``perfbench/reference/pgd.py``), the layout's static
counters (``gather_slots``, ``gather_nnz``) against its groups counted by
hand, and the build's spans (``Endpoint.build_phases``).

The instance is drawn by the benchmark's own generator
(``perfbench/harness/instances.py``) at 6,400 blocks over 2,048 links: 150
nonzeros a row on average (the cell has 183), so the row layout has the
cell's two groups (the few rows of at most 128 nonzeros, then one group as
wide as the widest row), and its routes span more than the banded layout's
window of 8 pages of 128 rows, so ``layout="auto"`` tries the band at S = 4
and refuses it, as at full size.  Both benchmark modules are loaded by path
and import nothing of the program."""
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bsls_tpu_torch as bt
from bsls_tpu_torch.solvers.base import power_lipschitz
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

BENCH = Path(__file__).resolve().parents[1] / "perfbench"
SEED = 2**31 + 4099
# (generator overrides, scenarios): config 4's shape, and medium's, cut to a CPU's size
SHAPES = {"large": ({"num_blocks": 6400, "m": 2048}, 4),
          "medium": ({"num_blocks": 300, "m": 3000}, 16)}
ITERS, CHUNK = 200, 100


def _load(rel: str):
    name = "perfbench_" + rel[:-3].replace("/", "_")
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, BENCH / rel)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod  # before it runs: its dataclasses look their module up
        spec.loader.exec_module(mod)
    return sys.modules[name]


RP = _load("reference/pgd.py")
INST = _load("harness/instances.py")


def _instance(shape: str):
    overrides, S = SHAPES[shape]
    params = {**json.loads((BENCH / "configs" / f"{shape}.json").read_text())["generator"],
              **overrides}
    inst = INST.make_instance(params, SEED)
    X = INST.planted_flows(inst, S, torch.Generator().manual_seed(SEED))
    B = INST.apply_A(inst, X)
    B += 0.01 * torch.randn(B.shape, generator=torch.Generator().manual_seed(SEED + 1),
                            dtype=B.dtype)
    return inst, B.float().numpy()


def _endpoint(inst, B):
    A = bt.EllMatrix(rows=inst.rows, vals=inst.vals, num_rows=inst.m)
    prob = bt.Problem(A=A, b=B, partition=bt.BlockPartition.from_sizes(inst.sizes))
    return bt.Endpoint(prob, method="pgd", line_search="exact", chunk=CHUNK, device="cpu")


@pytest.fixture(scope="module")
def large():
    inst, B = _instance("large")
    ep = _endpoint(inst, B)
    return inst, B, ep, ep.solve(B, tol=0.0, max_iter=ITERS)


def _reference(inst, B, L_u=None):
    """The reference's x (S, n) and objectives after ITERS steps: with its own
    exact bound, or with ``L_u`` (the program's)."""
    if L_u is None:
        return RP.solve(inst.rows, inst.vals, inst.m, inst.sizes, B, ITERS, CHUNK, "cpu")
    c = RP.block_scales((inst.vals ** 2).sum(1), inst.sizes)
    c_col = np.repeat(c, inst.sizes)
    op = RP.Operator(inst.rows, inst.vals, inst.m, c_col, torch.float64, "cpu")
    blocks = RP.Blocks(inst.sizes, c, "cpu", torch.float64)
    U0 = torch.as_tensor(np.tile(c_col / np.repeat(inst.sizes, inst.sizes), (B.shape[0], 1)))
    U, R = RP.pgd_exact(op, blocks, torch.as_tensor(B, dtype=torch.float64), U0, L_u, ITERS,
                        CHUNK)
    X = RP.project(U, blocks) / torch.as_tensor(c_col)
    return X.numpy(), (0.5 * (R * R).sum(-1)).numpy()


def test_the_layout_is_the_cells(large):
    inst, _, ep, _ = large
    A = ep._dp.A
    assert isinstance(A, bt.ops.layout.DeviceEll)  # the band was tried and refused
    assert set(ep.build_phases) == {"prepare", "prepare.band", "prepare.layout",
                                    "prepare.upload"}
    widths = [c.shape[1] for c in A.mv_cols]
    assert len(widths) == 2 and widths[0] == 128 and widths[1] > 128
    # every route has 6 links: the plain column-ELL, no padding on that side
    assert A.rt_rows is None and tuple(A.rows.shape) == (inst.n, 6)


def _floor(inst, B) -> np.ndarray:
    """float32's floor of each scenario's objective: r = A x - b rounded to
    half an ulp of |b| in every row, 0.5 m (u max|b|)^2.  Routes of 6 links
    over 25 times as many columns as rows fit b nearly exactly, so f* is of
    this size (as in the cell) and objectives are compared against it."""
    u = np.finfo(np.float32).eps / 2
    return 0.5 * inst.m * (u * np.abs(B).max(1)) ** 2


def test_served_x_follows_the_reference_step_for_step(large):
    """With the program's own step bound the reference takes the same
    steps: the float32 x stays within 1e-4 of the float64 one (4e-6 read:
    the trajectories' rounding, far below the 1e-2 moves of a step that
    went another way)."""
    inst, B, ep, res = large
    Xr, _ = _reference(inst, B, power_lipschitz(ep._dp))
    assert np.abs(res.x - Xr).max() < 1e-4


def test_served_answer_passes_the_benchmark_check(large):
    """The cell's comparison at this size: blocks on their simplex (float32
    sums of 8 entries), and the float64 objective at x within 4 floors of
    the reference's with its exact bound 1.05 ||A_u||^2 (0.9 read), the
    reported one (the running float32 residual) within 8 floors of it (2.2
    read)."""
    inst, B, _, res = large
    objective = RP.Objective(inst.rows, inst.vals, inst.m, "cpu")
    f64, floor = objective(res.x, B), _floor(inst, B)
    Xr, _ = _reference(inst, B)
    assert RP.simplex_error(res.x, inst.sizes) < 1e-6
    assert np.all(f64 - objective(Xr, B) < 4 * floor)
    assert np.all(np.abs(res.objective - f64) < 8 * floor)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_layout_counts_are_its_groups_counted_by_hand(shape):
    inst, B = _instance(shape)
    ep = _endpoint(inst, B)
    res = ep.solve(B, tol=0.0, max_iter=CHUNK)
    A = ep._dp.A
    ax_groups = list(zip(A.mv_cols, A.mv_vals))
    atr_groups = list(zip(A.rt_rows, A.rt_vals)) if A.rt_rows is not None else [(A.rows, A.vals)]
    slots = sum(c.shape[0] * c.shape[1] for c, _ in ax_groups + atr_groups)
    assert res.counts["gather_slots"] == slots == A.gather_slots
    assert res.counts["gather_nnz"] == 2 * inst.nnz
    # the counted nonzeros are the ones the products' groups hold
    for groups in (ax_groups, atr_groups):
        assert sum(int(torch.count_nonzero(v)) for _, v in groups) == inst.nnz
    assert bt.ops.layout.gather_counts(A) == {"gather_slots": slots,
                                              "gather_nnz": 2 * inst.nnz}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_build_phases_nest_under_prepare(shape):
    inst, B = _instance(shape)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        ep = _endpoint(inst, B)
    names = [e.name for e in prof.events() if e.name.startswith("bsls.prepare")]
    parts = ["prepare.layout", "prepare.upload"]
    if SHAPES[shape][1] < 16:
        parts.insert(0, "prepare.band")  # auto tries the band below 16 scenarios
    assert sorted(names) == sorted(["bsls.prepare"] + [f"bsls.{p}" for p in parts])
    assert list(ep.build_phases) == parts + ["prepare"]
    assert sum(ep.build_phases[p] for p in parts) <= ep.build_phases["prepare"]
