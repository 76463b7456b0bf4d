"""The cell ``large.batch4`` (config 4, 1M blocks of width 8 at S = 4): it
resolves by name with its metrics, its generator gives every seed the same
multisets at a reduced scale, and its five readers read synthetic run
records (None where a program has no counters or spans, as before the
layout's counters existed)."""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from harness import core, instances

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "large.batch4"
METRICS = ["step_ms.batch4", "step_roofline.batch4", "gather_pad_share.batch4",
           "device_idle.batch4", "request_overhead_ms.batch4"]


def _read(name, run):
    return core.load_reader("metrics", name).read(run)


def _req(end, chunk_times=(0.7, 0.7), iterations=200, host_s=1.6, counts=None, ok=True,
         traced=False):
    res = SimpleNamespace(iterations=iterations, chunk_times=list(chunk_times), host_s=host_s)
    if counts is not None:
        res.counts = counts
    return {"start": end - 1.0, "end": end, "due": end - 1.0, "ok": ok, "result": res,
            "traced": traced}


def test_the_cell_resolves_with_its_metrics():
    cell = core.Cell(CELL)
    assert cell.chips == 1
    assert [m["name"] for m in cell.end_to_end] == ["iters_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == METRICS
    assert {m["moves"] for m in cell.per_layer} == {"iters_per_s"}
    assert cell.config["reference"] == "pgd" and cell.config["reduced"] == []
    assert cell.traffic["scenarios"] == 4 and cell.traffic["loop"] == "closed"
    assert set(cell.limits) <= {"simplex_err", "obj_err", "obj_ratio"}
    for m in cell.end_to_end + cell.per_layer:
        assert callable(core.load_reader("metrics", m["name"]).read)


def test_the_generator_gives_every_seed_the_same_multisets():
    """At 1/200 of the blocks and 1/32 of the links (the rows then hold 35
    nonzeros on average, against 183): block sizes and route lengths are the
    same multisets for every seed, in another order, and so are the links'
    route counts but for a rare seed, where ``instances._links``' swap of a
    repeated link (not a permutation when its random partner repeats or is
    itself repeated) moves one route slot from a link to another: the first
    seed here is one."""
    params = json.load(open(os.path.join(BENCH, "configs", "large.json")))["generator"]
    params = {**params, "num_blocks": 5000, "m": 8192}
    seen = []
    for seed in (2**31 + 3, 2**33 + 1, 7):
        inst = instances.make_instance(params, seed)
        nz = inst.vals != 0
        assert inst.n == 8 * 5000 and inst.nnz == 6 * inst.n
        r = np.sort(inst.rows, axis=1)
        assert not (r[:, 1:] == r[:, :-1]).any()  # a route's links are distinct
        seen.append((np.sort(inst.sizes), np.sort(nz.sum(1)),
                     np.sort(np.bincount(inst.rows[nz], minlength=inst.m)), inst.rows[nz][:50]))
    for sizes, lens, links, draw in seen[1:]:
        np.testing.assert_array_equal(sizes, seen[0][0])
        np.testing.assert_array_equal(lens, seen[0][1])
        np.testing.assert_array_equal(links, seen[2][2])
        assert not np.array_equal(draw, seen[0][3])  # the draws themselves differ
    moved = np.abs(seen[0][2] - seen[2][2])
    assert moved.sum() <= 2 and moved.max() <= 1


def test_step_readers_are_the_batch_cells():
    reqs = [_req(1.0, (0.7, 0.7), 200), _req(2.0, (0.5, 0.5, 0.5), 300), _req(9.0)]
    run = {"requests": reqs, "window": (0.0, 5.0)}
    for name in ("step_ms", "request_overhead_ms"):
        assert _read(f"{name}.batch4", run) == _read(f"{name}.batch", run)
    assert _read("step_ms.batch4", run) == pytest.approx(1e3 * 2.9 / 500)
    assert _read("request_overhead_ms.batch4", run) == pytest.approx(1e3 * (0.2 + 0.1) / 2)


def test_roofline_and_idle_read_the_trace():
    shapes = {"S": 4, "n": 8_000_000, "m": 262_144, "nnz": 48_000_000}
    peaks = json.load(open(os.path.join(BENCH, "peaks.json")))
    traced = _req(1.0, iterations=500, traced=True)
    run = {"requests": [traced, _req(2.0)], "shapes": shapes, "peaks": peaks,
           "trace": {"busy_s": 3.5, "window_s": 3.7, "idle_gaps": []}}
    step_bytes = 2 * 48_000_000 * 8 + 2 * 4 * 4 * (8_000_000 + 262_144)  # 1.032 GB
    want = 100 * (step_bytes / peaks["hbm_bytes_per_s"]) / (3.5 / 500)
    assert _read("step_roofline.batch4", run) == pytest.approx(want)
    assert _read("device_idle.batch4", run) == pytest.approx(100 * 0.2 / 3.7)
    for name in ("step_roofline.batch4", "device_idle.batch4"):
        assert _read(name, {**run, "trace": None}) is None


def test_gather_pad_share_reads_the_layouts_counts():
    counts = {"chunks": 5, "captures": 0, "gather_slots": 112_487_306,
              "gather_nnz": 96_000_000}
    reqs = [_req(1.0, counts=counts), _req(2.0, counts=counts), _req(3.0, ok=False)]
    run = {"requests": reqs, "window": (0.0, 5.0)}
    assert _read("gather_pad_share.batch4", run) == pytest.approx(
        100 * (1 - 96_000_000 / 112_487_306))
    # a program without the counters (counts without them, or no counts)
    bare = {"requests": [_req(1.0, counts={"chunks": 5, "captures": 0}), _req(2.0)],
            "window": (0.0, 5.0)}
    assert _read("gather_pad_share.batch4", bare) is None


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_correct_on_the_cpu_and_its_control_does_not(trace, cpu_threads):
    """The cell cut to a CPU's size (``conftest.tiny_cell``): its run is
    correct and reports its metrics but the device trace's; the reference
    in bfloat16 in the program's place is not correct (by ``simplex_err``)."""
    import torch

    from conftest import tiny_cell
    from control import control_answers
    from harness import check

    cell = tiny_cell(CELL)
    out = core.run_cell(cell, 2**31 + 11, 6.0, trace, "cpu", log=lambda *a: None)
    assert out["correct"] and out["failed"] == 0, out["checks"]
    want = cell.per_layer if trace else cell.end_to_end
    assert {m["name"] for m in want if m["source"] != "device_trace"} == set(out["metrics"])
    dev = torch.device("cpu")
    inst, pool = core.inputs(cell, 2**31 + 12, dev, 2)
    answers = control_answers(cell, inst, pool, 2, "bfloat16", dev)
    values = check.numbers("pgd", inst, cell.traffic, pool, answers, 2**31 + 12, dev)
    correct, table = check.judge(values, cell.limits)
    assert not correct and table["simplex_err"][0] > table["simplex_err"][1], table
