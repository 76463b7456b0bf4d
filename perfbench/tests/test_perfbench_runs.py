"""Whole runs of every cell at a tiny size on the CPU: correct with the
program as it is; not correct under the lower-precision control, or with
the timed path broken underneath (a step that returns its state unchanged,
half of a batch left out and filled with the mean of the rest, one answer
altered where it is produced).  A cell on one chip has no exchange between
chips to leave out."""
from dataclasses import replace

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from harness import check, core

CELLS = ["medium.batch128", "traffic_eq.drift128", "medium.stream"]
SEED = 2**31 + 11


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_correct_on_the_cpu(name, trace, cpu_threads):
    cell = tiny_cell(name)
    out = core.run_cell(cell, SEED, 12.0, trace, "cpu", log=lambda *a: None)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(cell.limits)
    want = cell.per_layer if trace else cell.end_to_end
    got = set(out["metrics"])
    # the CPU has no device trace: its readers have nothing to read
    assert {m["name"] for m in want if m["source"] != "device_trace"} <= got
    assert all(out["metrics"][k]["value"] > 0 for k in got)


def _keep_state(dp, st, L_est, opts):
    return st


def _half_batch(solve):
    """Answers for the first half of a batch only; the other half gets the
    mean of those."""
    def wrapped(self, b, *a, **k):
        res = solve(self, b, *a, **k)
        x, f = np.array(res.x, copy=True), np.array(res.objective, copy=True)
        if x.ndim == 1 or x.shape[0] < 2:
            return res
        h = x.shape[0] // 2
        x[h:] = x[:h].mean(0)
        f[h:] = f[:h].mean()
        return replace(res, x=x, objective=f)
    return wrapped


def _altered(solve):
    def wrapped(self, b, *a, **k):
        res = solve(self, b, *a, **k)
        x = np.array(res.x, copy=True)
        row = x if x.ndim == 1 else x[-1]
        row[[0, 1]] = row[[1, 0]] + np.array([0.25, -0.25])  # moved within block 0's sum
        return replace(res, x=x)
    return wrapped


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch, cpu_threads):
    import bsls_tpu_torch.serving as serving
    import bsls_tpu_torch.solvers.pgd as pgd

    if fault == "state_unchanged":
        monkeypatch.setattr(pgd, "step", _keep_state)
    elif fault == "half_batch":
        monkeypatch.setattr(serving.Endpoint, "solve", _half_batch(serving.Endpoint.solve))
    else:
        monkeypatch.setattr(serving.Endpoint, "solve", _altered(serving.Endpoint.solve))
    out = core.run_cell(tiny_cell(name), SEED, 1.5, False, "cpu", log=lambda *a: None)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_control_is_not_correct(name, cpu_threads):
    from control import control_answers

    cell = tiny_cell(name)
    dev = torch.device("cpu")
    inst, pool = core.inputs(cell, SEED, dev, 2)
    answers = control_answers(cell, inst, pool, 2, "bfloat16", dev)
    values = check.numbers(cell.config["reference"], inst, cell.traffic, pool, answers, SEED, dev)
    correct, table = check.judge(values, cell.limits)
    assert not correct, table
    # the same answers in float64 are correct: the comparison, not the harness, fails them
    answers = control_answers(cell, inst, pool, 2, "float64", dev)
    values = check.numbers(cell.config["reference"], inst, cell.traffic, pool, answers, SEED, dev)
    assert check.judge(values, cell.limits)[0], values
