"""The reader of the step kernels' counter, ``fused_step_share.batch``: the
share of the window's iterations that ran through them, and None from
results without the counter (a program without the step kernels)."""
from types import SimpleNamespace

import pytest

from harness.core import Cell, load_reader


def _req(end, iterations=500, counts=None, ok=True):
    res = SimpleNamespace(iterations=iterations, chunk_times=[0.1] * 5)
    if counts is not None:
        res.counts = counts
    return {"start": end - 1.0, "end": end, "due": end - 1.0, "ok": ok, "result": res,
            "traced": False}


def _read(reqs, window=(0.0, 5.0)):
    return load_reader("metrics", "fused_step_share.batch").read(
        {"requests": reqs, "window": window})


def test_fused_step_share_is_the_share_of_the_window_iterations():
    reqs = [_req(1.0, counts={"chunks": 5, "fused_steps": 500}),
            _req(2.0, counts={"chunks": 5, "fused_steps": 500})]
    assert _read(reqs) == pytest.approx(100.0)
    # a request of the chain counts its iterations and no fused step
    reqs.append(_req(3.0, counts={"chunks": 5, "fused_steps": 0}))
    assert _read(reqs) == pytest.approx(200.0 / 3)
    # requests after the window's close and failed ones are left out
    reqs += [_req(9.0, counts={"chunks": 5, "fused_steps": 0}),
             _req(4.0, counts={"chunks": 5, "fused_steps": 0}, ok=False)]
    assert _read(reqs) == pytest.approx(200.0 / 3)


def test_fused_step_share_is_none_without_the_counter():
    assert _read([_req(1.0, counts={"chunks": 5}), _req(2.0)]) is None
    assert _read([]) is None


def test_fused_step_share_is_a_metric_of_the_batch_cell():
    cell = Cell("medium.batch128")
    m = {m["name"]: m for m in cell.per_layer}["fused_step_share.batch"]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "%", "higher", "program_counter", "iters_per_s")
    assert "fused_step_share.batch" not in {m["name"] for m in Cell("large.batch4").per_layer}
