"""The harness's arithmetic: rates, percentiles, spreads, the idle union,
byte counts and the import check."""
import math
from types import SimpleNamespace

import pytest
import torch

from counts.proj_bytes import proj_bytes
from counts.step_bytes import step_bytes
from harness import core, drive, readers, stats, trace


def _req(start, end, ok=True, due=None):
    return {"start": start, "end": end, "ok": ok, "due": start if due is None else due}


def test_rate_over_the_span_of_completed_requests():
    reqs = [_req(0.0, 1.0), _req(1.0, 2.5), _req(2.5, 4.0), _req(4.0, 9.0)]
    done = stats.completed_in_window(reqs, (0.0, 5.0))
    assert len(done) == 3  # the last one ended after the close
    assert stats.rate_over_span(done, lambda r: 10) == pytest.approx(30 / 4.0)
    assert stats.rate_over_span([], lambda r: 1) is None


def test_failed_request_is_not_completed():
    reqs = [_req(0.0, 1.0), _req(1.0, 2.0, ok=False)]
    assert stats.completed_in_window(reqs, (0.0, 5.0)) == reqs[:1]


@pytest.mark.parametrize("values,q,want", [
    ([1, 2, 3, 4, 5, 6, 7, 8, 9, 10], 0.95, 10),
    (list(range(1, 101)), 0.95, 95),
    ([3.0], 0.95, 3.0),
    ([1, math.inf, 2, 3], 0.5, 2),
])
def test_nearest_rank_percentile(values, q, want):
    assert stats.percentile(values, q) == want


def test_percentile_counts_failures_as_missing_the_limit():
    reqs = [_req(0.0, 0.1 * (i + 1)) for i in range(18)]
    reqs += [{"start": 0.0, "end": None, "ok": False, "due": 0.0},
             {"start": 0.0, "end": 0.05, "ok": False, "due": 0.0}]
    lat = drive.latencies(reqs, deadline=100.0)
    assert sorted(lat)[-2:] == [100.0, 100.0]
    assert stats.percentile(lat, 0.95) == 100.0  # 2 of 20 failed: above the 95th rank
    assert stats.percentile(lat[:18], 0.95) == pytest.approx(1.8)


@pytest.mark.parametrize("spans,want", [
    ([(0, 2), (1, 3), (5, 6)], 4),
    ([(5, 6), (0, 1)], 2),
    ([(0, 10), (2, 3), (4, 5)], 10),
    ([], 0),
])
def test_union_of_kernel_intervals(spans, want):
    assert trace.union(spans) == want


def _event(name, s, e, cuda):
    kind = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind, time_range=SimpleNamespace(start=s, end=e))


def test_summary_busy_kernels_and_labelled_gaps():
    events = [_event("k1", 0, 100, True), _event("k2", 50, 150, True), _event("k1", 400, 500, True),
              _event("bench.request", 0, 1000, True),  # the span's shadow on the device
              _event("bench.request", 0, 1000, False), _event("cudaStreamSynchronize", 160, 390, False)]
    s = trace.summarise(events, window_s=1e-3)
    assert s["busy_s"] == pytest.approx(250e-6)
    assert s["kernels"]["k1"] == [2, pytest.approx(200e-6)]
    assert s["device_ops"][0][0] == "k1"
    assert s["idle_gaps"] == [["cudaStreamSynchronize", pytest.approx(250e-6)]]
    run = {"trace": s}
    assert readers.idle_percent(run) == pytest.approx(75.0)


def test_step_bytes_by_hand():
    # 2 scenarios, 3 columns, 4 rows, 5 nonzeros: A twice (values and int32
    # indices), x and r each read once and written once in float32
    shapes = {"S": 2, "n": 3, "m": 4, "nnz": 5, "blocks": 1}
    assert step_bytes(shapes) == 2 * 5 * 8 + 2 * 2 * 4 * (3 + 4)


def test_proj_bytes_by_hand():
    shapes = {"S": 2, "n": 7, "m": 4, "nnz": 5, "blocks": 3}
    assert proj_bytes(shapes) == 2 * 7 * 4 * 2 + 3 * 4


def test_roofline_readers_stay_under_100_at_the_bound():
    from harness.core import load_reader

    shapes = {"S": 128, "n": 55_000, "m": 100_000, "nnz": 440_000, "blocks": 10_000}
    peaks = {"hbm_bytes_per_s": 3.35e12}
    bound = step_bytes(shapes) / peaks["hbm_bytes_per_s"]
    res = SimpleNamespace(iterations=500)
    run = {"trace": {"busy_s": 500 * bound, "window_s": 1.0, "kernels": {
        "void proj_buckets_kernel<2>(...)": [501, 501 * proj_bytes(shapes) / 3.35e12]}},
        "requests": [{"traced": True, "ok": True, "result": res}], "shapes": shapes, "peaks": peaks}
    assert load_reader("metrics", "step_roofline.batch").read(run) == pytest.approx(100.0)
    assert load_reader("metrics", "proj_roofline.batch").read(run) == pytest.approx(100.0)
    run["trace"]["kernels"] = {}
    assert load_reader("metrics", "proj_roofline.batch").read(run) is None


@pytest.mark.parametrize("mods,want", [
    (["bsls_tpu_torch", "bsls_tpu_torch.ops.layout", "numpy"], []),
    (["bsls_tpu", "bsls_tpu_torch"], ["bsls_tpu"]),
    (["bsls_tpu.ops.layout"], ["bsls_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "bsls_tpu_extra", "flaxen"], []),
])
def test_forbidden_modules_compare_top_level_names_whole(mods, want):
    assert core.forbidden_modules(mods) == want
