"""The readers of the program's spans and counters on synthetic runs: each
reads what the results carry, and None from results without ``phases`` or
``counts`` (a program that has no such spans)."""
from types import SimpleNamespace

import pytest

from harness.core import load_reader


def _req(end, phases=None, counts=None, ok=True, traced=False):
    res = SimpleNamespace(iterations=500)
    if phases is not None:
        res.phases, res.counts = phases, counts or {}
    return {"start": end - 1.0, "end": end, "due": end - 1.0, "ok": ok, "result": res,
            "traced": traced}


def _read(name, run):
    return load_reader("metrics", name).read(run)


@pytest.mark.parametrize("name,key", [("power_ms.batch", "power"), ("upload_ms.batch", "upload"),
                                      ("result_ms.batch", "result")])
def test_request_phase_means_over_the_window(name, key):
    reqs = [_req(1.0, {key: 0.030}), _req(2.0, {key: 0.010}), _req(9.0, {key: 1.0}),
            _req(3.0, ok=False)]
    run = {"requests": reqs, "window": (0.0, 5.0)}
    assert _read(name, run) == pytest.approx(20.0)  # the third ended after the close
    assert _read(name, {"requests": [_req(1.0)], "window": (0.0, 5.0)}) is None


def test_eq_host_readers_leave_the_records_out():
    phases = {"eq.setup": 0.1, "eq.host": 0.3, "eq.record": 5.0, "eq.report": 0.05, "chunks": 6.0}
    reqs = [_req(1.0, phases, {"outers": 3}), _req(2.0, {**phases, "eq.host": 0.1}, {"outers": 2})]
    run = {"requests": reqs, "window": (0.0, 5.0)}
    assert _read("eq_host_ms_per_request.drift", run) == pytest.approx(
        1e3 * ((0.45) + (0.25)) / 2)
    assert _read("eq_outer_host_ms.drift", run) == pytest.approx(1e3 * 0.4 / 5)
    bare = {"requests": [_req(1.0), _req(2.0)], "window": (0.0, 5.0)}
    assert _read("eq_host_ms_per_request.drift", bare) is None
    assert _read("eq_outer_host_ms.drift", bare) is None


def test_queue_wait_and_pad_share_run_over_batches():
    # one batch of 3 padded to 4, one of 1, one of 5 padded to 8 (a request lost)
    reqs = ([_req(1.0, {"queue.wait": 0.02}, {"batch": 3, "padded": 4}) for _ in range(3)]
            + [_req(1.0, {"queue.wait": 0.06}, {"batch": 1, "padded": 1})]
            + [_req(1.0, {"queue.wait": 0.01}, {"batch": 5, "padded": 8}) for _ in range(5)]
            + [_req(1.0, ok=False)])
    run = {"requests": reqs, "window": (0.0, 1.0, 2.0)}
    assert _read("queue_wait_ms.stream", run) == pytest.approx(1e3 * (0.06 + 0.06 + 0.05) / 9)
    assert _read("pad_share.stream", run) == pytest.approx(100.0 * (1 + 0 + 3) / (4 + 1 + 8))
    # from the first traced request on, the profiler's pauses shape the wait
    run["requests"] = reqs[:4] + [_req(1.0, {"queue.wait": 9.0}, {"batch": 1, "padded": 1},
                                       traced=True)] + reqs[4:]
    assert _read("queue_wait_ms.stream", run) == pytest.approx(1e3 * 0.12 / 4)
    assert _read("pad_share.stream", run) == pytest.approx(100.0 * (1 + 0 + 3) / (4 + 2 + 8))
    bare = {"requests": [_req(1.0)], "window": (0.0, 1.0, 2.0)}
    assert _read("queue_wait_ms.stream", bare) is None
    assert _read("pad_share.stream", bare) is None


@pytest.mark.parametrize("name", ["idle_unattributed.batch", "idle_unattributed.drift",
                                  "idle_unattributed.stream"])
def test_unattributed_idle_is_the_host_and_bench_labels(name):
    gaps = [["cudaGraphLaunch", 0.04], ["bench.request", 0.3], ["host", 0.1],
            ["bsls.eq.host", 0.2], ["(each shorter gap)", 0.05]]
    run = {"trace": {"busy_s": 5.0, "window_s": 8.0, "idle_gaps": gaps}}
    assert _read(name, run) == pytest.approx(100.0 * 0.4 / 8.0)
    run["trace"]["idle_gaps"] = gaps[:1] + gaps[3:]
    assert _read(name, run) == 0.0
    assert _read(name, {"trace": None}) is None
    assert _read(name, {"trace": {"busy_s": 0.0, "window_s": 1.0, "idle_gaps": []}}) is None
