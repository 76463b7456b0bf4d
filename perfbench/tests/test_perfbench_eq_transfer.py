"""The reader of the equality-constrained loop's transfer counter: the mean
over the window's answered requests, and None from results without the
counter (a program that does not count it)."""
from types import SimpleNamespace

import pytest

from harness.core import load_reader


def _req(end, counts=None, ok=True):
    res = SimpleNamespace(iterations=1200, phases={"eq.host": 0.01})
    if counts is not None:
        res.counts = counts
    return {"start": end - 1.0, "end": end, "due": end - 1.0, "ok": ok, "result": res,
            "traced": False}


def test_eq_transfer_mb_is_the_window_mean_of_the_counter():
    read = load_reader("metrics", "eq_transfer_mb.drift").read
    reqs = [_req(1.0, {"outers": 3, "eq_host_bytes": 87_000_000}),
            _req(2.0, {"outers": 3, "eq_host_bytes": 89_000_000}),
            _req(9.0, {"outers": 3, "eq_host_bytes": 1}),  # ended after the close
            _req(3.0, ok=False)]
    assert read({"requests": reqs, "window": (0.0, 5.0)}) == pytest.approx(88.0)
    # a program without the counter: counts without it, or no counts at all
    bare = [_req(1.0, {"outers": 3}), _req(2.0)]
    assert read({"requests": bare, "window": (0.0, 5.0)}) is None
