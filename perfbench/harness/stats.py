"""Arithmetic of the end-to-end metrics."""
from __future__ import annotations

import math

__all__ = ["completed_in_window", "rate_over_span", "percentile"]


def completed_in_window(requests: list, window: tuple) -> list:
    """The requests that ended, answered, before the window closed."""
    return [r for r in requests if r["ok"] and r["end"] is not None and r["end"] <= window[1]]


def rate_over_span(requests: list, work) -> float | None:
    """Work of the requests over the time they spanned, from the first
    one's start to the last one's end; None without a completed request."""
    if not requests:
        return None
    span = max(r["end"] for r in requests) - min(r["start"] for r in requests)
    return sum(work(r) for r in requests) / span if span > 0 else None


def percentile(values: list, q: float) -> float | None:
    """The nearest-rank q-quantile (q in (0, 1]) of ``values`` (a failed or
    unanswered request enters past any limit: ``drive.latencies``); None for
    no values."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(math.ceil(q * len(ordered)) - 1, 0)]
