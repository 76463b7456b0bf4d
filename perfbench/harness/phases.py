"""Arithmetic of the readers of the program's own spans and counters: the
``phases`` (host seconds by ``bsls.*`` span) and ``counts`` that each
request's result carries, and the traced window's idle time that no span
of the program, no aten op and no runtime call covers.  A result without
them, from a program that has no such spans, gives None."""
from __future__ import annotations

__all__ = ["before_trace", "carrying", "mean_ms", "unattributed_percent"]


def before_trace(requests: list) -> list:
    """The requests sent before the first traced one (all of them in a run
    with none traced).  An open loop's profiler starts and stops once the
    requests in flight are answered, which holds the generator back; the
    burst it then sends leaves a backlog that drains for the rest of the
    window, so the queue after the profiler's first start is not the
    cell's."""
    first = next((i for i, r in enumerate(requests) if r["traced"]), len(requests))
    return requests[:first]


def carrying(requests: list, names) -> list:
    """The answered requests whose results carry every phase of ``names``."""
    return [r for r in requests
            if r["ok"] and all(n in getattr(r.get("result"), "phases", {}) for n in names)]


def mean_ms(requests: list, *names) -> float | None:
    """Mean milliseconds of the phases ``names``, summed, over the requests
    that carry them; None where none does."""
    got = carrying(requests, names)
    if not got:
        return None
    return 1e3 * sum(r["result"].phases[n] for r in got for n in names) / len(got)


def unattributed_percent(run) -> float | None:
    """Percent of the traced window in the idle gaps labelled ``host`` (no
    host event at the gap's midpoint) or by a span of the benchmark's own
    (``bench.*``): no span of the program, aten op or runtime call covers
    them.  Only the labelled gaps count: the bucket of the shorter ones
    (``(each shorter gap)``) has no label and is left out, as are the labels
    past the summary's ten largest."""
    tr = run["trace"]
    if not tr or not tr["busy_s"] or tr["window_s"] <= 0:
        return None
    secs = sum(s for label, s in tr["idle_gaps"] if label == "host" or label.startswith("bench."))
    return 100.0 * secs / tr["window_s"]
