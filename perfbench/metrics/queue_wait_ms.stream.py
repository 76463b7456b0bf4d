"""Mean milliseconds from a request's ``submit`` to the start of its batch's
solve in ``BatchQueue`` (its result's ``phases["queue.wait"]``), over the
answered requests sent before the profiler's first start
(``harness/phases.py::before_trace``)."""
from harness.phases import before_trace, mean_ms


def read(run):
    return mean_ms(before_trace(run["requests"]), "queue.wait")
