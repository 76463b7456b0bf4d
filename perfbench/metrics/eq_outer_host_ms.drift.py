"""Milliseconds of host work after an outer's inner solve (``eq.host``:
C x in float64, the multiplier and penalty update, the stop test), summed
over the requests completed in the window and divided by their outers
(``counts["outers"]``), from the program's spans, every request counted."""
from harness.phases import carrying
from harness.stats import completed_in_window


def read(run):
    got = carrying(completed_in_window(run["requests"], run["window"]), ["eq.host"])
    outers = sum(r["result"].counts.get("outers", 0) for r in got)
    return 1e3 * sum(r["result"].phases["eq.host"] for r in got) / outers if outers else None
