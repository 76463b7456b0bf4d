"""Milliseconds of chunk loop per iteration, ``sum(chunk_times) /
iterations`` over the requests completed in the window (taken in the traced
run, where the profiler slows the one traced request)."""
from harness.stats import completed_in_window


def read(run):
    done = completed_in_window(run["requests"], run["window"])
    iters = sum(r["result"].iterations for r in done)
    return 1e3 * sum(float(sum(r["result"].chunk_times)) for r in done) / iters if iters else None
