"""Percent of the window's iterations that ran through the step kernels of
``ops/stepkernels.py`` (the exact x-space step's passes as three
hand-written kernels): 100 sum(counts["fused_steps"]) / sum(iterations)
over the requests completed in the window; None where no result carries the
counter (a program without the step kernels)."""
from harness.stats import completed_in_window


def read(run):
    done = [r for r in completed_in_window(run["requests"], run["window"])
            if "fused_steps" in getattr(r.get("result"), "counts", {})]
    iters = sum(r["result"].iterations for r in done)
    if not iters:
        return None
    return 100.0 * sum(r["result"].counts["fused_steps"] for r in done) / iters
