"""Mean megabytes (10^6 bytes) that a request's equality-constrained loop
copies between host and device, from the program's counter
``counts["eq_host_bytes"]`` (b, d, the warm start, each outer's penalty
scale and violation, the final x and multipliers), over the requests
completed in the window; None where no result carries the counter."""
from harness.stats import completed_in_window


def read(run):
    got = [r["result"].counts["eq_host_bytes"]
           for r in completed_in_window(run["requests"], run["window"])
           if "eq_host_bytes" in getattr(r.get("result"), "counts", {})]
    return 1e-6 * sum(got) / len(got) if got else None
