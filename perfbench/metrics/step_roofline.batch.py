"""Share of the HBM roofline of a PGD step: the bytes one step needs
(``counts/step_bytes.py``) over 3.35 TB/s, against the device-busy time per
iteration of the traced request (the union of its kernel intervals, power
iteration and uploads included, over its iterations)."""
from counts.step_bytes import step_bytes


def read(run):
    tr = run["trace"]
    iters = sum(r["result"].iterations for r in run["requests"] if r["traced"] and r["ok"])
    if not tr or not tr["busy_s"] or not iters:
        return None
    bound_s = step_bytes(run["shapes"]) / run["peaks"]["hbm_bytes_per_s"]
    return 100.0 * bound_s / (tr["busy_s"] / iters)
