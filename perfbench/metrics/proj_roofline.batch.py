"""Share of the HBM roofline of the projection kernel
(``csrc/proj_simplex_rows.cu``'s ``proj_buckets_kernel``, by name in the
trace): its launches times the bytes one projection needs
(``counts/proj_bytes.py``) over 3.35 TB/s, against its device time."""
from counts.proj_bytes import proj_bytes


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    launches = secs = 0
    for name, (count, s) in tr["kernels"].items():
        if "proj_buckets_kernel" in name:
            launches, secs = launches + count, secs + s
    if not launches or secs <= 0:
        return None
    return 100.0 * launches * proj_bytes(run["shapes"]) / run["peaks"]["hbm_bytes_per_s"] / secs
