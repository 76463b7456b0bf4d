"""Percent of the slots that a step's two ELL products read that are
padding: 100 (1 - gather_nnz / gather_slots) from the answered requests'
``counts`` (the layout's static counts, ``ops/layout.py::gather_counts``);
None where no result carries them."""


def read(run):
    nnz = slots = 0
    for r in run["requests"]:
        counts = getattr(r.get("result"), "counts", None) if r["ok"] else None
        if not counts or "gather_slots" not in counts:
            continue
        nnz += counts["gather_nnz"]
        slots += counts["gather_slots"]
    return 100.0 * (1.0 - nnz / slots) if slots else None
