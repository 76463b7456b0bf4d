"""Percent of the lanes that ``BatchQueue`` solved that were padding (a
batch of S requests runs at the next power of two), from each answered
request's ``counts["batch"]`` (S) and ``counts["padded"]``: each request
carries 1/S of its batch's lanes, so the sums run over batches."""


def read(run):
    pad = lanes = 0.0
    for r in run["requests"]:
        counts = getattr(r.get("result"), "counts", None) if r["ok"] else None
        if counts is None or "batch" not in counts:
            continue
        S, S_pad = counts["batch"], counts["padded"]
        pad += (S_pad - S) / S
        lanes += S_pad / S
    return 100.0 * pad / lanes if lanes else None
