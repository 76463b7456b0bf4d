"""HBM bytes that one projection of every block onto its simplex needs: the
(S, n) float32 values read once and written once, and each block's radius
read once.  Counted on the instance's n, not on the program's padded
buckets, so that a tighter layout shows as a higher share."""


def proj_bytes(shapes: dict) -> int:
    return 2 * 4 * shapes["S"] * shapes["n"] + 4 * shapes["blocks"]
