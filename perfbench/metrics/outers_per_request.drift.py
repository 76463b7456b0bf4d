"""Outer iterations of the augmented-Lagrangian loop per request, from its
"outer" records (taken in the traced run only: each record costs a float64
objective on the host)."""


def read(run):
    n = run["outer_requests"]
    return len(run["outer"]) / n if n and run["outer"] else None
