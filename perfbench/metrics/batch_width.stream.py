"""Requests per batch that ``BatchQueue`` ran in the window
(``requests_served / batches_run``, before padding to a power of two)."""


def read(run):
    served = run["served"]
    return served["requests"] / served["batches"] if served and served["batches"] else None
