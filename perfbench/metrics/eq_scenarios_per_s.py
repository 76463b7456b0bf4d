"""Scenarios answered by the requests completed in the window, over the time
those requests spanned."""
from harness.stats import completed_in_window, rate_over_span


def read(run):
    S = run["shapes"]["S"]
    return rate_over_span(completed_in_window(run["requests"], run["window"]), lambda r: S)
