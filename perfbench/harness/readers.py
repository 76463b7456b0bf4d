"""Arithmetic that several metric readers share."""


def idle_percent(run):
    """Percent of the traced window with no kernel on the device (the union
    of kernel intervals against the window's host-clock length)."""
    tr = run["trace"]
    if not tr or not tr["busy_s"] or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
