"""Mean milliseconds of a request's host float64 work in the eq loop:
``eq.setup`` (casts, rho0's column norms, the operator cache's lookup),
``eq.host`` of every outer (C x, the multiplier and penalty update, the stop
test) and ``eq.report`` (the final objective and violation), from the
program's spans, over the requests completed in the window; the "outer"
records' objectives (``eq.record``) are left out."""
from harness.phases import mean_ms
from harness.stats import completed_in_window


def read(run):
    return mean_ms(completed_in_window(run["requests"], run["window"]),
                   "eq.setup", "eq.host", "eq.report")
