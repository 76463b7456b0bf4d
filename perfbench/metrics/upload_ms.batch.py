"""Mean milliseconds of a request's ``upload`` phase, from the program's
span ``bsls.upload`` (its result's ``phases["upload"]``), over the requests
completed in the window."""
from harness.phases import mean_ms
from harness.stats import completed_in_window


def read(run):
    return mean_ms(completed_in_window(run["requests"], run["window"]), "upload")
