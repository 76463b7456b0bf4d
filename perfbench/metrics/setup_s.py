"""Seconds from the process's start to the first timed request: library
load, the inputs, the endpoint's prepare and upload, the kernel library's
load (and build in a fresh checkout), the warm-ups and their captures."""


def read(run):
    return run["setup_s"]
