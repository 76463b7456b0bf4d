"""Mean milliseconds an outer iteration spends on the host after its inner
solve (C x in float64, the multiplier update, the stop test), from the
"outer" records' ``host_secs`` (traced run only)."""


def read(run):
    outer = run["outer"]
    return 1e3 * sum(o["host_secs"] for o in outer) / len(outer) if outer else None
