"""Mean milliseconds of a request outside its chunk loop: the host clock
around ``Endpoint.solve`` less the sum of the request's ``chunk_times``
(the upload of b, the power iteration, the set-up of the chunk loop and the
assembly of the result), over the requests completed in the window."""
from harness.stats import completed_in_window


def read(run):
    done = completed_in_window(run["requests"], run["window"])
    if not done:
        return None
    return 1e3 * sum(r["result"].host_s - float(sum(r["result"].chunk_times))
                     for r in done) / len(done)
