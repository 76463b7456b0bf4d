"""Mean milliseconds of a request outside its chunk loop (the upload of b,
the power iteration, the set-up of the chunk loop, the result and its
readback): ``request_overhead_ms.batch``'s reader."""
import os

from harness.core import load_reader

read = load_reader("metrics", "request_overhead_ms.batch",
                   os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).read
