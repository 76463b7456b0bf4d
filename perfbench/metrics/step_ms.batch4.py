"""Milliseconds of chunk loop per iteration over the requests completed in
the window: ``step_ms.batch``'s reader, in the cell of 4 scenarios."""
import os

from harness.core import load_reader

read = load_reader("metrics", "step_ms.batch",
                   os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).read
