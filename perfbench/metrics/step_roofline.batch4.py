"""Share of the HBM roofline of a PGD step at the cell's shapes
(``counts/step_bytes.py``: about 1.03 GB a step at 1M blocks, S = 4) against
the device-busy time per iteration of the traced request:
``step_roofline.batch``'s reader."""
import os

from harness.core import load_reader

read = load_reader("metrics", "step_roofline.batch",
                   os.path.dirname(os.path.dirname(os.path.abspath(__file__)))).read
