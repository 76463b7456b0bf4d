"""Run one cell of the port's benchmark and print its result line.

    python3 perfbench/run.py --workload medium.batch128 --seed 7 --seconds 30 --trace 0

from the root of a checkout that holds the program (``bsls_tpu_torch``) and
an NVIDIA GPU; without a card, or with fewer than the cell asks for, it exits
with code 2 and prints no result.  See ``perfbench/harness/core.py``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one process with few host threads: the host's cores are shared, and wide
# thread pools make the host's part of a request swing from run to run
for _var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[_var] = "2"

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
