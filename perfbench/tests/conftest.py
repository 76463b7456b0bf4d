"""Tests of the benchmark harness (``python -m pytest perfbench/tests -q``).

The harness's own arithmetic, its discovery of files by name, the plain
reference against numpy, and whole runs of every cell at a tiny size on the
CPU with the program intact (``correct`` true), under the lower-precision
control and with the timed path broken (``correct`` false).  Tests marked
``chip`` need an NVIDIA GPU and skip without one; run them on the card with
``python -m pytest perfbench/tests -q -m chip``.
"""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.dirname(BENCH), BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs an NVIDIA GPU; skips without one")


def tiny_cell(name: str):
    """The cell ``name`` cut to a size a CPU test holds: 300 blocks, 3,000
    rows, 8 scenarios (10 equality rows), 200 steps (3 outers of 100)."""
    from harness import core

    cell = core.Cell(name)
    g = cell.config["generator"]
    g.update(num_blocks=300, m=3000)
    if "num_eq" in g:
        g.update(num_eq=10, scenarios=8)
    tr = cell.traffic
    tr["scenarios"] = 8 if tr["scenarios"] > 1 else 1
    if "inner_iters" in tr["solve"]:
        tr["solve"].update(max_iter=300, inner_iters=100)
    else:
        tr["solve"]["max_iter"] = 200
    if tr["loop"] == "closed":
        tr.update(warm_widths=[8], check_sample=16)
    else:
        tr.update(warm_widths=[1, 2, 4, 8], queue={"max_batch": 8, "max_wait_ms": 20},
                  rate_per_s=5, trace_from_s=0.5, trace_s=0.5, wait_s=30, check_sample=8,
                  warm_requests=8)
    return cell


@pytest.fixture
def cpu_threads():
    import torch

    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)
