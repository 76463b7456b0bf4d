"""On the card: each cell's run for a few seconds is correct, and its
control at the cell's own size is not.  Skips without an NVIDIA GPU."""
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
CELLS = ["medium.batch128", "traffic_eq.drift128", "medium.stream"]


def _need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    _need_card()
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", name, "--seed",
                          "2147483659", "--seconds", "8", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.chip
@pytest.mark.parametrize("name,precision", [("medium.batch128", "bfloat16"),
                                            ("traffic_eq.drift128", "bfloat16"),
                                            ("medium.stream", "bfloat16")])
def test_control_on_the_card(name, precision):
    _need_card()
    out = subprocess.run([sys.executable, "perfbench/control.py", "--workload", name, "--seeds",
                          "2147483661", "--precision", precision], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    assert not json.loads(out.stdout.strip().splitlines()[-1])["correct"]
