"""Float32 only on a CUDA device.  The CUDA kernels take float32 alone, so
``prepare``, ``solve`` (unconstrained and equality-constrained) and
``Endpoint`` refuse another dtype with a CUDA device, from the device's type
alone, before any upload or CUDA call: here, with no card, every CUDA call is
made to fail loudly, and the refusal still comes as a ``ValueError``.  The CLI
no longer passes a configuration's dtype, as the reference's CLI never did,
so a float64 configuration solves in float32."""
import json

import numpy as np
import pytest
import torch

import bsls_tpu_torch as bt
from bsls_tpu_torch import cli
from bsls_tpu_torch.ops import layout as TL
from torch_port_helpers import KERNELS
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)


def _no_cuda_call(monkeypatch):
    """Every entry to torch.cuda that the package makes before an upload
    raises, so that a refusal that comes after one would fail differently."""
    def boom(*a, **k):
        raise AssertionError("a CUDA call was made before the refusal")

    for name in ("is_available", "current_device", "synchronize", "device_count"):
        monkeypatch.setattr(torch.cuda, name, boom)


def _tiny():
    return bt.synthetic.tiny_dense(seed=0, num_blocks=6, dim=4, m=20)


ENTRIES = {
    "prepare": lambda dt, dev: bt.prepare(_tiny(), dtype=dt, device=dev),
    "solve": lambda dt, dev: bt.solve(_tiny(), dtype=dt, device=dev, max_iter=5, chunk=5),
    "solve_eq": lambda dt, dev: bt.solve(bt.synthetic.make_config("traffic"), dtype=dt,
                                         device=dev, max_iter=5, chunk=5),
    "endpoint": lambda dt, dev: bt.Endpoint(_tiny(), dtype=dt, device=dev),
}


@pytest.mark.parametrize("device", ["cuda", "cuda:0", torch.device("cuda", 0)], ids=str)
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_float64_with_a_cuda_device_is_refused_before_any_cuda_call(entry, device, monkeypatch):
    _no_cuda_call(monkeypatch)
    bt.reset_launch_counts()
    with pytest.raises(ValueError, match="float32 only") as err:
        ENTRIES[entry](torch.float64, device)
    assert all(name in str(err.value) for name in KERNELS)  # names every fp32-only kernel
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("entry", ["prepare", "solve"])
def test_float32_with_a_cuda_device_goes_on_to_the_device(entry):
    """The check refuses no float32 work: without a card, float32 on "cuda"
    fails where the device is resolved, as before."""
    with pytest.raises(RuntimeError, match="is False"):
        ENTRIES[entry](torch.float32, "cuda")


def test_check_dtype_reads_the_device_type_only():
    TL.check_dtype(torch.float64, "cpu")
    TL.check_dtype(torch.float32, "cuda")
    for dt in (torch.float64, torch.float16, torch.bfloat16):
        with pytest.raises(ValueError, match="float32 only"):
            TL.check_dtype(dt, "cuda:1")


def test_cli_float64_config_solves_in_float32(tmp_path, monkeypatch, capsys):
    """A configuration file with ``"dtype": "float64"``: the CLI prepares in
    float32 and gives the float32 run's result, as the reference's CLI does
    (it never passes dtype)."""
    prepared = []
    real = bt.prepare

    def spy(prob, **kw):
        dp = real(prob, **kw)
        prepared.append(dp.b.dtype)
        return dp

    monkeypatch.setattr(bt, "prepare", spy)
    outs = {}
    for dtype in ("float64", "float32"):
        path = tmp_path / f"{dtype}.json"
        path.write_text(json.dumps({"config": "tiny", "dtype": dtype, "device": "cpu",
                                    "max_iter": 60, "chunk": 30}))
        outs[dtype] = cli.main(["--preset", str(path)])
    capsys.readouterr()
    assert prepared == [torch.float32, torch.float32]
    assert outs["float64"]["iterations"] == outs["float32"]["iterations"] == 60
    np.testing.assert_array_equal(outs["float64"]["objective"], outs["float32"]["objective"])
