"""Mesh construction over ``torch.distributed``: ('row', 'block', 'scenario')
axes.

The 'block' axis shards the block dimension (x, projections, A's columns);
the 'scenario' axis shards the multi-RHS batch; the optional 'row' axis
shards A's rows and the residual (combined with 'block' this is the 2-D
sharded product: A x partials are summed over 'block', A^T r partials over
'row', each collective moving only its axis's payload).

SPMD over processes: one rank per card, launched by ``torchrun`` (or by
``torch.multiprocessing`` in the tests).  Every rank calls ``make_mesh`` and
then ``solve(prob, mesh=mesh)`` with the same host ``Problem``; each uploads
only its own slice and every rank returns the full result.

Counterpart of ``bsls_tpu/parallel/mesh.py``, where one controller drives a
``jax.sharding.Mesh``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ROW_AXIS", "BLOCK_AXIS", "SCENARIO_AXIS", "Mesh", "default_backend",
           "init_distributed", "make_mesh"]

ROW_AXIS = "row"
BLOCK_AXIS = "block"
SCENARIO_AXIS = "scenario"
AXES = (ROW_AXIS, BLOCK_AXIS, SCENARIO_AXIS)

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def default_backend() -> str:
    """gloo for CPU tensors, NCCL for CUDA tensors where a card is present.
    Several ranks on one card need ``backend="gloo"``: NCCL refuses two
    ranks on one device."""
    return "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"


def init_distributed(backend: Optional[str] = None) -> None:
    """Initialise the default process group, if it is not yet.

    Under ``torchrun`` (its ``RANK``/``WORLD_SIZE``/``MASTER_*`` variables
    set) this joins that world; without that environment it makes a world of
    one on an in-process store.  A caller that initialises the group itself
    (a ``file://`` or ``tcp://`` init) is left as it is."""
    if dist.is_initialized():
        return
    backend = backend or default_backend()
    if all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend=backend)
    else:
        dist.init_process_group(backend=backend, store=dist.HashStore(), rank=0,
                                world_size=1)


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a ('row', 'block', 'scenario') mesh: ``shape`` and
    this rank's ``coords`` (dicts by axis name), a process group per axis
    (``groups``), the torch ``DeviceMesh`` they come from, and the device this
    rank computes on."""

    shape: dict
    coords: dict
    groups: dict
    device: torch.device
    device_mesh: object

    @property
    def size(self) -> int:
        return self.shape[ROW_AXIS] * self.shape[BLOCK_AXIS] * self.shape[SCENARIO_AXIS]

    @property
    def rank(self) -> int:
        return dist.get_rank()


def _rank_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"make_mesh(device={str(device)!r}) but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_mesh(block: Optional[int] = None, scenario: int = 1, row: int = 1,
              device="cuda") -> Mesh:
    """Build a ('row', 'block', 'scenario') mesh over the process group (made
    by ``init_distributed()`` if there is none; a caller that wants another
    backend calls ``init_distributed(backend)`` first).  ``row * block *
    scenario`` must equal the world size; ``block`` defaults to what is
    left.  Each rank computes on ``cuda:{LOCAL_RANK % device_count}``, or on
    the CPU with ``device="cpu"``."""
    dev = _rank_device(device)
    init_distributed()
    n = dist.get_world_size()
    if block is None:
        block = n // (scenario * row)
    if row * block * scenario != n:
        raise ValueError(f"row({row}) * block({block}) * scenario({scenario}) != "
                         f"world size({n})")
    from torch.distributed.device_mesh import init_device_mesh

    dm = init_device_mesh(dev.type, (row, block, scenario), mesh_dim_names=AXES)
    return Mesh(
        shape={ROW_AXIS: row, BLOCK_AXIS: block, SCENARIO_AXIS: scenario},
        coords={ax: int(dm.get_local_rank(ax)) for ax in AXES},
        groups={ax: dm.get_group(ax) for ax in AXES},
        device=dev,
        device_mesh=dm,
    )
