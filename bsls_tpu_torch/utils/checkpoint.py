"""Checkpoint / resume of solver state, in one process.

A checkpoint is a plain ``.npz`` of the flattened state:

* a solver state (a frozen dataclass of tensors) is flattened in
  ``dataclasses.fields`` order, a tuple field (the per-bucket iterate) into
  one leaf per element; a ``dict`` of arrays (the equality-constrained loop's
  ``{"lam", "x"}``) by sorted key.  Leaves are stored as ``leaf_{i}`` and the
  class and field names as ``structure``; a file whose structure differs from
  the state it is loaded into is refused.
* **Rotation** — ``save_state(..., keep=K)`` writes an iteration-stamped
  sibling ``<stem>.itNNNNNNNNN.npz`` and prunes all but the newest ``K``;
  ``latest_checkpoint`` resolves the newest stamp (falling back to the plain
  path).
* **Atomicity** — every file is written to a temporary name in the target
  directory and ``os.replace``d, so a SIGKILL during a save never corrupts the
  previous checkpoint.

Tensors are saved through ``.cpu().numpy()`` and loaded onto the device and
dtype of the state they are loaded into.  A field that is ``None`` stays
``None``; a Python scalar field comes back as the same type.

Counterpart of ``bsls_tpu/utils/checkpoint.py`` without its per-process shard
dump (a mesh of several processes is not ported).
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import tempfile
from typing import Any

import numpy as np
import torch

__all__ = ["save_state", "load_state", "latest_checkpoint"]

_STAMP_RE = re.compile(r"\.it(\d{9})\.npz$")


def _stem(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def _flatten(state: Any) -> tuple[str, list]:
    """(structure, leaves) of a solver state or a dict of arrays."""
    if isinstance(state, dict):
        keys = sorted(state)
        return f"dict({', '.join(keys)})", [state[k] for k in keys]
    if not dataclasses.is_dataclass(state):
        raise TypeError(f"cannot checkpoint a {type(state).__name__}")
    parts, leaves = [], []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            parts.append(f"{f.name}=None")
        elif isinstance(v, tuple):
            parts.append(f"{f.name}[{len(v)}]")
            leaves.extend(v)
        else:
            parts.append(f.name)
            leaves.append(v)
    return f"{type(state).__name__}({', '.join(parts)})", leaves


def _unflatten(like: Any, leaves: list) -> Any:
    if isinstance(like, dict):
        return dict(zip(sorted(like), leaves))
    it = iter(leaves)
    values = {}
    for f in dataclasses.fields(like):
        v = getattr(like, f.name)
        if v is None:
            values[f.name] = None
        elif isinstance(v, tuple):
            values[f.name] = tuple(next(it) for _ in v)
        else:
            values[f.name] = next(it)
    return dataclasses.replace(like, **values)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _atomic_write(target: str, payload: dict) -> None:
    d = os.path.dirname(os.path.abspath(target)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz")
    os.close(fd)
    try:
        np.savez(tmp, **payload)  # keeps the name (already ends in .npz)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_state(path: str, state: Any, meta: dict | None = None, keep: int = 0) -> None:
    """Atomic save of a solver state (+ JSON-able meta) to .npz.

    ``keep > 0`` writes an iteration-stamped file (meta must carry
    ``iteration``) and rotates old stamps; ``keep == 0`` overwrites ``path``
    itself."""
    structure, leaves = _flatten(state)
    payload: dict = {"structure": np.asarray(structure)}
    for i, x in enumerate(leaves):
        payload[f"leaf_{i}"] = _to_numpy(x)
    if meta:
        payload["meta"] = np.asarray(json.dumps(meta))
    if keep > 0:
        it = int((meta or {}).get("iteration", 0))
        _atomic_write(f"{_stem(path)}.it{it:09d}.npz", payload)
        _prune(path, keep)
    else:
        _atomic_write(f"{_stem(path)}.npz", payload)


def _prune(path: str, keep: int) -> None:
    stamped = sorted(f for f in glob.glob(f"{_stem(path)}.it*.npz") if _STAMP_RE.search(f))
    for f in stamped[:-keep]:
        try:
            os.remove(f)
        except OSError:
            pass


def _restore(a: np.ndarray, ref, i: int):
    """Leaf ``i`` as the type of ``ref``, after its shape and dtype check."""
    if isinstance(ref, torch.Tensor):
        want_shape, want_dtype = tuple(ref.shape), torch.empty(0, dtype=ref.dtype).numpy().dtype
    else:
        r = np.asarray(ref)
        want_shape, want_dtype = r.shape, r.dtype
    if tuple(a.shape) != want_shape:
        raise ValueError(f"checkpoint leaf {i} shape {a.shape} != expected {want_shape}")
    if a.dtype != want_dtype:
        raise ValueError(f"checkpoint leaf {i} dtype {a.dtype} != expected {want_dtype}")
    if isinstance(ref, torch.Tensor):
        return torch.from_numpy(a).to(ref.device)
    if isinstance(ref, np.ndarray):
        return a
    return type(ref)(a)  # a Python scalar (e.g. PGDState.k)


def load_state(path: str, like: Any):
    """Load a state saved by ``save_state`` into the structure of ``like``.

    Refuses a file of another structure (class or field names), and checks
    each leaf's shape and dtype against ``like``'s.  Returns (state, meta)."""
    raw = np.load(path, allow_pickle=False)
    structure, leaves_like = _flatten(like)
    saved = str(raw["structure"]) if "structure" in raw.files else None
    if saved != structure:
        raise ValueError(f"checkpoint {path} holds {saved}, not {structure}")
    leaves = [_restore(raw[f"leaf_{i}"], ref, i) for i, ref in enumerate(leaves_like)]
    meta = json.loads(str(raw["meta"])) if "meta" in raw.files else {}
    return _unflatten(like, leaves), meta


def latest_checkpoint(path: str) -> str | None:
    """The newest checkpoint for ``path``: the highest iteration-stamped
    sibling if rotation was used, else the plain file."""
    stamped = [f for f in glob.glob(f"{_stem(path)}.it*.npz") if _STAMP_RE.search(f)]
    if stamped:
        return max(stamped, key=lambda f: _STAMP_RE.search(f).group(1))
    cand = f"{_stem(path)}.npz"
    if os.path.exists(cand):
        return cand
    return path if os.path.exists(path) else None
