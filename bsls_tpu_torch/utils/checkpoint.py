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
``None``; a Python scalar field comes back as the same type.  A file that
holds ``PGDState.k`` as a scalar (it was a Python int before it moved onto
the device) still loads: the count is taken for every scenario.

**On a mesh** (``shard=`` from ``parallel/sharding.py``) every rank writes its
own slice of the state, with each leaf's global offset and global shape and
the mesh's shape; in a world of more than one process the file of rank K is
``<stem>[.itNNNNNNNNN].procK.npz``.  A rank loads its own file and refuses
one written on another mesh shape.  Which checkpoint to resume from is
agreed by all ranks (``resume_state``: the newest iteration that every
rank holds a file of), so every rank resumes at the same iteration, and
a rank that cannot load its file makes every rank raise.

Counterpart of ``bsls_tpu/utils/checkpoint.py``.
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

__all__ = ["save_state", "load_state", "latest_checkpoint", "checkpoint_files"]

_STAMP_RE = re.compile(r"\.it(\d{9})(?:\.proc\d+)?\.npz$")
_PROC_RE = re.compile(r"\.proc\d+\.npz$")
_ONE = {"row": 1, "block": 1, "scenario": 1}


def _stem(path: str) -> str:
    return path[:-4] if path.endswith(".npz") else path


def _suffix(shard: dict | None) -> str:
    return f".proc{shard['rank']}" if shard and shard["world"] > 1 else ""


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


def save_state(path: str, state: Any, meta: dict | None = None, keep: int = 0,
               shard: dict | None = None) -> None:
    """Atomic save of a solver state (+ JSON-able meta) to .npz.

    ``keep > 0`` writes an iteration-stamped file (meta must carry
    ``iteration``) and rotates old stamps; ``keep == 0`` overwrites ``path``
    itself.  ``shard`` (a rank's slice of a state on a mesh: ``rank``,
    ``world``, ``mesh`` shape, and per leaf ``[global offset, global
    shape]`` as ``leaves``) is stored beside the leaves; with ``world > 1``
    the file takes the ``.procK`` suffix."""
    structure, leaves = _flatten(state)
    payload: dict = {"structure": np.asarray(structure)}
    for i, x in enumerate(leaves):
        payload[f"leaf_{i}"] = _to_numpy(x)
    if meta:
        payload["meta"] = np.asarray(json.dumps(meta))
    if shard:
        payload["shard"] = np.asarray(json.dumps(
            {"mesh": shard["mesh"], "leaves": shard["leaves"]}))
    if keep > 0:
        it = int((meta or {}).get("iteration", 0))
        _atomic_write(f"{_stem(path)}.it{it:09d}{_suffix(shard)}.npz", payload)
        _prune(path, keep, _suffix(shard))
    else:
        _atomic_write(f"{_stem(path)}{_suffix(shard)}.npz", payload)


def _prune(path: str, keep: int, suffix: str = "") -> None:
    """Keep this process's newest ``keep`` stamps (each rank prunes its own
    files)."""
    stamped = sorted(f for f in glob.glob(f"{_stem(path)}.it*{suffix}.npz")
                     if _STAMP_RE.search(f) and (suffix or not _PROC_RE.search(f)))
    for f in stamped[:-keep]:
        try:
            os.remove(f)
        except OSError:
            pass


def _restore(a: np.ndarray, ref, i: int):
    """Leaf ``i`` as the type of ``ref``, after its shape and dtype check.  An
    integer scalar where ``ref`` is an integer (S,) tensor is a ``PGDState.k``
    of a file written while it was a Python int: it is taken for every
    scenario."""
    if isinstance(ref, torch.Tensor):
        want_shape, want_dtype = tuple(ref.shape), torch.empty(0, dtype=ref.dtype).numpy().dtype
        if (a.ndim == 0 and ref.ndim == 1 and a.dtype.kind in "iu"
                and not ref.dtype.is_floating_point):
            a = np.full(want_shape, a, dtype=want_dtype)
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
    return type(ref)(a)  # a Python scalar


def load_state(path: str, like: Any, shard: dict | None = None):
    """Load a state saved by ``save_state`` into the structure of ``like``.

    Refuses a file of another structure (class or field names), one written
    on another mesh shape or with other global offsets than ``shard`` says
    (a file without mesh is one of the 1 x 1 x 1 mesh), and checks each
    leaf's shape and dtype against ``like``'s.  Returns (state, meta)."""
    raw = np.load(path, allow_pickle=False)
    structure, leaves_like = _flatten(like)
    saved = str(raw["structure"]) if "structure" in raw.files else None
    if saved != structure:
        raise ValueError(f"checkpoint {path} holds {saved}, not {structure}")
    info = json.loads(str(raw["shard"])) if "shard" in raw.files else {}
    mesh_saved, mesh_now = info.get("mesh", _ONE), (shard or {}).get("mesh", _ONE)
    if mesh_saved != mesh_now:
        raise ValueError(f"checkpoint {path} was written on mesh {mesh_saved}, "
                         f"not on this mesh {mesh_now}")
    if shard and info and info["leaves"] != shard["leaves"]:
        raise ValueError(f"checkpoint {path} holds other slices of the state than this "
                         "rank's")
    leaves = [_restore(raw[f"leaf_{i}"], ref, i) for i, ref in enumerate(leaves_like)]
    meta = json.loads(str(raw["meta"])) if "meta" in raw.files else {}
    return _unflatten(like, leaves), meta


def checkpoint_files(path: str, rank: int | None = None) -> dict:
    """The checkpoints for ``path`` by iteration stamp, the plain (unstamped)
    file under ``None``.  ``rank`` lists the files of that rank of a world of
    several processes."""
    suffix = "" if rank is None else f".proc{rank}"
    files = {int(_STAMP_RE.search(f).group(1)): f
             for f in glob.glob(f"{_stem(path)}.it*{suffix}.npz")
             if _STAMP_RE.search(f) and (suffix or not _PROC_RE.search(f))}
    cand = f"{_stem(path)}{suffix}.npz"
    if os.path.exists(cand):
        files[None] = cand
    elif rank is None and os.path.exists(path):
        files[None] = path
    return files


def latest_checkpoint(path: str) -> str | None:
    """The newest checkpoint for ``path``: the highest iteration-stamped
    sibling if rotation was used, else the plain file."""
    files = checkpoint_files(path)
    stamps = [k for k in files if k is not None]
    return files[max(stamps)] if stamps else files.get(None)


def resume_state(path: str, like: Any, shard: dict | None = None):
    """(state, meta) from the newest checkpoint for ``path`` loaded into the
    structure of ``like`` (``meta["iteration"]`` its iteration); (like, {})
    where there is none.

    On a mesh (``shard`` given) it is the newest checkpoint of which every
    rank holds its file.  Every rank lists its own files and all take the
    same iteration, so a rank whose newest file is missing (killed between
    the ranks' writes, or pruned by its own rotation) cannot send the others
    another way.  A rank that cannot load its file makes every rank raise,
    so no rank goes on alone into the warm-up's collectives."""
    if shard is None:
        ck = latest_checkpoint(path)
        return load_state(ck, like) if ck else (like, {})
    import torch.distributed as dist

    world = dist.get_world_size()
    mine = checkpoint_files(path, dist.get_rank() if world > 1 else None)
    held = [None] * world
    dist.all_gather_object(held, list(mine))
    common = set(held[0]).intersection(*held[1:])
    stamps = [k for k in common if k is not None]
    if not stamps and None not in common:
        return like, {}
    state, meta = like, {}
    try:
        state, meta = load_state(mine[max(stamps) if stamps else None], like, shard=shard)
        status = (int(meta.get("iteration", 0)), None)
    except Exception as e:  # every rank hears of it below
        status = (None, f"{type(e).__name__}: {e}")
    statuses = [None] * world
    dist.all_gather_object(statuses, status)
    errors = [f"rank {r}: {err}" for r, (_, err) in enumerate(statuses) if err]
    if errors:
        raise ValueError(f"cannot resume from {path}: " + "; ".join(errors))
    iterations = sorted({it for it, _ in statuses})
    if len(iterations) > 1:
        raise ValueError(f"cannot resume from {path}: the ranks' files hold iterations "
                         f"{iterations}")
    return state, meta
