"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per
source, all started together, then one link) into one shared library with a
plain C interface, at first use, into ``csrc/_build/``; the library is loaded
with ``ctypes``.  Pointers come from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream()``.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take, allocates the output with ``torch.empty``, checks
the error code of the launch, does not synchronise, and adds one to its
launch count where it launches — and nowhere else.  Nothing here falls back:
if the build, the load or a launch fails, the error propagates.  The plain
PyTorch versions of both functions are ``ops.projection.proj_simplex_padded``
and ``ops.isotonic.pava_padded``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import torch

__all__ = [
    "build_library", "proj_simplex_rows", "pava_rows", "launch_counts",
    "reset_launch_counts", "MAX_WIDTH",
]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SOURCES = ("proj_simplex_rows.cu", "pava_rows.cu")
_HEADERS = ("rows_common.cuh",)
_BUILD_DIR = os.path.join(_CSRC, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libbsls_rows.so")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xcompiler", "-fPIC")

MAX_WIDTH = 128  # kMaxWidth in csrc/rows_common.cuh

_lock = threading.Lock()
_lib = None
_LAUNCHES = {"proj_simplex_rows": 0, "pava_rows": 0}


def launch_counts() -> dict:
    """Kernel launches made by this process since the last reset, by kernel."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _stale() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    built = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(os.path.join(_CSRC, f)) > built
               for f in _SOURCES + _HEADERS)


def build_library(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into ``csrc/_build/libbsls_rows.so`` and return its
    path.  ``verbose`` adds ``-Xptxas -v`` and prints the compiler's output
    (registers, spills and local memory per kernel)."""
    nvcc = _nvcc()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    extra = ("-Xptxas", "-v") if verbose else ()
    objs, procs = [], []
    for src in _SOURCES:
        # per-process object names: two processes may build at the same time
        obj = os.path.join(_BUILD_DIR, f"{src[:-3]}.{os.getpid()}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *_NVCC_FLAGS, *extra, "-c", os.path.join(_CSRC, src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    for src, p, log in zip(_SOURCES, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    if verbose:
        print("".join(logs))
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp.so"
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a", "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build_library()
            lib = ctypes.CDLL(_LIB_PATH)
            ptr = ctypes.c_void_p
            for fn in (lib.bsls_proj_simplex_rows, lib.bsls_pava_rows):
                fn.restype = ctypes.c_int
                fn.argtypes = [ptr, ptr, ptr, ptr, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, ptr]
            _lib = lib
        return _lib


def _check(name, v, widths, radius):
    if not (v.is_cuda and widths.is_cuda and radius.is_cuda):
        raise ValueError(f"{name}: all tensors must lie on a CUDA device")
    if not (v.device == widths.device == radius.device):
        raise ValueError(f"{name}: tensors lie on different devices")
    if v.dtype != torch.float32 or radius.dtype != torch.float32:
        raise TypeError(f"{name}: values and radius must be float32, got "
                        f"{v.dtype} and {radius.dtype}")
    if widths.dtype != torch.int32:
        raise TypeError(f"{name}: widths must be int32, got {widths.dtype}")
    if v.ndim < 2:
        raise ValueError(f"{name}: expected (..., Bk, w), got {tuple(v.shape)}")
    Bk, w = v.shape[-2], v.shape[-1]
    if widths.shape != (Bk,) or radius.shape != (Bk,):
        raise ValueError(f"{name}: widths/radius must be ({Bk},), got "
                         f"{tuple(widths.shape)} and {tuple(radius.shape)}")
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"{name}: width {w} outside 1..{MAX_WIDTH}")
    if not (v.is_contiguous() and widths.is_contiguous() and radius.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    return Bk, w


def _launch(name, fn_name, v, widths, radius):
    Bk, w = _check(name, v, widths, radius)
    fn = getattr(_load(), fn_name)
    out = torch.empty_like(v)
    rows = v.numel() // w  # leading scenario axes fold into the row axis
    with torch.cuda.device(v.device):
        err = fn(v.data_ptr(), widths.data_ptr(), radius.data_ptr(), out.data_ptr(),
                 rows, w, Bk, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    _LAUNCHES[name] += 1
    return out


def proj_simplex_rows(v: torch.Tensor, widths: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """Project each row of ``v`` (..., Bk, w) onto {x >= 0, sum x = radius[b]}
    over its first ``widths[b]`` slots; 0 elsewhere.  CUDA float32 only."""
    return _launch("proj_simplex_rows", "bsls_proj_simplex_rows", v, widths, radius)


def pava_rows(y: torch.Tensor, widths: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """[0, radius[b]]-bounded nondecreasing isotonic fit of the first
    ``widths[b]`` slots of each row of ``y`` (..., Bk, w); 0 elsewhere.  CUDA
    float32 only."""
    return _launch("pava_rows", "bsls_pava_rows", y, widths, radius)
