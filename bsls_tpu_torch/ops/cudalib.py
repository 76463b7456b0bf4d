"""Build and load the hand-written CUDA kernels of ``csrc/``; count launches.

The sources are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per
source, all started together, then one link) into one shared library with a
plain C interface, at first use, into ``csrc/_build/``; the library is loaded
with ``ctypes``.  Nothing happens at import.  The wrapper modules
(``rowkernels``, ``pagekernels``, ``chunkkernel``) declare the argument types
of their own functions, pass pointers from ``tensor.data_ptr()`` and the
stream of ``torch.cuda.current_stream()``, and record every launch here.

Nothing here falls back: if the build, the load or a launch fails, the error
propagates.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

__all__ = ["build_library", "load", "launched", "launch_counts", "reset_launch_counts"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SOURCES = ("proj_simplex_rows.cu", "pava_rows.cu", "band_pages.cu", "pgd_chunk.cu")
_HEADERS = ("rows_common.cuh", "proj_device.cuh")
_BUILD_DIR = os.path.join(_CSRC, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libbsls_kernels.so")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
_LAUNCHES = {"proj_simplex_rows": 0, "pava_rows": 0, "band_zmv": 0, "band_grmv": 0,
             "pgd_chunk": 0}


def launch_counts() -> dict:
    """Kernel launches made by this process since the last reset, by kernel."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launched(name: str, err: int) -> None:
    """Called by a wrapper right after its launch with the launch's
    ``cudaError_t``: raises on a refused launch, counts an accepted one."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    _LAUNCHES[name] += 1


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
    """Compile ``csrc/*.cu`` into ``csrc/_build/libbsls_kernels.so`` and return
    its path.  ``verbose`` adds ``-Xptxas -v`` and prints the compiler's output
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
        [nvcc, "-shared", *_ARCH, "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        os.remove(obj)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or older than a source."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build_library()
            _lib = ctypes.CDLL(_LIB_PATH)
        return _lib
