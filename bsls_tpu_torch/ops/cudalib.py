"""Build and load the hand-written CUDA kernels of ``csrc/``; count launches.

The sources are compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per
source, all started together, then one link) into one shared library with a
plain C interface, at first use, into ``csrc/_build/``; the library is loaded
with ``ctypes``.  Nothing happens at import.  The wrapper modules
(``rowkernels``, ``pagekernels``, ``chunkkernel``, ``ellkernels``,
``stepkernels``) declare the argument types of their own functions, pass
pointers from ``tensor.data_ptr()`` and the stream of
``torch.cuda.current_stream()``, and record every launch here.

A launch made while a thread captures a CUDA graph (``recording``) runs
only when the graph is replayed: it is counted into the capture's record,
and the graph adds that record at each replay (``add_record``).  ``count``
is the same rule for any other counter of launches.

Nothing here falls back: if the build, the load or a launch fails, the error
propagates.
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess
import threading

__all__ = ["build_library", "load", "launched", "launch_counts", "reset_launch_counts",
           "count", "recording", "record_launches", "add_record"]

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_SOURCES = ("proj_simplex_rows.cu", "pava_rows.cu", "band_pages.cu", "pgd_chunk.cu",
            "ell_products.cu", "pgd_step.cu")
_HEADERS = ("rows_common.cuh", "proj_device.cuh")
_BUILD_DIR = os.path.join(_CSRC, "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libbsls_kernels.so")
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None
_LAUNCHES = {"proj_simplex_rows": 0, "pava_rows": 0, "band_zmv": 0, "band_grmv": 0,
             "pgd_chunk": 0, "ell_gather_dot": 0, "step_prep": 0, "step_dir": 0,
             "step_update": 0}


def launch_counts() -> dict:
    """Kernel launches made by this process since the last reset, by kernel."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


_capture = threading.local()  # .record: the capture this thread is making


def count(counter: dict, name: str, n: int = 1) -> None:
    """Add ``n`` to ``counter[name]``, or, while this thread captures a graph,
    to the capture's record (the launch happens at each replay)."""
    record = getattr(_capture, "record", None)
    if record is None:
        counter[name] += n
    else:
        key = (id(counter), name)
        record[key] = (counter, name, record.get(key, (counter, name, 0))[2] + n)


@contextlib.contextmanager
def recording():
    """Collect the counts of this thread's launches into a record instead of
    the counters (while it captures a graph); yields the record."""
    if getattr(_capture, "record", None) is not None:
        raise RuntimeError("a graph capture is already recording in this thread")
    _capture.record = {}
    try:
        yield _capture.record
    finally:
        _capture.record = None


def record_launches(record: dict) -> dict:
    """The kernel launches of one replay of a capture's record, by name."""
    return {name: n for counter, name, n in record.values() if counter is _LAUNCHES}


def add_record(record: dict) -> None:
    """Add a capture's counts to their counters: one replay of its graph."""
    for counter, name, n in record.values():
        counter[name] += n


def launched(name: str, err: int) -> None:
    """Called by a wrapper right after its launch with the launch's
    ``cudaError_t``: raises on a refused launch, counts an accepted one."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    count(_LAUNCHES, name)


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
