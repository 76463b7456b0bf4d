#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device, nvcc and g++
    python3 chip_smoke.py --ptxas    # also print registers/spills per kernel
    python3 chip_smoke.py --ptxas --stop-after kernels   # short run for a new kernel

Drives ``bsls_tpu_torch`` only (nothing of JAX): builds the native host
library and the CUDA kernels from the sources in this checkout, holds every
kernel against its plain PyTorch version on the card, and runs these paths
through ``prepare``/``solve``:

* the batched PGD solve on ``synthetic.medium_sparse`` x 128 scenarios with the
  exact and the pava line search (gather layout; projection and PAVA kernels),
  cross-checked against the CPU;
* the banded layout on ``synthetic.medium_banded`` (the preset
  ``medium-banded``: bbm line search), single right-hand side and 4 scenarios
  (the two page kernels), and forced-banded against gather;
* the fused chunk (``BSLS_MEGA=1``) on ``synthetic.tiny_dense`` against the
  eager path of the same solve;
* the five other solver families (apgd, eg, frank_wolfe, afw, lbfgs in x- and
  z-space) on medium x 128, lbfgs and afw on the card against the CPU and on
  the band against gather; ``certify`` (pgd/bbm, then 150 afw steps);
  ``refine`` (lbfgs, then three rounds of the device CG) at S = 128 and the
  certified ``refine_tol`` (host float64 PCG) at S = 8;
* the equality-constrained path: ``solve_equality_constrained`` (pgd/exact
  inners on the stacked operator [A; sqrt(rho) C]) on ``traffic_like`` at
  full width (10,000 blocks, 50 dense constraint rows) x 128 scenarios, the
  first outer on the card against the CPU at S = 4, the pava line search at
  S = 4 (kernel 2 in z-space inners), and the preset ``traffic`` with
  ``refine_tol=1e-6`` against the float64 ``oracle_solve_eq``;
* serving: an ``Endpoint`` on medium x 128 (gather layout) answering three
  streamed (128, m) requests, each held against a direct ``solve``, with the
  seconds a request spends outside its chunk loop; a ``BatchQueue`` fed by
  8 client threads with 64 single-RHS requests, held against one batched
  solve; the eq endpoints: the preset ``traffic`` (a certified request, then
  a perturbed one on the float64 sensitivity fast path against
  ``oracle_solve_eq``) and traffic_like x 128 (two requests, one stacked
  operator);
* checkpoint/resume: a child process solving medium x 128 is killed with
  SIGKILL after its first checkpoint and the solve resumed to 400
  iterations against an uninterrupted run; the CLI with ``--checkpoint`` and
  ``--profile-dir`` on the card, its trace holding CUDA kernel events;
* the mesh, on config 4 at full width (``synthetic.large_sharded(seed=0)``:
  1M blocks of 8, 48M nonzeros, S = 4): the unsharded solve against a world
  of one over NCCL in this process (``mesh_world1``); four rank processes on
  the one card over gloo, block 2 x scenario 2 (``mesh_ranks``, a
  correctness run); ``dryrun_multichip(4, device="cuda")`` (``mesh_dryrun``,
  17 cases); kernels 1-4 held against their plain versions at rank shard
  shapes;
* the equality-constrained loop on a mesh at full width (traffic_like x 128):
  a world of one over NCCL by column and by row against the unsharded loop
  of ``solve_eq`` with its Lipschitz pair, and the pava line search at S = 4
  (``mesh_eq_world1``); four rank processes on the card over gloo, block 2 x
  scenario 2, by column and by row at a reduced budget (``mesh_eq_ranks``);
  kernel 1 at a rank's tile;
* serving on a world of one (``serve_mesh``): an ``Endpoint(mesh=)`` of
  medium x 128 against the unsharded endpoint, eq mesh endpoints of the
  preset ``traffic`` (a request on the sensitivity fast path from the warm
  x) and of traffic_like x 128 (one stacked operator for two requests), and a
  ``BatchQueue`` over the mesh endpoint (``serve_mesh_queue``);
* in a fresh process, the first chunk of the exact path against the second:
  the kernel library's load, the first launches and the capture of the
  chunk's CUDA graph come before the clock.

A solve on the card runs each chunk as a replay of its captured CUDA graph.
Every graphed path (the solves of every family and layout, certify, the eq
inners, serving and the queue) is run twice more on the same inputs, two
chunks deep: graphed, from the cache, and with the eager runner swapped in
(``eager_chunks``).  Their first chunks' per-step traces, their ends and
their launches are held together, and each phase reports its captures and
capture seconds, cache hits, replays, the programs' pool bytes, and both
runs' wall ms per iteration and peak memory.  The mesh's chunks run eager.

Every phase prints one JSON line; a failed phase raises and the script exits
non-zero without the result line.  The last line is ``{"ok": true, "device":
{...}}``, the line before it lists every kernel with its launches on its path,
its error, its time, the plain version's time, its bound and, where one
PyTorch call computes the same function, that call's time.  The projection
is held at every width 1-40, 48, 64, 100, 127 and 128, PAVA at every width
1-128 (ties and rows within 100x the radius among them; PAVA also rows with
a NaN), one bucket a launch and eight to a launch, and both are timed at
every path's buckets one launch a bucket and all in one launch, as their
paths launch them; every path's projections and z-space fits take one
launch each.  ``pava_rows`` is also held and timed on the inputs that a
short pava solve of medium x 128 hands it (captured before the kernels
phase), with the share of rows that pool, and timed on (128, 1003, w) rows
at a sweep of widths.  A float64 solve with the card as its device must be
refused before anything is uploaded.  The ELL product kernel
(``ell_gather_dot``) is held against the plain chain it replaced at S = 1,
32 and 128 on medium's row and column groups, the eq path's stacked operator
and a column-sharded local ELL, and on eleven groups (two launches), then
timed at medium's two products beside its bytes bound, the plain chain and
``torch.sparse.mm`` over a CSR copy.  The exact step's three kernels
(``step_prep``, ``step_dir``, ``step_update``: one row, ``pgd_step``) are held
a step at a time against the chain they replaced at medium x 128, the eq
path's stacked operator x 128 and config 4 x 4 (and against themselves, bit
for bit), then timed at medium x 128 and config 4 x 4 beside their bytes
bound and their plain versions, with the device operations of one eager step
through them and through the chain.  With ``--ptxas`` the build phase fails
unless both row kernels (every form, inlined) and every instantiation of the
ELL product kernel keep everything out of local memory (no stack frame, no
spills).
"""
import argparse
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script runs on a GPU only")

import bsls_tpu_torch as bt  # noqa: E402
from bsls_tpu_torch import native  # noqa: E402
from bsls_tpu_torch.ops import (  # noqa: E402
    chunkkernel, cudalib, ellkernels, isotonic, pagekernels, rowkernels, stepkernels)
from bsls_tpu_torch.ops import layout as TL  # noqa: E402
from bsls_tpu_torch.ops.banded import PAGE, DeviceBanded  # noqa: E402
from bsls_tpu_torch.ops.isotonic import pava_padded  # noqa: E402
from bsls_tpu_torch.ops.layout import feasible_init  # noqa: E402
from bsls_tpu_torch.ops.projection import proj_simplex_padded  # noqa: E402
from bsls_tpu_torch.solvers import mega  # noqa: E402

DEV = torch.device("cuda", 0)
SCENARIOS = 128
# published peaks of one H100 SXM: device memory rate and fp32 rate outside
# the tensor cores; the bound of a kernel is stated against these
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
L2_BYTES = 50e6
# a row kernel agrees with its plain version within this, times the largest radius
ROW_ERR_LIMIT = 3e-5
# a page kernel within this, times the largest entry of the result (at least
# 1): unit-scale data, fp32 sums of up to 1024 products taken in another order
PAGE_ERR_LIMIT = 2e-5
# the fused chunk against its plain version over 200 steps: the f-trace
# relative, x absolute
CHUNK_TRACE_LIMIT = 1e-3
CHUNK_X_LIMIT = 2e-5


class PhaseFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound(bytes_, ops):
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# Calls of the row kernels' grouped entries the solvers made on the card since
# the last reset_counts(): each takes one launch, whatever its number of
# buckets (a projection one of proj_simplex_rows, a z-space fit one of
# pava_rows).
CALLS = {"proj_simplex_rows": 0, "pava_rows": 0}


def count_calls():
    """Wrap ``ops.projection.proj_blocks`` and ``ops.isotonic.pava_blocks``
    where the solvers look them up (the modules, and ``solvers.base``, which
    imported ``proj_blocks``), so that a path's calls on CUDA tensors are
    counted beside its launches."""
    from bsls_tpu_torch.ops import projection
    from bsls_tpu_torch.solvers import base

    def counted(name, plain):
        def call(xp, buckets):
            # inside a graph capture the call is counted at each replay
            cudalib.count(CALLS, name, int(any(x.is_cuda for x in xp)))
            return plain(xp, buckets)
        return call

    projection.proj_blocks = base.proj_blocks = counted("proj_simplex_rows",
                                                        projection.proj_blocks)
    isotonic.pava_blocks = counted("pava_rows", isotonic.pava_blocks)


def reset_counts():
    bt.reset_launch_counts()
    for name in CALLS:
        CALLS[name] = 0


def read_counts():
    """The launch counts since ``reset_counts()``; fails unless every call
    of a row kernel's grouped entry took one launch."""
    counts = bt.launch_counts()
    for name, calls in CALLS.items():
        check(counts[name] == calls,
              f"{sys._getframe(1).f_code.co_name}: {counts[name]} launches of {name} for "
              f"{calls} calls (one launch a call)")
    return counts


# ------------------------------------------------- captured chunks and eager

# A solve on the card runs each chunk as a replay of its captured CUDA graph
# (bsls_tpu_torch/solvers/graph.py).  Every graphed path is run again with
# the eager runner on the same inputs: the first chunk's per-step objective
# trace of every solve inside (each inner solve of an equality-constrained
# loop) within GRAPH_TRACE_LIMIT relative (the same kernels on the same
# inputs: equal bits are expected), the ends within GRAPH_END_LIMIT (the
# card-against-CPU limit of cross_check: objective relative, x absolute),
# and the same launches (a replay's against an eager chunk's).
GRAPH_TRACE_LIMIT = 1e-6
GRAPH_END_LIMIT = 1e-3
# the twins run two chunks (two outers of one chunk on the eq path): the
# first chunk's trace, a replay's launches and the state carried from one
# replay into the next are what they hold
GRAPH_TWIN_CHUNKS = 2


@contextlib.contextmanager
def eager_chunks():
    """Every solve's chunk as the eager runner on the card, the yardstick:
    ``chunk_program`` swapped where ``solve`` looks it up, without the
    throwaway step (the process is warm), so that a run's launches are its
    chunks' and the rest of the solve's, as a graph hit's are."""
    from bsls_tpu_torch.solvers import base

    graphed = base.chunk_program
    base.chunk_program = (lambda dp, solver, opts, L_est, steps, state:
                          base.make_chunk_runner(dp, solver, opts, L_est, steps))
    try:
        yield
    finally:
        base.chunk_program = graphed


@contextlib.contextmanager
def first_chunk_traces(out):
    """Append the (S, chunk) objective trace of the first chunk of every
    solve made inside to ``out``."""
    from bsls_tpu_torch.solvers import base

    loop = base.run_chunk_loop

    def spy(*a, **k):
        res = loop(*a, **k)
        if res.traces_f:
            out.append(res.traces_f[0].double().cpu().numpy())
        return res

    base.run_chunk_loop = spy
    try:
        yield
    finally:
        base.run_chunk_loop = loop


def graph_twin(phase, solve, ends):
    """``solve()`` with its chunks graphed and then eager, the counts and
    the graph statistics set to 0 before each.  The graphed run must hit the
    cache (the path's own run captured), so that neither run makes a
    throwaway step.  ``ends(result)`` gives (objectives, x).  Returns the
    comparison and both runs' wall seconds, chunk-loop ms per iteration and
    peak memory."""
    runs = {}
    for mode in ("graph", "eager"):
        traces = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        snap = graph_since()
        with contextlib.ExitStack() as stack:
            stack.enter_context(first_chunk_traces(traces))
            if mode == "eager":
                stack.enter_context(eager_chunks())
            t0 = time.perf_counter()
            res = solve()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        iters = max(int(res.iterations), 1)
        runs[mode] = dict(res=res, traces=traces, secs=secs, counts=read_counts(),
                          stats=graph_since(snap),
                          peak=torch.cuda.max_memory_allocated(),
                          loop_ms=1e3 * float(np.sum(res.chunk_times)) / max(
                              int(np.asarray(res.chunk_iters)[-1]) if len(res.chunk_iters)
                              else 1, 1),
                          wall_ms=1e3 * secs / iters)
    g, e = runs["graph"], runs["eager"]
    check(g["stats"]["captures"] == 0 and g["stats"]["replays"] > 0,
          f"{phase}: the graphed twin made {g['stats']['captures']} captures and "
          f"{g['stats']['replays']} replays (a cache hit expected)")
    check(e["stats"]["replays"] == 0 and e["stats"]["captures"] == 0,
          f"{phase}: the eager twin replayed a graph")
    check(len(g["traces"]) == len(e["traces"]) > 0,
          f"{phase}: {len(g['traces'])} graphed and {len(e['traces'])} eager solves")
    trace_rel = max(_rel_diff(a, b) for a, b in zip(g["traces"], e["traces"]))
    bits = all(np.array_equal(a, b) for a, b in zip(g["traces"], e["traces"]))
    check(trace_rel <= GRAPH_TRACE_LIMIT, f"{phase}: the graphed first chunk's trace differs "
          f"from the eager one by {trace_rel:.2e} relative")
    (fg, xg), (fe, xe) = ends(g["res"]), ends(e["res"])
    obj_rel = _rel_diff(fg, fe)
    x_abs = float(np.max(np.abs(np.asarray(xg, np.float64) - np.asarray(xe, np.float64))))
    check(obj_rel <= GRAPH_END_LIMIT and x_abs <= GRAPH_END_LIMIT,
          f"{phase}: graphed and eager ends differ: objective {obj_rel:.2e} relative, "
          f"x {x_abs:.2e}")
    check(g["counts"] == e["counts"], f"{phase}: launches graphed {g['counts']} against eager "
          f"{e['counts']} (a replay launches what an eager chunk does)")
    replays = g["stats"]["replays"]
    return {"first_chunk_max_rel_diff": trace_rel, "first_chunk_bits_equal": bits,
            "solves": len(g["traces"]), "end_objective_max_rel_diff": obj_rel,
            "end_x_max_abs_diff": x_abs, "replays": replays,
            "launches_per_replay": {k: v / replays for k, v in g["counts"].items()},
            "graph_secs": g["secs"], "eager_secs": e["secs"],
            "graph_wall_ms_per_iter": g["wall_ms"], "eager_wall_ms_per_iter": e["wall_ms"],
            "graph_loop_ms_per_iter": g["loop_ms"], "eager_loop_ms_per_iter": e["loop_ms"],
            "graph_peak_bytes": g["peak"], "eager_peak_bytes": e["peak"]}


def solve_ends(res):
    return np.atleast_1d(res.objective), res.x


def _graph_profile(prof):
    """The graph's figures of a ``profile_steps`` line, beside the eager ones."""
    g = prof["graph"]
    return {k: g[k] for k in ("wall_ms_per_iter", "event_ms_per_iter", "device_busy_ms_per_iter",
                              "device_idle_share", "launches_per_iter", "profiler_saw_graph",
                              "peak_bytes", "pool_bytes")}


def graph_since(snap=None):
    """The graph statistics since the snapshot ``snap`` (another
    ``graph_since()``), and the programs cached now with their pools' bytes."""
    now = bt.solvers.graph.graph_stats()
    if snap is not None:
        for k in ("captures", "capture_secs", "hits", "replays", "evictions"):
            now[k] -= snap[k]
    return now


@contextlib.contextmanager
def graph_report(phase):
    """After the phase, a line of its captures (and their seconds), cache
    hits, replays and evictions, and the programs cached at its end with
    their pools' bytes."""
    snap = graph_since()
    t0 = time.perf_counter()
    yield
    emit(f"{phase}_graph", **graph_since(snap), phase_secs=time.perf_counter() - t0)


# ---------------------------------------------------------------- phases 1-2


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         matmul_precision=torch.get_float32_matmul_precision())


def kernel_resources(log, name):
    """ptxas's report on the kernels whose mangled name holds ``name``, a
    pattern with one group, the key: {key: {stack frame, spill stores, spill
    loads, registers}}."""
    out = {}
    pat = (r"Function properties for \S*" + name + r"\S*\s+(\d+) bytes "
           r"stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads"
           r"(?:\s+ptxas info\s+: Used (\d+) registers)?")
    for w, frame, st, ld, regs in re.findall(pat, log):
        out[w] = {
            "stack_frame": int(frame), "spill_stores": int(st), "spill_loads": int(ld),
            "registers": int(regs) if regs else None}
    return out


def phase_build(ptxas):
    t0 = time.perf_counter()
    host_native = native.native_available()  # builds the host library with g++
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        lib = cudalib.build_library(verbose=ptxas)
    print(log.getvalue(), end="", flush=True)
    t_cuda = time.perf_counter() - t0
    emit("build", host_layout_engine="native" if host_native else "numpy fallback",
         native_secs=round(t_native, 2), cuda_library=lib.split("bsls_tpu_torch/")[-1],
         cuda_secs=round(t_cuda, 2))
    if ptxas:
        # every form of either row kernel is inlined into its kernel, one
        # instantiation for 1, 2, 4 and 8 descriptors: no stack frame, no
        # spills in any
        res = {}
        for kernel in ("proj_buckets_kernel", "pava_buckets_kernel"):
            res[kernel] = kernel_resources(log.getvalue(), kernel + r"ILi(\d+)E")
            check(sorted(res[kernel], key=int) == ["1", "2", "4", str(rowkernels.MAX_BUCKETS)],
                  f"ptxas: reports on {kernel}<{sorted(res[kernel])}>")
            for nb, r in res[kernel].items():
                check(r["stack_frame"] == r["spill_stores"] == r["spill_loads"] == 0,
                      f"ptxas: a form of {kernel}<{nb}> uses local memory: {r}")
        # the ELL product kernel: one instantiation for each vector width
        # (1, 2, 4 floats a lane) and 1, 2, 4 and 8 descriptors
        ell = kernel_resources(log.getvalue(), r"ell_gather_dot_kernelILi(\d+ELi\d+)E")
        want = sorted(f"{f}ELi{nb}" for f in (1, 2, 4) for nb in (1, 2, 4, ellkernels.MAX_GROUPS))
        check(sorted(ell) == want, f"ptxas: reports on ell_gather_dot_kernel<{sorted(ell)}>")
        for form, r in ell.items():
            check(r["stack_frame"] == r["spill_stores"] == r["spill_loads"] == 0,
                  f"ptxas: ell_gather_dot_kernel<{form}> uses local memory: {r}")
        res["ell_gather_dot_kernel"] = ell
        emit("ptxas", **res)


# ------------------------------------------------------------------ timing


def _elapsed_ms(run):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def call_ms(fn, reps=20, warm=3):
    """Time of one call as the solver makes it (eager, wrapper included):
    the larger of the host's time to enqueue and the device's time to run."""
    for _ in range(warm):
        fn(0)
    torch.cuda.synchronize()

    def run():
        for i in range(reps):
            fn(i)  # the output is dropped at once, as the solver's temporaries are

    return _elapsed_ms(run) / reps


def device_ms(fn, reps=20):
    """Device time of one launch: ``reps`` launches captured in a CUDA graph
    and replayed, so that no host time sits between them."""
    fn(0)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    return _elapsed_ms(graph.replay) / reps


# ------------------------------------------------- phase 3: the row kernels


def random_rows(lead, Bk, w, seed, kind="random"):
    """Ragged widths (0 = dummy row, radius 1), per-row radius, values of the
    size the solver produces (a few radii); ``kind`` "ties" rounds them to
    one decimal, "large" draws them within 100x the radius instead."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, w + 1, size=Bk).astype(np.int32)
    radius = rng.uniform(0.5, 5.0, size=Bk).astype(np.float32)
    radius[widths == 0] = 1.0
    if kind == "large":
        v = rng.uniform(-100.0, 100.0, lead + (Bk, w)).astype(np.float32) * radius[:, None]
    else:
        v = (rng.standard_normal(lead + (Bk, w)) * 2).astype(np.float32) * radius[:, None]
        if kind == "ties":
            v = np.round(v, 1)
    to = lambda a: torch.from_numpy(a).to(DEV)
    return to(v), to(widths), to(radius)


def _mask(v, widths):
    return (torch.arange(v.shape[-1], device=v.device) < widths[:, None]).to(v.dtype)


def _proj_structure(name, got, widths, radius, pad, rowsum_rel=1e-5):
    real = widths > 0
    sums = got.sum(-1)[..., real]
    rel = ((sums - radius[real]).abs() / radius[real]).max() if real.any() else 0.0
    check(float(rel) <= rowsum_rel, f"{name}: row sums off by {float(rel):.2e} relative")
    check(float(got.min()) >= 0.0, f"{name}: negative entry")


def _pava_structure(name, got, widths, radius, pad):
    inner = ~pad[:, 1:]
    steps = (got[..., 1:] - got[..., :-1]).masked_select(inner.expand_as(got[..., 1:]))
    check(steps.numel() == 0 or float(steps.min()) >= 0.0, f"{name}: fit is not nondecreasing")
    check(float(got.min()) >= 0.0 and bool((got <= radius[:, None]).all()),
          f"{name}: fit leaves [0, radius]")


def compare_rows(name, spec, v, widths, radius, got=None, **structure):
    """Max abs difference kernel vs plain, in units of the largest radius,
    plus the structural checks.  ``got``: the kernel's output where the
    caller launched it (a grouped launch), else one launch here."""
    if got is None:
        got = spec["fn"](v, widths, radius)
    torch.cuda.synchronize()
    want = spec["plain"](v, widths, radius)
    check(got.shape == v.shape and got.dtype == v.dtype, f"{name}: wrong output shape/dtype")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    pad = torch.arange(v.shape[-1], device=DEV) >= widths[:, None]
    check(float(got.masked_select(pad.expand_as(got)).abs().sum()) == 0.0,
          f"{name}: padding slots or dummy rows are not zero")
    spec["structure"](name, got, widths, radius, pad, **structure)
    err = float((got - want).abs().max() / radius.max())
    check(err <= ROW_ERR_LIMIT, f"{name}: differs from the plain version by {err:.2e} x max "
          f"radius at shape {tuple(v.shape)}")
    return err


PROJ_CHECK_WIDTHS = tuple(range(1, 41)) + (48, 64, 100, 127, 128)
PAVA_CHECK_WIDTHS = tuple(range(1, rowkernels.MAX_WIDTH + 1))
# Row sums of the rows within 100x the radius: tau, up to 100 r, carries half
# an ulp (up to 6e-6 r) into every slot of the support, so there the sums are
# held at 1e-4 relative (1e-5 elsewhere; the plain version's are 3e-5 off).
LARGE_ROWSUM_REL = 1e-4


def check_every_width(name, spec, ctx):
    """A row kernel at each of its check widths (the projection 1-40, 48, 64,
    100, 127 and 128; PAVA every width 1-128): ragged widths with dummy rows,
    (Bk, w) rows and a folded scenario axis, on random rows, rows with ties
    and rows within 100x the radius; one bucket a launch, then the same cases
    eight buckets to a launch; PAVA also on rows with a NaN."""
    errs, shapes, groups = [], [], {}
    for k, kind in enumerate(("random", "ties", "large")):
        kw = spec["structure_kw"].get(kind, {})
        for w in spec["check_widths"]:
            for lead in ((), (3,)):
                case = random_rows(lead, 1003, w, seed=100 * w + len(lead) + 7919 * k, kind=kind)
                errs.append(compare_rows(name, spec, *case, **kw))
                shapes.append([kind, *case[0].shape])
                groups.setdefault((kind, lead), []).append(case)
    for (kind, _), cases in groups.items():
        kw = spec["structure_kw"].get(kind, {})
        for at in range(0, len(cases), rowkernels.MAX_BUCKETS):
            part = cases[at:at + rowkernels.MAX_BUCKETS]
            outs = spec["buckets_fn"](*zip(*part))
            for case, got in zip(part, outs):
                errs.append(compare_rows(name, spec, *case, got=got, **kw))
    if spec.get("nan_widths"):
        errs.append(check_nan_rows(name, spec))
    return max(errs), shapes, ROW_ERR_LIMIT


def check_nan_rows(name, spec):
    """Rows with a NaN among their first widths[b] slots, and rows with one in
    a padding slot, against the plain version: the same slots NaN, the rest
    within the row limit; one bucket a launch, then eight to a launch."""
    cases = []
    for w in spec["nan_widths"]:
        v, widths, radius = random_rows((3,), 1003, w, seed=900 + w)
        rng = np.random.default_rng(w)
        y, n = v.cpu().numpy(), widths.cpu().numpy()
        for b in range(0, 1003, 5):
            if n[b] > 0:  # a NaN among the fitted slots of scenario b % 3
                y[b % 3, b, rng.integers(0, n[b])] = np.nan
            if n[b] < w:  # a NaN in a padding slot of every scenario
                y[:, b, rng.integers(n[b], w)] = np.nan
        cases.append((torch.from_numpy(y).to(DEV), widths, radius))
    outs = [spec["fn"](*case) for case in cases]
    for at in range(0, len(cases), rowkernels.MAX_BUCKETS):
        outs += spec["buckets_fn"](*zip(*cases[at:at + rowkernels.MAX_BUCKETS]))
    torch.cuda.synchronize()
    errs = []
    for (v, widths, radius), got in zip(cases + cases, outs):
        w = v.shape[-1]
        want = spec["plain"](v, widths, radius)
        nan = torch.isnan(want)
        check(bool(nan.any()) and torch.equal(torch.isnan(got), nan),
              f"{name}: NaN slots differ from the plain version at width {w}")
        errs.append(float((got[~nan] - want[~nan]).abs().max() / radius.max()))
        check(errs[-1] <= ROW_ERR_LIMIT, f"{name}: rows around the NaN rows differ from the "
              f"plain version by {errs[-1]:.2e} x max radius at width {w}")
    return max(errs)


def inputs_in_turn(one_bytes):
    """How many inputs of ``one_bytes`` a timing cycles through so that
    together they exceed the L2 cache: every launch then finds its rows in
    device memory, as the solve's fresh tensors of a bucket would."""
    return max(4, -(-int(1.2 * L2_BYTES) // one_bytes))


def capture_pava_inputs(dp, iters=40):
    """The tensors that a short ``pava`` solve of ``dp`` hands
    ``isotonic.pava_blocks``, by bucket shape, in the order of the iterations
    (its chunk run eagerly: a captured chunk calls the function once, at its
    capture).  The function is wrapped here for the capture only."""
    seen = {}
    plain_fn = isotonic.pava_blocks

    def spy(yp, buckets):
        for y in yp:
            seen.setdefault(tuple(y.shape), []).append(y.clone())
        return plain_fn(yp, buckets)

    isotonic.pava_blocks = spy
    try:
        with eager_chunks():  # each iteration through the wrapped function
            bt.solve(dp, method="pgd", line_search="pava", tol=0.0, max_iter=iters, chunk=iters)
    finally:
        isotonic.pava_blocks = plain_fn
    check(len(seen) == len(dp.buckets) and all(len(v) == iters for v in seen.values()),
          f"capture: {[len(v) for v in seen.values()]} pava inputs for {len(dp.buckets)} buckets "
          f"and {iters} iterations")
    return seen


def pooling_share(vs, widths):
    """Share of rows with at least one order violation among their first
    ``widths`` slots: the rows on which pool-adjacent-violators merges."""
    inner = torch.arange(1, vs[0].shape[-1], device=DEV) < widths[:, None]
    return float(sum(((v[..., 1:] < v[..., :-1]) & inner).any(-1).float().mean()
                     for v in vs) / len(vs))


def measure_rows(name, spec, ctx):
    """One application to all buckets of medium x 128 (one launch each); for
    PAVA also on the inputs a pava solve of that instance hands the kernel."""
    dp = ctx["medium"]
    ms = plain_ms = bytes_ = ops = 0.0
    errs, per_bucket, inputs = [], [], []
    solve_inputs = ctx.get("pava_inputs") if name == "pava_rows" else None
    for i, bk in enumerate(dp.buckets):
        # the tensors the main path hands the kernel: (S, Bk, w), the bucket's
        # own sizes (sizes - 1 for the z-space fit) and radii
        widths = spec["widths_of"](bk)
        shape = (SCENARIOS,) + tuple(bk.mask.shape)
        gen = torch.Generator(device=DEV).manual_seed(7 + i)
        n_in = inputs_in_turn(4 * int(np.prod(shape)))
        vs = [torch.randn(shape, generator=gen, device=DEV) * 2 * bk.radius[:, None]
              for _ in range(n_in)]
        errs.append(compare_rows(name, spec, vs[0], widths, bk.radius))
        inputs.append((vs, widths, bk.radius))
        launch = lambda j: spec["fn"](vs[j % n_in], widths, bk.radius)
        k_ms, c_ms = device_ms(launch), call_ms(launch)
        plain = spec.get("timed_plain", spec["plain"])
        p_ms = call_ms(lambda j: plain(vs[j % n_in], widths, bk.radius), reps=4)
        rows, w = vs[0].numel() // bk.width, bk.width
        b_bytes = 2 * 4 * rows * w + 8 * bk.mask.shape[0]
        b_ops = rows * spec["ops_per_row"](w)
        b_ms = bound(b_bytes, b_ops)[0]
        entry = {"shape": list(shape), "inputs_in_turn": n_in, "ms": k_ms, "call_ms": c_ms,
                 "plain_ms": p_ms, "bound_ms": b_ms, "share_of_bound": b_ms / k_ms}
        if solve_inputs is not None:
            entry.update(pooling_share=pooling_share(vs, widths))
            # iterations spread over the capture, enough to exceed the L2
            seq = solve_inputs[shape]
            pick = np.linspace(0, len(seq) - 1, min(n_in, len(seq))).round().astype(int)
            ss = [seq[j] for j in pick]
            check(len(ss) == n_in, f"{name}: {len(ss)} captured inputs, {n_in} wanted")
            for v in ss:
                errs.append(compare_rows(name, spec, v, widths, bk.radius))
            s_ms = device_ms(lambda j: spec["fn"](ss[j % n_in], widths, bk.radius))
            entry.update(solve_inputs_ms=s_ms, solve_inputs_share_of_bound=b_ms / s_ms,
                         solve_inputs_pooling_share=pooling_share(ss, widths),
                         solve_iterations=[int(j) for j in pick],
                         solve_inputs_max_abs=float(max(v.abs().max() for v in ss)),
                         max_radius=float(bk.radius.max()))
        per_bucket.append(entry)
        ms, plain_ms, bytes_, ops = ms + k_ms, plain_ms + p_ms, bytes_ + b_bytes, ops + b_ops
    b_ms, by = bound(bytes_, ops)
    # the main path's launch: every bucket at once; ``ms`` is its time
    g = grouped_rows(name, inputs, errs)
    out = dict(max_abs_err=max(errs), ms=g["ms"], plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=None, grouped=g, per_bucket_launches_ms=ms,
               share_of_bound=b_ms / g["ms"], per_bucket=per_bucket,
               plan_by_width={str(bk.width): spec["plan"](bk.width) for bk in dp.buckets})
    if solve_inputs is not None:
        out.update(solve_inputs_ms=sum(e["solve_inputs_ms"] for e in per_bucket))
    if spec.get("sweep_widths"):
        out.update(sweep=width_sweep(name, spec))
        out["max_abs_err"] = max(out["max_abs_err"], *(e["max_abs_err"]
                                                      for e in out["sweep"].values()))
    return out


def width_sweep(name, spec, Bk=1003):
    """One launch at (128, Bk, w) for each of the kernel's sweep widths
    (ragged widths with dummy rows, inputs cycled past the L2), beside the
    bytes bound; each held first against the plain version on its first
    four scenarios."""
    out = {}
    for w in spec["sweep_widths"]:
        v, widths, radius = random_rows((SCENARIOS,), Bk, w, seed=500 + w)
        err = compare_rows(name, spec, v[:4].contiguous(), widths, radius)
        n_in = inputs_in_turn(4 * v.numel())
        gen = torch.Generator(device=DEV).manual_seed(w)
        vs = [v] + [torch.randn(v.shape, generator=gen, device=DEV) * 2 * radius[:, None]
                    for _ in range(n_in - 1)]
        ms = device_ms(lambda j: spec["fn"](vs[j % n_in], widths, radius))
        b_ms, by = bound(2 * 4 * v.numel() + 8 * Bk, SCENARIOS * Bk * spec["ops_per_row"](w))
        out[str(w)] = {"shape": list(v.shape), "form": spec["plan"](w), "ms": ms,
                       "bound_ms": b_ms, "bound_by": by, "share_of_bound": b_ms / ms,
                       "max_abs_err": err}
        del vs
    return out


def sort_comparators(K):
    """Comparators of the thread forms' sort (csrc/proj_simplex_rows.cu,
    sort_desc): Batcher's odd-even merge network on the next power of two,
    pruned to K slots."""
    P, count, p = 1 << max(0, (K - 1).bit_length()), 0, 1
    while p < P:
        k = p
        while k >= 1:
            r = k % p
            count += sum(1 for lo in range(P) if lo >= r and (lo - r) % (2 * k) < k
                         and lo + k < K and lo // (2 * p) == (lo + k) // (2 * p))
            k //= 2
        p *= 2
    return count


def grouped_rows(name, inputs, errs):
    """Every bucket of a call in one launch, as ``proj_blocks`` and
    ``pava_blocks`` launch them: ``inputs`` holds per bucket (the inputs it
    cycles through, widths, radius).  Held against the plain version (errors
    appended to ``errs``), then timed (device time of one launch, each bucket
    cycling through its inputs) beside the summed bound of the buckets."""
    spec = KERNELS[name]
    sizes = tuple(w for _, w, _ in inputs)
    radii = tuple(r for _, _, r in inputs)
    outs = spec["buckets_fn"](tuple(vs[0] for vs, _, _ in inputs), sizes, radii)
    for (vs, widths, radius), got in zip(inputs, outs):
        errs.append(compare_rows(name, spec, vs[0], widths, radius, got=got))
    launch = lambda j: spec["buckets_fn"](
        tuple(vs[j % len(vs)] for vs, _, _ in inputs), sizes, radii)
    g_ms, c_ms = device_ms(launch), call_ms(launch)
    bytes_ = sum(2 * vs[0].numel() * 4 + 8 * w.numel() for vs, w, _ in inputs)
    ops = sum(vs[0].numel() // vs[0].shape[-1] * spec["ops_per_row"](vs[0].shape[-1])
              for vs, _, _ in inputs)
    b_ms, by = bound(bytes_, ops)
    return {"buckets": [list(vs[0].shape) for vs, _, _ in inputs], "ms": g_ms, "call_ms": c_ms,
            "bound_ms": b_ms, "bound_by": by, "share_of_bound": b_ms / g_ms}


# ------------------------------------------------ phase 3: the page kernels


def compare_pages(name, spec, band, v):
    """Max abs difference kernel vs plain einsum, in units of the largest
    entry of the result (at least 1)."""
    got = spec["fn"](band, v)
    torch.cuda.synchronize()
    want = spec["plain"](band, v)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{name}: output {tuple(got.shape)}, expected {tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    err = float((got - want).abs().max() / torch.clamp(want.abs().max(), min=1.0))
    check(err <= PAGE_ERR_LIMIT, f"{name}: differs from the einsum by {err:.2e} x max entry "
          f"at band {tuple(band.shape)}, operand {tuple(v.shape)}")
    return err


def _note_path(name, ctx):
    """Which of band_grmv's kernels the call just made took."""
    if name == "band_grmv":
        ctx.setdefault("grmv_paths", set()).add(
            pagekernels.GRMV_PATHS[pagekernels.band_grmv_last_path()])


def check_pages(name, spec, ctx):
    """Every S x C x W of the grid, Mp a prime, plus strided operands, widths
    that are no multiple of 4 or smaller than a warp, row counts one off the
    row tile, a single page, and operands that start off a 16-byte boundary.
    For band_grmv every kernel behind the entry point must have been taken,
    and each is also held against the einsum where the shape admits it."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    errs, shapes = [], []

    def case(band, v, label=None, every_kernel=True):
        errs.append(compare_pages(name, spec, band, v))
        _note_path(name, ctx)
        shapes.append(label or [v.shape[0], *band.shape])
        if name == "band_grmv" and every_kernel:
            want = spec["plain"](band, v)
            for path in range(len(pagekernels.GRMV_PATHS)):
                got = pagekernels.band_grmv_on_path(band, v, path)
                if got is not None:
                    err = float((got - want).abs().max() / torch.clamp(want.abs().max(), min=1.0))
                    check(err <= PAGE_ERR_LIMIT, f"{name}: kernel {pagekernels.GRMV_PATHS[path]} "
                          f"differs by {err:.2e} at band {tuple(band.shape)}, S={v.shape[0]}")
                    errs.append(err)

    # (in the first, large group only the kernel the launcher picks is run)
    for Mp, Cs, Ws, Ss in ((37, (1, 7, 52, 160), (128, 384, 512, 1024), (1, 2, 3, 4, 15, 16, 33)),
                           (37, (31, 33), (130, 4, 512), (1, 4)),
                           (1, (7, 33), (512, 130), (1, 3)),
                           (5, (7,), (1536,), (16,))):  # too wide for the ring: the scalar kernel
        for C in Cs:
            for W in Ws:
                band = torch.randn((Mp, C, W), generator=gen, device=DEV)
                K = band.shape[spec["contracted"]]
                for S in Ss:
                    case(band, torch.randn((S, Mp, K), generator=gen, device=DEV),
                         every_kernel=len(Ss) < 7)
    # operands as the layout hands them over: the segment of a PF-flat vector,
    # and the sliding page windows of a padded residual; the base on a 16-byte
    # boundary (offset 0 for the windows) and 1 and 2 floats off it
    Mp = 37
    band = torch.randn((Mp, 7, 384), generator=gen, device=DEV)
    for off in (0, 1, 2):
        if spec["contracted"] == 1:
            x_pf = torch.randn((3, 12 + off + Mp * 7 + 5), generator=gen, device=DEV)
            v = x_pf[:, 12 + off:12 + off + Mp * 7].reshape(3, Mp, 7)
        else:
            rp = torch.randn((3, (Mp + 3) * PAGE + 4), generator=gen, device=DEV)
            v = rp.as_strided((3, Mp, 384), (rp.stride(0), PAGE, 1), off)
        check(not v.is_contiguous(), f"{name}: the strided case is contiguous")
        check(v.data_ptr() % 16 == 4 * off, f"{name}: the strided case is not {off} floats off")
        case(band, v, f"strided view, base {off} floats off 16 bytes")
    if name == "band_grmv":
        taken = ctx["grmv_paths"]
        check(taken == set(pagekernels.GRMV_PATHS),
              f"{name}: the cases took only the kernels {sorted(taken)}")
    return max(errs), shapes, PAGE_ERR_LIMIT


def measure_pages(name, spec, ctx):
    """The real band tensors of medium_banded, S = 1 and S = 4: all buckets of
    one product (one launch each).  ``ms`` etc. are the single-RHS numbers;
    ``per_s`` has both.  band_grmv is also timed on the operand the solve hands
    it (the page windows of a padded residual, a strided view) and through each
    of its kernels."""
    errs, per_s = [], {}
    grmv = name == "band_grmv"
    for S, dp in sorted(ctx["banded"].items()):
        A = dp.A
        gen = torch.Generator(device=DEV).manual_seed(13 + S)
        ms = c_ms = plain_ms = lib_ms = win_ms = read_ms = bytes_ = ops = 0.0
        path_ms = dict.fromkeys(pagekernels.GRMV_PATHS, 0.0)
        for band in A.bands:
            Mp, C, W = band.shape
            K = band.shape[spec["contracted"]]
            out_w = W if spec["contracted"] == 1 else C
            v = torch.randn((S, Mp, K), generator=gen, device=DEV)
            errs.append(compare_pages(name, spec, band, v))
            # the band (tens to hundreds of MB) exceeds the L2: every launch
            # streams it from device memory
            ms += device_ms(lambda j: spec["fn"](band, v), reps=10)
            c_ms += call_ms(lambda j: spec["fn"](band, v), reps=10)
            plain_ms += call_ms(lambda j: spec["plain"](band, v), reps=5)
            lib_ms += device_ms(lambda j: spec["library"](band, v), reps=10)
            # what the card gives a PyTorch reduction that reads the band once
            read_ms += device_ms(lambda j: band.sum(), reps=10)
            bytes_ += 4 * (band.numel() + v.numel() + S * Mp * out_w)
            ops += 2 * S * band.numel()
            if grmv:
                check(pagekernels.GRMV_PATHS[pagekernels.band_grmv_last_path()] == "ring",
                      f"{name}: the band {tuple(band.shape)} did not take the ring kernel")
                rp = torch.randn((S, (A.pages + A.wpages) * PAGE), generator=gen, device=DEV)
                Rw = rp.as_strided((S, Mp, W), (rp.stride(0), PAGE, 1))
                errs.append(compare_pages(name, spec, band, Rw))
                win_ms += device_ms(lambda j: spec["fn"](band, Rw), reps=10)
                for path, key in enumerate(pagekernels.GRMV_PATHS):
                    path_ms[key] += device_ms(
                        lambda j: pagekernels.band_grmv_on_path(band, v, path), reps=10)
        b_ms, by = bound(bytes_, ops)
        per_s[S] = {"S": S, "bands": [list(b.shape) for b in A.bands], "ms": ms,
                    "call_ms": c_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "band_sum_ms": read_ms, "bound_ms": b_ms, "bound_by": by}
        if grmv:
            per_s[S].update(windowed_ms=win_ms, ms_over_library=ms / lib_ms,
                            windowed_ms_over_library=win_ms / lib_ms,
                            share_of_bound=b_ms / ms, ms_by_kernel=path_ms)
    one = per_s[1]
    return dict(max_abs_err=max(errs), ms=one["ms"], plain_ms=one["plain_ms"],
                bound_ms=one["bound_ms"], bound_by=one["bound_by"],
                library_ms=one["library_ms"], call_ms=one["call_ms"],
                per_s=list(per_s.values()))


# ----------------------------------------------- phase 3: the fused chunk


def _chunk_inputs(dp):
    bk = dp.buckets[0]
    t0 = 1.0 / bt.solvers.power_lipschitz(dp)
    return (dp.A.data, dp.b, feasible_init(dp)[0].contiguous(), bk.sizes, bk.radius, t0)


def random_chunk(m, B, w, seed):
    """A dense random problem for the fused chunk: ragged widths in 1..w, a
    radius per block, x0 the centre of each block's simplex, t0 just under
    1 / ||A||^2."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(1, w + 1, size=B).astype(np.int32)
    radius = rng.uniform(0.25, 1.0, size=B).astype(np.float32)
    mask = np.arange(w)[None, :] < widths[:, None]
    A = (rng.standard_normal((m, B * w)) / np.sqrt(m)).astype(np.float32)
    A *= mask.reshape(-1)[None, :]  # padding slots carry no column
    x_true = rng.random((B, w)) * mask
    x_true *= (radius / x_true.sum(1))[:, None]
    b = (A @ x_true.reshape(-1) + 0.05 * rng.standard_normal(m)).astype(np.float32)
    x0 = (mask * (radius / widths)[:, None]).astype(np.float32)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
    v = rng.standard_normal(B * w).astype(np.float32)
    for _ in range(40):  # power iteration for ||A||^2, on the host
        v = A.T @ (A @ (v / np.linalg.norm(v)))
    t0 = 1.0 / (1.05 * float(np.linalg.norm(v)))
    return (to(A), to(b), to(x0), to(widths), to(radius), t0), to(mask.astype(np.float32))


# (m, B, w, steps): widths 1, 4, 10, 33 and 128; fewer rows than blocks and no
# multiple of the grid; B*w no multiple of 4; one too large for the
# resident form (A of 32 MB), and one so tall that a block's rows of r and Ad
# do not fit shared memory either.  Each is held twice.  Over 15 (10) steps
# under every limit: these well-conditioned solves arrive after 25-30, and
# from there d is small, g.d cancels and the step length is rounding noise
# (two plain fp32 runs that sum the rows in another order jump from 1e-7 to
# 2e-5 apart in x there).  And over CHUNK_DEPTH steps, the depth of a launch
# on the solve path, under every limit that stays well conditioned there: the
# f-trace, the bit-for-bit repeat, feasibility and the descent of f; the
# distance in x is reported, not held.  tiny_dense is held over 200 in full.
CHUNK_SHAPES = ((37, 9, 1, 15), (1000, 61, 4, 15), (1531, 50, 10, 15), (1000, 33, 10, 15),
                (1000, 21, 33, 15), (37, 3, 10, 15), (1531, 7, 128, 15), (4096, 16, 128, 10),
                (900000, 2, 4, 10))
CHUNK_DEPTH = 100


def compare_chunk(name, label, fn, plain, args, mask, steps, expected=None, hold_x=True):
    """``steps`` steps against the plain loop (or its result ``expected``)
    under the limits, twice bit for bit, and the structure of x.  Without
    ``hold_x`` the distance in x is only reported.  Returns (x error, trace
    error)."""
    radius = args[4]
    x, f = fn(*args, steps)
    x2, f2 = fn(*args, steps)
    torch.cuda.synchronize()
    xp, fp = expected if expected is not None else plain(*args, steps)
    check(x.shape == xp.shape and f.shape == (steps,), f"{name} {label}: wrong output shapes")
    check(bool(torch.isfinite(x).all() and torch.isfinite(f).all()),
          f"{name} {label}: non-finite output")
    check(bool(torch.equal(f, f2) and torch.equal(x, x2)),
          f"{name} {label}: two launches on the same input differ")
    rel = float(((f - fp).abs() / torch.clamp(fp.abs(), min=1e-9)).max())
    check(rel <= CHUNK_TRACE_LIMIT, f"{name} {label}: f-trace differs by {rel:.2e} relative")
    err = float((x - xp).abs().max())
    check(not hold_x or err <= CHUNK_X_LIMIT, f"{name} {label}: x differs by {err:.2e}")
    check(float(x.min()) >= 0.0, f"{name} {label}: negative entry")
    check(float((x * (1 - mask)).abs().max()) == 0.0, f"{name} {label}: padding slot not zero")
    sums = (x * mask).sum(-1)
    check(float(((sums - radius).abs() / radius).max()) <= 1e-5,
          f"{name} {label}: block sums leave the radius")
    check(bool((f[1:] <= f[:-1] * (1 + 1e-5)).all()), f"{name} {label}: the objective rose")
    return err, rel


def check_chunk(name, spec, ctx):
    """200 steps on tiny_dense against the plain loop, twice, bit for bit; then
    ragged random problems of other widths and row counts, one of them too
    large for the resident form, each at a small step count and at the depth
    of a launch on the solve path.  Where the kernel takes the resident form
    the streaming form is held against the plain loop too."""
    dp = ctx["tiny"]
    args = _chunk_inputs(dp)
    err, rel = compare_chunk(name, "tiny_dense", spec["fn"], spec["plain"], args,
                             dp.buckets[0].mask, 200)
    # one step, and a step count that is no multiple of anything
    for steps in (1, 7):
        xs, fs = spec["fn"](*args, steps)
        xq, fq = spec["plain"](*args, steps)
        check(float((xs - xq).abs().max()) <= CHUNK_X_LIMIT
              and float(((fs - fq).abs() / fq.abs()).max()) <= CHUNK_TRACE_LIMIT,
              f"{name}: {steps} steps differ from the plain loop")
    blocks = torch.cuda.get_device_properties(DEV).multi_processor_count
    forms = set()
    streaming = lambda *a: chunkkernel.pgd_chunk_variant(*a, resident=False)
    cases = [("tiny_dense", args, dp.buckets[0].mask, 200,
              (dp.A.data.shape[0], *dp.buckets[0].mask.shape))]
    for i, (m, B, w, steps) in enumerate(CHUNK_SHAPES):
        rargs, mask = random_chunk(m, B, w, seed=50 + i)
        cases.append((f"m={m} B={B} w={w}", rargs, mask, steps, (m, B, w)))
    shapes, deep = [], {"x_abs": 0.0, "trace_rel": 0.0}
    for label, cargs, mask, steps, (m, B, w) in cases:
        plan = chunkkernel.chunk_plan(m, B, w, blocks)
        form = "resident" if plan["resident"] else "streaming"
        forms.add(form)
        forms.add("state in shared memory" if plan["local_state"] else "state in scratch")
        runs = [(form, spec["fn"])] + ([("streaming", streaming)] if plan["resident"] else [])
        for depth in (steps,) if label == "tiny_dense" else (steps, CHUNK_DEPTH):
            held = depth == steps
            expected = spec["plain"](*cargs, depth)
            for run_form, fn in runs:
                e, r = compare_chunk(name, f"{label}, {depth} steps ({run_form} form)", fn,
                                     spec["plain"], cargs, mask, depth, expected, hold_x=held)
                shapes.append({"m": m, "n": B * w, "w": w, "steps": depth, "form": run_form,
                               "x_abs_err": e, "trace_rel_err": r, "x_held": held})
                if held:
                    err, rel = max(err, e), max(rel, r)
                else:
                    deep = {"x_abs": max(deep["x_abs"], e), "trace_rel": max(deep["trace_rel"], r)}
    check(forms == {"resident", "streaming", "state in shared memory", "state in scratch"},
          f"{name}: the cases took only the forms {sorted(forms)}")
    ctx["chunk_err"] = {"x_abs": err, "trace_rel": rel, "deep": deep, "cases": shapes}
    return err, shapes, CHUNK_X_LIMIT


def measure_chunk(name, spec, ctx, steps=100):
    """One launch of ``steps`` iterations on tiny_dense, as solve makes it;
    then what a step is made of: the resident and the streaming form, other
    block counts, grid.sync() alone, and the clock sums of block 0 by phase."""
    dp = ctx["tiny"]
    args = _chunk_inputs(dp)
    m, n = dp.A.data.shape
    # a cooperative launch is timed between events, not in a graph; at a
    # fraction of a millisecond a launch the host's share is small
    ms = call_ms(lambda j: spec["fn"](*args, steps), reps=10)
    plain_ms = call_ms(lambda j: spec["plain"](*args, steps), reps=2, warm=1)
    bytes_ = 4 * (m * n + 2 * m + 2 * n + n + steps)  # A, b, x0, widths+radius, x, f
    ops = steps * (4 * m * n + 10 * n + 6 * m)
    b_ms, by = bound(bytes_, ops)

    variant = chunkkernel.pgd_chunk_variant
    blocks = torch.cuda.get_device_properties(DEV).multi_processor_count
    check(chunkkernel.chunk_plan(m, *dp.buckets[0].mask.shape, blocks)["resident"],
          f"{name}: tiny_dense does not take the resident form")
    # (the streaming form at this shape was held against the plain loop by check_chunk)
    forms = {form: call_ms(lambda j: variant(*args, steps, resident=res), reps=10) / steps
             for form, res in (("resident", True), ("streaming", False))}
    by_blocks = {nb: call_ms(lambda j: variant(*args, steps, resident=True, blocks=nb),
                             reps=10) / steps for nb in (33, 66, blocks)}
    n_bar = 3000
    barrier_us = 1e3 * chunkkernel.grid_barriers_ms(n_bar, blocks, DEV) / n_bar
    clk = variant(*args, steps, resident=True, clocks=True)[2].double()
    shares = dict(zip(chunkkernel.CLOCK_SLOTS, (clk / clk.sum()).tolist()))
    # the streaming form on an A that does not fit the resident one
    big, _ = random_chunk(4096, 16, 128, seed=57)
    big_ms = call_ms(lambda j: spec["fn"](*big, 20), reps=3, warm=1) / 20
    deep = ctx["chunk_err"]["deep"]
    return dict(max_abs_err=ctx["chunk_err"]["x_abs"], trace_rel_err=ctx["chunk_err"]["trace_rel"],
                x_abs_err_at_depth=deep["x_abs"], trace_rel_err_at_depth=deep["trace_rel"],
                depth=CHUNK_DEPTH,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
                steps_per_launch=steps, ms_per_step=ms / steps, bound_ms_per_step=b_ms / steps,
                ms_per_step_by_form=forms, ms_per_step_by_blocks=by_blocks,
                grid_sync_us=barrier_us, clock_shares_block0=shares,
                streaming_4096x2048_ms_per_step=big_ms)


# Every kernel brings its wrapper, its plain version, its cases (check) and
# its timing at the shapes of its path with its bound (measure).
# ------------------------------------------- phase 3: the ELL product kernel

# the kernel against the plain version, relative to the largest entry of the
# product: fp32 sums of the same products in another order
ELL_REL_LIMIT = 5e-4


@contextlib.contextmanager
def plain_products():
    """``ops.layout``'s products through their plain version on the card (the
    chain the kernel replaced), for as long as the block runs."""
    kernel = TL._ell_product
    TL._ell_product = TL._ell_product_plain
    try:
        yield
    finally:
        TL._ell_product = kernel


def _ell_rel(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


def ell_cases(ctx):
    """(label, matrix, operand width n, rows m) of the layouts the kernel
    serves: medium's row and column groups, the eq path's stacked operator
    (its top an unbucketed (1, m, kr) group read through r[..., :split]), and
    a column-sharded local ELL (rank 1 of two)."""
    from bsls_tpu_torch.models.partition import BlockPartition
    from bsls_tpu_torch.models.problem import ScaledMatrix, VStackMatrix

    dp = ctx["medium"]
    eq = ctx["eq_base"]
    perm = TL.build_pf_perm(eq.partition)
    stacked = TL.to_device_matrix(VStackMatrix(top=eq.A, bottom=ScaledMatrix(eq.C, 2.0)), perm,
                                  device=DEV)
    med = ctx["medium_base"]
    part2 = BlockPartition.from_sizes(med.partition.sizes, block_multiple=2)
    perm2 = TL.build_pf_perm(part2, 2)
    sharded = TL.to_device_matrix(med.A, perm2, n_shards=2, shard=(0, 1), device=DEV)
    return [("medium", dp.A, dp.n_pf, dp.num_rows),
            ("eq_stacked", stacked, perm.size, stacked.split + eq.C.shape[0]),
            ("column_shard", sharded, perm2.size // 2, med.A.shape[0])]


def check_ell(name, spec, ctx):
    """matvec and rmatvec through the kernel against the plain chain on the
    same CUDA tensors, at S = 1 (1-D and (1, n)), 32 and 128 on every case
    of ``ell_cases``; then more groups than one launch takes."""
    errs, shapes = [], []
    gen = torch.Generator(device=DEV).manual_seed(21)
    for label, A, n, m in ell_cases(ctx):
        for lead in ((), (1,), (32,), (128,)):
            x = torch.randn(*lead, n, generator=gen, device=DEV)
            r = torch.randn(*lead, m, generator=gen, device=DEV)
            got = (TL.matvec(A, x), TL.rmatvec(A, r))
            with plain_products():
                want = (TL.matvec(A, x), TL.rmatvec(A, r))
            for op, g, w in zip(("matvec", "rmatvec"), got, want):
                errs.append(_ell_rel(g, w))
                check(errs[-1] <= ELL_REL_LIMIT, f"{name}: {label} {op} at {lead} differs "
                      f"from the plain version by {errs[-1]:.2e} of its largest entry")
            shapes.append(f"{label} S={lead[0] if lead else '1-D'}")
    # eleven groups (two launches), a rank map and zero rows
    rng = np.random.default_rng(5)
    rows = [4000, 0, 2800, 4400, 1200, 2000, 0, 3200, 2400, 1600, 4000, 800, 2000]
    cols = [torch.from_numpy(rng.integers(0, 5000, (rw, 1 + i % 5 + i // 5)).astype(np.int32))
            .to(DEV) for i, rw in enumerate(rows)]
    vals = [torch.randn(c.shape, generator=gen, device=DEV) for c in cols]
    zeros = 300
    rank = torch.from_numpy(rng.permutation(zeros + sum(rows)).astype(np.int32)).to(DEV)
    for S in (1, 32, 128):
        vec = torch.randn(S, 5000, generator=gen, device=DEV)
        before = bt.launch_counts()["ell_gather_dot"]
        got = TL._ell_product(cols, vals, vec, zeros, rank)
        check(bt.launch_counts()["ell_gather_dot"] - before == 2,
              f"{name}: eleven groups did not take two launches")
        errs.append(_ell_rel(got, TL._ell_product_plain(cols, vals, vec, zeros, rank)))
        check(errs[-1] <= ELL_REL_LIMIT, f"{name}: eleven groups at S = {S}: {errs[-1]:.2e}")
        shapes.append(f"eleven_groups S={S}")
    torch.cuda.synchronize()
    return max(errs), shapes, ELL_REL_LIMIT


def _ell_csr(cols, vals, rows_out, n, zeros=0, rank=None):
    """The library's yardstick: the product's matrix as a CSR tensor in the
    output's row order (torch.sparse.mm over it; only this script calls it)."""
    out_row = (torch.arange(rows_out, device=DEV) if rank is None
               else torch.argsort(rank.long()))  # sorted row -> output row
    r_idx, c_idx, v_all, at = [], [], [], zeros
    for c, v in zip(cols, vals):
        rr = out_row[at:at + c.shape[0]][:, None].expand(c.shape)
        keep = v != 0
        r_idx.append(rr[keep])
        c_idx.append(c.long()[keep])
        v_all.append(v[keep])
        at += c.shape[0]
    idx = torch.stack([torch.cat(r_idx), torch.cat(c_idx)])
    coo = torch.sparse_coo_tensor(idx, torch.cat(v_all), (rows_out, n)).coalesce()
    return coo.to_sparse_csr()


def measure_ell(name, spec, ctx):
    """Each product of medium's step at S = 128 (and S = 1, 32): the kernel
    alone on the (n, S) operand (operands cycled past the L2, and one operand
    again and again, as the step's fresh transpose leaves it), the product
    as the step makes it (transpose in, kernel), the plain chain, the
    library's CSR product, and the bytes bound; for A^T r also the rank map
    left out of the kernel and applied by one index_select."""
    A, dp = ctx["medium"].A, ctx["medium"]
    prods = {"matvec": (A.mv_cols, A.mv_vals, 0, None, dp.n_pf, dp.num_rows),
             "rmatvec": (A.rt_rows, A.rt_vals, A.rt_zeros, A.rt_inv, dp.num_rows, dp.n_pf)}
    per_s, total = {}, {}
    gen = torch.Generator(device=DEV).manual_seed(23)
    for S in (1, 32, SCENARIOS):
        entry = {}
        for op, (cols, vals, zeros, rank, n_in_rows, rows_out) in prods.items():
            slots = sum(c.numel() for c in cols)
            n_in = inputs_in_turn(4 * n_in_rows * S)
            vts = [torch.randn((n_in_rows, S), generator=gen, device=DEV) for _ in range(n_in)]
            vecs = [vt.t().contiguous() for vt in vts]
            kern = lambda j: ellkernels.ell_gather_dot(cols, vals, vts[j % n_in], zeros, rank)
            fn = TL.matvec if op == "matvec" else TL.rmatvec
            b_bytes = 8 * slots + 4 * S * (n_in_rows + rows_out) + (
                0 if rank is None else 4 * rows_out)
            b_ms, by = bound(b_bytes, 2 * slots * S)
            e = {"ms": device_ms(kern), "warm_ms": device_ms(lambda j: kern(0)),
                 "product_ms": device_ms(lambda j: fn(A, vecs[j % n_in])),
                 "bound_ms": b_ms, "bound_by": by, "bytes": b_bytes, "slots": slots,
                 "groups": len(cols), "plan": list(ellkernels.ell_plan(S))}
            e["share_of_bound"] = b_ms / e["ms"]
            with plain_products():
                e["plain_ms"] = call_ms(lambda j: fn(A, vecs[j % n_in]), reps=4)
            csr = _ell_csr(cols, vals, rows_out, n_in_rows, zeros, rank)
            e["library_ms"] = device_ms(lambda j: torch.sparse.mm(csr, vts[j % n_in]))
            check(_ell_rel(torch.sparse.mm(csr, vts[0]).t(), kern(0)) <= ELL_REL_LIMIT,
                  f"{name}: the CSR yardstick differs from the kernel at S = {S}")
            if rank is not None:
                e["rank_by_index_select_ms"] = device_ms(
                    lambda j: ellkernels.ell_gather_dot(cols, vals, vts[j % n_in], zeros)
                    .index_select(1, rank))
            entry[op] = e
            del vts, vecs, csr
        per_s[S] = entry
    main = per_s[SCENARIOS]
    for key in ("ms", "product_ms", "plain_ms", "library_ms", "bound_ms"):
        total[key] = sum(main[op][key] for op in prods)
    return dict(max_abs_err=0.0, err_is="relative to the product's largest entry",
                ms=total["ms"], product_ms=total["product_ms"], plain_ms=total["plain_ms"],
                bound_ms=total["bound_ms"], bound_by="bytes", library_ms=total["library_ms"],
                share_of_bound=total["bound_ms"] / total["ms"],
                per_s={str(S): e for S, e in per_s.items()})


# ------------------------------------------- phase 3: the step kernels

# one step through the three step kernels against the chain they replaced,
# on the same inputs: x, r, f and the gap relative to their largest entry
STEP_REL_LIMIT = 1e-5
STEP_KERNELS = ("step_prep", "step_dir", "step_update")


def _stacked(prob, scale=2.0, seed=7):
    """The eq path's stacked operator [A; scale C] of ``prob`` as a device
    problem, with a random bottom of the right-hand side."""
    from bsls_tpu_torch.models.problem import ScaledMatrix, VStackMatrix

    plain = dataclasses.replace(prob, C=None, d=None)
    dp = bt.prepare(plain, device=DEV, layout="gather")
    perm = TL.build_pf_perm(plain.partition)
    V = TL.to_device_matrix(VStackMatrix(top=plain.A, bottom=ScaledMatrix(prob.C, scale)), perm,
                            device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    bottom = torch.randn(dp.b.shape[:-1] + (prob.C.shape[0],), generator=gen, device=DEV)
    return dataclasses.replace(dp, A=V, b=torch.cat([dp.b, bottom], dim=-1))


def step_cases(ctx):
    """(label, device problem) of the shapes the step kernels serve in the
    cells: medium x 128 (two buckets), traffic_like's stacked operator x 128
    (four buckets), config 4 x 4 (one bucket, 1M blocks), and medium at the
    stream's padded batches S = 1, 8 and 32 (the first S rows of its b):
    step_dir's scalar transposed stores (S < 4) and apply's last block
    folding over 32, 16 or 2 lanes a scenario."""
    if "large4" not in ctx:
        ctx["large4"] = bt.prepare(bt.synthetic.large_sharded(seed=0), device=DEV,
                                   layout="gather")
        ctx["eq128"] = _stacked(ctx["eq_prob"])
    medium = ctx["medium"]
    return [("medium128", medium), ("eq128", ctx["eq128"]), ("large4", ctx["large4"]),
            *((f"medium{S}", dataclasses.replace(medium, b=medium.b[:S].contiguous()))
              for S in (1, 8, 32))]


def _step_state(dp, steps=3):
    from bsls_tpu_torch.solvers import base as B, pgd

    opts = B.SolveOptions()
    L = B.lipschitz_tensor(B.power_lipschitz(dp), DEV)
    st = pgd.init(dp, L, opts)
    for _ in range(steps):
        st = pgd.step(dp, st, L, opts)
    return st, L, opts


def _chain_step(dp, st, L):
    """The step through the step kernels' plain versions on the card (the
    products making their own transposes): the chain they replaced."""
    from bsls_tpu_torch.solvers import base as B, pgd

    return pgd._exact_step(dp, st, L, B.SolveOptions(), False)


def _device_ops(fn):
    """Device operations (kernels, copies, sets) of one call, by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA)


def check_step(name, spec, ctx):
    """One step through the kernels against the chain on the same inputs at
    each of ``step_cases``, and the kernels' launches a step."""
    from bsls_tpu_torch.solvers import pgd

    errs, shapes = [], []
    for label, dp in step_cases(ctx):
        st, L, opts = _step_state(dp)
        check(pgd.fused_step(dp, opts, st), f"{name}: {label} does not take the step kernels")
        before = bt.launch_counts()
        got = pgd.step(dp, st, L, opts)
        torch.cuda.synchronize()
        after = bt.launch_counts()
        check(tuple(after[k] - before[k] for k in STEP_KERNELS) == (1, 1, 2),
              f"{name}: {label}: a step did not take one step_prep, one step_dir and two "
              "step_update launches")
        want = _chain_step(dp, st, L)
        for field, a, b in (("x", TL.padded_to_flat(dp, got.xp), TL.padded_to_flat(dp, want.xp)),
                            ("r", got.r, want.r), ("f", got.f, want.f),
                            ("gap", got.gap, want.gap)):
            errs.append(_ell_rel(a, b))
            check(errs[-1] <= STEP_REL_LIMIT, f"{name}: {label}: {field} differs from the "
                  f"chain's by {errs[-1]:.2e} of its largest entry")
        again = pgd.step(dp, st, L, opts)
        check(all(torch.equal(a, b) for a, b in zip((*got.xp, got.r, got.f, got.gap),
                                                     (*again.xp, again.r, again.f, again.gap))),
              f"{name}: {label}: a step does not repeat itself bit for bit")
        shapes.append(label)
        del st, got, want, again
    torch.cuda.synchronize()
    return max(errs), shapes, STEP_REL_LIMIT


def measure_step(name, spec, ctx):
    """Each step kernel at medium x 128 and config 4 x 4, device time of one
    launch on inputs cycled past the L2, beside its bytes once over 3.35 TB/s
    and its plain version (the chain's passes for the same stretch, eager, as
    the solver made them); the device operations of one eager step through
    the kernels and through the chain.  ``step_update``'s bound reads Ad
    once; its two passes read it twice (Ad.Ad is summed over every block
    before t, and so r + t Ad, can be formed): ``two_pass_bytes``."""
    from bsls_tpu_torch.ops import projection, quadratic as Q
    from bsls_tpu_torch.solvers import pgd

    SK = stepkernels
    per_case = {}
    for label, dp in [c for c in step_cases(ctx) if c[0] in ("medium128", "large4")]:
        st, L, opts = _step_state(dp)
        S, n = st.x_prev.shape
        m = st.r.shape[1]
        n_in = inputs_in_turn(4 * S * n)
        ins = []
        for _ in range(n_in):
            g = Q.grad_flat(dp, st.r)
            xp = tuple(x.clone() for x in st.xp)
            cand, x_flat, gparts = SK.step_prep(dp, xp, g, st.f, L, 0.0)
            xhat = projection.proj_blocks(cand, dp.buckets)
            d = SK.step_dir(dp, xhat, xp, x_flat, g)
            Ad = TL.matvec_ps(dp, d.flat, d.operand)
            ins.append(dict(xp=xp, g=g, x_flat=x_flat, gparts=gparts, xhat=xhat, d=d, Ad=Ad,
                            r=st.r.clone()))
        at = lambda i: ins[i % n_in]
        vec = 4 * S * n
        bytes_ = {"step_prep": 4 * vec + 8 * sum(bk.sizes.numel() for bk in dp.buckets),
                  "step_dir": vec * (4 + (1 if TL.takes_operand(dp.A) else 0)),
                  # x and d read, x written; r and Ad read, r written
                  "step_update": 3 * vec + 3 * 4 * S * m}
        runs = {
            "step_prep": lambda i: SK.step_prep(dp, at(i)["xp"], at(i)["g"], st.f, L, 0.0),
            "step_dir": lambda i: SK.step_dir(dp, at(i)["xhat"], at(i)["xp"], at(i)["x_flat"],
                                              at(i)["g"]),
            "step_update": lambda i: SK.step_update(dp, at(i)["xp"], at(i)["x_flat"], at(i)["r"],
                                                    at(i)["d"], at(i)["Ad"], at(i)["gparts"]),
        }
        # the plain versions write in place (xhat, d, Ad): repeated calls
        # drift the values, not the work
        plain_d = [SK.dir_plain(dp, tuple(x.clone() for x in a["xhat"]), a["xp"], a["x_flat"],
                                 a["g"]) for a in ins]
        plain_Ad = [a["Ad"].clone() for a in ins]
        plains = {
            "step_prep": lambda i: SK.prep_plain(dp, at(i)["xp"], at(i)["g"], st.f, L, 0.0),
            "step_dir": lambda i: SK.dir_plain(dp, at(i)["xhat"], at(i)["xp"], at(i)["x_flat"],
                                               at(i)["g"]),
            "step_update": lambda i: SK.update_plain(dp, at(i)["xp"], at(i)["x_flat"],
                                                     at(i)["r"], plain_d[i % n_in],
                                                     plain_Ad[i % n_in], None),
        }
        e = {}
        for k in STEP_KERNELS:
            b_ms, by = bound(bytes_[k], 0)
            e[k] = {"ms": device_ms(runs[k]), "bound_ms": b_ms, "bytes": bytes_[k],
                    "plain_ms": call_ms(plains[k], reps=5)}
            e[k]["share_of_bound"] = b_ms / e[k]["ms"]
        e["step_update"]["two_pass_bytes"] = bytes_["step_update"] + 4 * S * m
        e["operand_transpose_ms"] = device_ms(
            lambda i: at(i)["d"].flat.t().contiguous())  # what the product no longer makes
        e["device_ops_a_step"] = {
            "kernels": _device_ops(lambda: pgd.step(dp, st, L, opts)),
            "chain": _device_ops(lambda: _chain_step(dp, st, L))}
        e["step_ms"] = {"kernels": call_ms(lambda i: pgd.step(dp, st, L, opts), reps=10),
                        "chain": call_ms(lambda i: _chain_step(dp, st, L), reps=10)}
        e["shape"] = {"S": S, "n_pf": n, "m": m, "buckets": len(dp.buckets)}
        per_case[label] = e
        del ins, plain_d, plain_Ad, st
        torch.cuda.empty_cache()
    main = per_case["medium128"]
    total = {key: sum(main[k][key] for k in STEP_KERNELS) for key in ("ms", "bound_ms",
                                                                      "plain_ms")}
    return dict(max_abs_err=0.0, err_is="relative to the largest entry of x, r, f and the gap",
                ms=total["ms"], bound_ms=total["bound_ms"], bound_by="bytes",
                plain_ms=total["plain_ms"], library_ms=None,
                share_of_bound=total["bound_ms"] / total["ms"], per_case=per_case)


KERNELS = {
    "proj_simplex_rows": dict(
        fn=rowkernels.proj_simplex_rows, buckets_fn=rowkernels.proj_simplex_buckets,
        plain=lambda v, widths, radius: proj_simplex_padded(v, _mask(v, widths), radius),
        source="bsls_tpu_torch/csrc/proj_simplex_rows.cu",
        # the lane-major kernel; its row-major twin is projection_kernel.py:187
        replaces="bsls_tpu/ops/pallas/projection_kernel.py:132",
        check=check_every_width, measure=measure_rows, structure=_proj_structure,
        check_widths=PROJ_CHECK_WIDTHS, structure_kw={"large": {"rowsum_rel": LARGE_ROWSUM_REL}},
        widths_of=lambda bk: bk.sizes,
        plan=lambda w: list(rowkernels.PROJ_PLAN[w]),
        # per row, thread form: the network's comparators of 2 operations,
        # ~10 more per slot (scan, Newton step, output); group form: w^2
        # compare-and-adds of 3 operations, ~10 more per slot
        ops_per_row=lambda w: (2 * sort_comparators(w) if rowkernels.PROJ_PLAN[w][0] == "thread"
                               else 3 * w * w) + 10 * w,
    ),
    "pava_rows": dict(
        fn=rowkernels.pava_rows, buckets_fn=rowkernels.pava_buckets,
        # in float64: the float32 plain version's prefix-sum differences are
        # up to 4e-5 x the radius off on rows within 100x the radius, more
        # than the kernel's running sums
        plain=lambda v, widths, radius: pava_padded(
            v.double(), _mask(v, widths).double(), 0.0, radius.double(), chunk=1 << 16).float(),
        # what the port's CPU path runs, timed as the plain version
        timed_plain=lambda v, widths, radius: pava_padded(v, _mask(v, widths), 0.0, radius,
                                                          chunk=1 << 17),
        source="bsls_tpu_torch/csrc/pava_rows.cu",
        # the lane-major kernel; its row-major twin is pava_kernel.py:181
        replaces="bsls_tpu/ops/pallas/pava_kernel.py:132",
        check=check_every_width, measure=measure_rows, structure=_pava_structure,
        check_widths=PAVA_CHECK_WIDTHS, structure_kw={},
        widths_of=lambda bk: bk.zwidths,
        plan=lambda w: list(rowkernels.PAVA_PLAN[w]),
        # every form carries a NaN over a row's fitted slots: thread forms
        # (3, 4, 8, 12) and stack forms of each rows a block (24, 32, 48,
        # 100, 128)
        nan_widths=(3, 4, 8, 12, 24, 32, 48, 100, 128),
        sweep_widths=(3, 5, 12, 17, 24, 33, 48, 64, 100, 128),
        # the same work at every width and in every form: the linear
        # pool-adjacent-violators' ~14 operations a slot (pushes, pops,
        # expansion, clip), so the bound is the bytes bound and shares compare
        # across forms
        ops_per_row=lambda w: 14 * w,
    ),
    "band_zmv": dict(
        fn=pagekernels.band_zmv, plain=pagekernels.band_zmv_plain,
        # one PyTorch call for the same product, at full fp32 (TF32 is off)
        library=lambda band, x: torch.bmm(x.transpose(0, 1), band),
        source="bsls_tpu_torch/csrc/band_pages.cu",
        replaces="bsls_tpu/ops/pallas/banded_kernels.py:63",
        check=check_pages, measure=measure_pages, contracted=1,
    ),
    "band_grmv": dict(
        fn=pagekernels.band_grmv, plain=pagekernels.band_grmv_plain,
        library=lambda band, r: torch.bmm(r.transpose(0, 1), band.transpose(1, 2)),
        source="bsls_tpu_torch/csrc/band_pages.cu",
        replaces="bsls_tpu/ops/pallas/banded_kernels.py:86",
        check=check_pages, measure=measure_pages, contracted=2,
    ),
    "pgd_chunk": dict(
        fn=chunkkernel.pgd_chunk, plain=chunkkernel.pgd_chunk_plain,
        source="bsls_tpu_torch/csrc/pgd_chunk.cu",
        replaces="bsls_tpu/ops/pallas/megastep_kernel.py:152",
        check=check_chunk, measure=measure_chunk,
    ),
    "ell_gather_dot": dict(
        source="bsls_tpu_torch/csrc/ell_products.cu",
        replaces=None,  # the reference's products are XLA gathers (ops/layout.py:902)
        check=check_ell, measure=measure_ell,
    ),
    # one row for the three kernels of the exact step (step_prep, step_dir,
    # step_update); its launches sum theirs
    "pgd_step": dict(
        source="bsls_tpu_torch/csrc/pgd_step.cu",
        replaces=None,  # the reference's step is XLA's fusion (bsls_tpu/solvers/pgd.py)
        check=check_step, measure=measure_step,
    ),
}


def phase_kernels(ctx):
    """Each kernel against its plain version on its own cases, then timed at
    the shapes its path gives it.  Returns the per-kernel numbers of the last
    JSON line but one."""
    report = {}
    for name, spec in KERNELS.items():
        t0 = time.perf_counter()
        err, shapes, limit = spec["check"](name, spec, ctx)
        nums = spec["measure"](name, spec, ctx)
        nums["max_abs_err"] = max(err, nums["max_abs_err"])
        report[name] = {"name": name, "route": "cuda", "source": spec["source"],
                        "replaces": spec["replaces"], "launches": 0, **nums}
        emit("kernels", kernel=name, limit=limit, cases=len(shapes),
             secs=round(time.perf_counter() - t0, 1),
             shapes_checked=shapes if len(shapes) <= 40 else shapes[:6] + ["..."] + shapes[-2:],
             **nums)
    return report


# --------------------------------------------------------------- the solves


def f64_objective(prob, x, scenario):
    A = prob.A.to_scipy().astype(np.float64)
    b = np.asarray(prob.b, np.float64)
    xs, bs = (x, b) if b.ndim == 1 else (x[scenario], b[scenario])
    r = A @ xs.astype(np.float64) - bs
    return 0.5 * float(r @ r)


def phase_solve(phase, prob, dp, line_search, max_iter, kernels, method="pgd", space="x",
                lipschitz=None, chunk=100):
    """One path: ``solve`` on a prepared instance.  The launch counts are set
    to 0 just before and read just after; each kernel of ``kernels`` must
    have been launched at least once per iteration.  Every
    family checked here descends by construction (apgd by its safeguard, the
    others by an exact step clipped to [0, 1]), so the objective must not
    rise between chunk ends."""
    def run(iters=max_iter):
        return bt.solve(dp, method=method, line_search=line_search, space=space, tol=0.0,
                        max_iter=iters, chunk=chunk, lipschitz=lipschitz)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    snap = graph_since()
    res = run()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    graph_stats = graph_since(snap)

    multi = dp.b.ndim == 2
    S, n_buckets = (dp.b.shape[0] if multi else 1), len(dp.buckets)
    lead = (S,) if multi else ()
    check(res.x.shape == lead + (prob.partition.n_flat,), f"{phase}: x has shape {res.x.shape}")
    check(res.trace_f.shape == lead + (max_iter,), f"{phase}: trace has shape {res.trace_f.shape}")
    check(bool(np.isfinite(res.trace_f).all() and np.isfinite(res.x).all()),
          f"{phase}: non-finite objective or x")
    x, trace = np.atleast_2d(res.x), np.atleast_2d(res.trace_f)
    ends = trace[:, chunk - 1::chunk].astype(np.float64)
    check(bool(np.all(ends[:, 1:] <= ends[:, :-1] * (1 + 1e-4))),
          f"{phase}: objective rose between chunk ends")
    # pgd descends from one chunk end to the next at this budget; the other
    # families (L-BFGS above all) may reach the fp32 floor inside the first
    # chunk, so their descent is counted from the first iteration
    start = ends[:, 0] if method == "pgd" else trace[:, 0].astype(np.float64)
    check(bool(np.all(ends[:, -1] < start)), f"{phase}: no descent")
    sizes = prob.partition.sizes
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    sums = np.add.reduceat(x.astype(np.float64), offs, axis=1)
    check(float(x.min()) >= 0.0 and float(np.abs(sums - 1.0).max()) <= 1e-5,
          f"{phase}: x is not feasible (block sums off by {np.abs(sums - 1).max():.2e})")
    f64 = f64_objective(prob, res.x, 0)
    f32 = float(np.atleast_1d(res.objective)[0])
    check(abs(f64 - f32) <= 1e-4 * max(1.0, abs(f64)),
          f"{phase}: device objective {f32} vs float64 host objective {f64}")
    for kernel in kernels:
        # the row kernels take one launch a call for all buckets (read_counts
        # holds it): at least one an iteration
        check(counts[kernel] >= max_iter,
              f"{phase}: {kernel} launched {counts[kernel]} times, expected >= {max_iter}")
    emit(phase, method=method, space=space, line_search=line_search, chunk=chunk,
         iterations=res.iterations, scenarios=S,
         aggregate_iters_per_sec=S * res.steady_iters_per_sec(),
         chunk_secs=[round(float(t), 4) for t in res.chunk_times],
         objective_s0=f32, objective_s0_f64=f64,
         objective_max=float(np.max(res.objective)),
         launches=counts, buckets=n_buckets, peak_bytes=peak,
         captures=graph_stats["captures"], capture_secs=graph_stats["capture_secs"],
         graph_pool_bytes=graph_stats["pool_bytes"][-1:],
         graph_vs_eager=graph_twin(phase, lambda: run(min(max_iter, GRAPH_TWIN_CHUNKS * chunk)),
                                   solve_ends))
    return counts


def phase_cross_check(base):
    """The port on the card against the port on the CPU (plain versions)."""
    prob = bt.synthetic.with_scenarios(base, 4, seed=1)
    dp_gpu = bt.prepare(prob, layout="gather", device=DEV)
    L_est = bt.solvers.power_lipschitz(dp_gpu)
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=200, chunk=100,
              lipschitz=L_est)
    on_card = bt.solve(dp_gpu, **kw)
    on_cpu = bt.solve(bt.prepare(prob, layout="gather", device="cpu"), **kw)
    # fp32 on both, sums in another order, 200 steps deep
    rel = np.abs(on_card.trace_f - on_cpu.trace_f) / np.abs(on_cpu.trace_f)
    check(float(rel.max()) <= 1e-3, f"cross_check: traces differ by {rel.max():.2e} relative")
    check(float(np.abs(on_card.x - on_cpu.x).max()) <= 1e-3, "cross_check: x differs")
    emit("cross_check", scenarios=4, iterations=200, max_rel_trace_diff=float(rel.max()),
         max_abs_x_diff=float(np.abs(on_card.x - on_cpu.x).max()))


def phase_float64_refused(ctx, base):
    """A float64 solve with the card as its device (an unconstrained one, an
    equality-constrained one, an endpoint) raises ValueError, naming the
    float32-only kernels, before anything is uploaded."""
    cases = {"solve": lambda: bt.solve(bt.synthetic.with_scenarios(base, 4, seed=1),
                                       dtype=torch.float64, device=DEV, max_iter=10),
             "solve_eq": lambda: bt.solve(ctx["eq_prob4"], dtype=torch.float64, device=DEV,
                                          max_iter=10),
             "endpoint": lambda: bt.Endpoint(base, dtype=torch.float64, device=DEV)}
    messages = {}
    for case, run in cases.items():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(DEV)
        try:
            run()
        except ValueError as e:
            messages[case] = str(e)
        check(case in messages, f"float64_refused: {case} in float64 on the card was not refused")
        check(torch.cuda.memory_allocated(DEV) == before,
              f"float64_refused: {case} uploaded before it was refused")
        check(all(k in messages[case] for k in KERNELS),
              f"float64_refused: {case}'s message names not every kernel: {messages[case]}")
    emit("float64_refused", messages=messages)


def prepare_banded(base, scenarios):
    """``prepare`` of medium_banded under ``layout="auto"``: must pick the band."""
    prob = base if scenarios == 1 else bt.synthetic.with_scenarios(base, scenarios, seed=1)
    t0 = time.perf_counter()
    dp = bt.prepare(prob, device=DEV)
    secs = time.perf_counter() - t0
    A = dp.A
    check(isinstance(A, DeviceBanded), f"prepare(medium_banded x {scenarios}) chose "
          f"{type(A).__name__}, not the banded layout")
    band_nnz = sum(int((b != 0).sum()) for b in A.bands)
    resid_nnz = 0 if A.resid is None else int((A.resid.vals != 0).sum())
    info = dict(scenarios=scenarios, back=A.back, wpages=A.wpages, pages=A.pages,
                bands=[list(b.shape) for b in A.bands],
                band_bytes=sum(4 * b.numel() for b in A.bands),
                fit_fraction=band_nnz / max(band_nnz + resid_nnz, 1),
                residual_nonzeros=resid_nnz, n_pf=int(dp.n_pf),
                prepare_secs=round(secs, 2))
    return prob, dp, info


def phase_solve_banded(ctx, max_iter=500):
    """The preset medium-banded (pgd, bbm) for S = 1 and S = 4; then the two
    layouts of the same instance against each other at a fixed budget."""
    counts = {}
    for S, dp in sorted(ctx["banded"].items()):
        emit("instance_banded", name=ctx["banded_prob"][S].name, **ctx["banded_info"][S])
        counts[S] = phase_solve(f"solve_banded_s{S}", ctx["banded_prob"][S], dp, "bbm", max_iter,
                                ("band_zmv", "band_grmv"))
    base = ctx["banded_prob"][1]
    # the same trial step for both: each layout's own power iteration starts
    # from another vector (the PF orders differ) and ends a few percent apart
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=300, chunk=100,
              lipschitz=bt.solvers.power_lipschitz(ctx["banded"][1]))
    rb = bt.solve(bt.prepare(base, layout="banded", device=DEV), **kw)
    rg = bt.solve(bt.prepare(base, layout="gather", device=DEV), **kw)
    fb, fg = float(rb.objective), float(rg.objective)
    check(abs(fb - fg) <= 5e-4 * abs(fg) + 1e-6,
          f"solve_banded: forced banded {fb} vs gather {fg} after 300 iterations")
    emit("banded_vs_gather", iterations=300, objective_banded=fb, objective_gather=fg,
         rel_diff=abs(fb - fg) / abs(fg),
         iters_per_sec_banded=rb.steady_iters_per_sec(),
         iters_per_sec_gather=rg.steady_iters_per_sec())
    return counts[1]


def phase_solve_mega(ctx, max_iter=1000, chunk=100):
    """The fused chunk through ``solve``: the gate is set here and restored;
    one launch per chunk (and the warm-up's), and the trace of the eager path
    of the same solve; the time of a step fused, as a graph replay and
    eager."""
    prob = ctx["tiny_prob"]
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=max_iter, chunk=chunk,
              lipschitz=bt.solvers.power_lipschitz(ctx["tiny"]), device=DEV)
    saved = {k: os.environ.get(k) for k in ("BSLS_MEGA", "BSLS_NO_MEGA")}
    try:
        os.environ.pop("BSLS_NO_MEGA", None)
        os.environ["BSLS_MEGA"] = "1"
        mega.use_mega.cache_clear()
        bt.solve(prob, **{**kw, "max_iter": chunk})  # first launch, outside the timing
        reset_counts()
        fused = bt.solve(prob, **kw)
        counts = read_counts()
        os.environ["BSLS_MEGA"] = "0"
        mega.use_mega.cache_clear()
        graphed = bt.solve(prob, **kw)
        with eager_chunks():
            eager = bt.solve(prob, **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        mega.use_mega.cache_clear()
    # one launch per chunk, and one more: solve's warm-up chunk before its clock
    check(counts["pgd_chunk"] == max_iter // chunk + 1,
          f"solve_mega: pgd_chunk launched {counts['pgd_chunk']} times for "
          f"{max_iter // chunk} chunks and the warm-up")
    check(counts["proj_simplex_rows"] == 1,
          f"solve_mega: {counts['proj_simplex_rows']} projection launches; the fused path "
          "makes one (the final projection)")
    check(fused.trace_f.shape == eager.trace_f.shape == (max_iter,), "solve_mega: trace shape")
    check(bool(np.isfinite(fused.trace_f).all() and np.isfinite(fused.x).all()),
          "solve_mega: non-finite objective or x")
    rel = np.abs(fused.trace_f - eager.trace_f) / np.abs(eager.trace_f)
    check(float(rel.max()) <= 1e-3, f"solve_mega: trace differs from the eager path by "
          f"{rel.max():.2e} relative")
    check(float(np.abs(fused.x - eager.x).max()) <= 2e-4, "solve_mega: x differs from eager")
    check(bool(np.all(fused.trace_gap[:chunk] == fused.trace_gap[chunk - 1])),
          "solve_mega: the gap trace does not repeat the boundary value")
    f64 = f64_objective(prob, fused.x, 0)
    check(abs(f64 - float(fused.objective)) <= 1e-4 * max(1.0, abs(f64)),
          f"solve_mega: device objective {float(fused.objective)} vs float64 {f64}")
    per_step = lambda r: 1e3 * float(np.sum(r.chunk_times[1:])) / (max_iter - chunk)
    check(np.array_equal(graphed.trace_f[:chunk], eager.trace_f[:chunk])
          or _rel_diff(graphed.trace_f[:chunk], eager.trace_f[:chunk]) <= GRAPH_TRACE_LIMIT,
          "solve_mega: the graphed first chunk differs from the eager one")
    emit("solve_mega", iterations=fused.iterations, chunks=max_iter // chunk, launches=counts,
         max_rel_trace_diff=float(rel.max()), max_abs_x_diff=float(np.abs(fused.x - eager.x).max()),
         objective=float(fused.objective), objective_f64=f64,
         fused_ms_per_step=per_step(fused), graphed_ms_per_step=per_step(graphed),
         eager_ms_per_step=per_step(eager),
         fused_iters_per_sec=fused.steady_iters_per_sec(),
         graphed_iters_per_sec=graphed.steady_iters_per_sec(),
         eager_iters_per_sec=eager.steady_iters_per_sec())
    return counts, per_step(eager), per_step(graphed)

# ------------------------------------------- the other five solver families

# (method, space, kernels its steps launch, chunk).  apgd carries the residual
# at its extrapolated point incrementally, as the reference does, and its
# running objective drifts from its iterate's by about chunk^1.5: at medium
# x 2 in float32 on a CPU 1.4e-3 after 100 steps, 4.3e-5 after 20 and 2.9e-5
# after 10; on the card 1.1e-4 after 20.  A refresh every 10 iterations keeps
# it inside the 1e-4 of the objective check.
FAMILIES = (
    ("apgd", "x", ("proj_simplex_rows",), 10),
    ("eg", "x", (), 100),
    ("frank_wolfe", "x", (), 100),
    ("afw", "x", (), 100),
    ("lbfgs", "x", ("proj_simplex_rows",), 100),
    ("lbfgs", "z", ("pava_rows",), 100),
)
# the card against the CPU, and one layout against the other, where sums run
# in another order.  Whole traces of lbfgs and afw part by more than 1e-3
# within 10 to 40 iterations and meet again at the end: afw's near-tied
# vertex choices and L-BFGS's projection-arc active sets flip with the order of
# a sum (on the card, afw against the CPU at medium x 4 passed 1e-3 after 13
# iterations; the ends agreed to 1e-5).  So these phases take one step from
# the same state at every chunk end on both sides and hold the float64
# objectives of the two iterates it gives at ONE_STEP_LIMIT, and the ends of
# the solves that converge at the limit of the earlier phases.  Near the
# optimum the fp32 residual r = Ax - b cancels, and the gradient of each side
# carries ~1e-5 relative error: one step from the same iterate of an
# 80-block corridor instance gave objectives 2e-5 apart on the two layouts.
ONE_STEP_LIMIT = 1e-4


def _state_to(st, device):
    """A solver state or a prepared problem (frozen dataclasses of tensors,
    tuples of tensors and nested dataclasses) on another device."""
    def move(v):
        if isinstance(v, tuple):
            return tuple(move(a) for a in v)
        if dataclasses.is_dataclass(v):
            return _state_to(v, device)
        return v.to(device) if isinstance(v, torch.Tensor) else v

    return type(st)(**{f.name: move(getattr(st, f.name)) for f in dataclasses.fields(st)
                       if f.init})


def _states_at_chunk_ends(dp, method, kw):
    """``solve`` with a callback that keeps the state at every chunk end."""
    seen = []
    res = bt.solve(dp, method=method, callback=lambda it, st: seen.append(st), **kw)
    return res, seen


def _one_step_diff(prob, mod, opts, L_est, dp_a, st_a, dp_b, st_b):
    """One step from the same iterate on two problems: the largest relative
    difference of the float64 objectives of the two iterates it gives."""
    from bsls_tpu_torch.ops.layout import extract_user_flat

    fs = [prob.objective_np(extract_user_flat(d, mod.step(d, st, L_est, opts).xp)
                            .double().cpu().numpy())
          for d, st in ((dp_a, st_a), (dp_b, st_b))]
    return float(np.max(np.abs(fs[0] - fs[1]) / np.abs(fs[1])))


def family_lipschitz(dp):
    return {"x": bt.solvers.power_lipschitz(dp), "z": bt.solvers.power_lipschitz_z(dp)}


def phase_solve_families(prob, dp, max_iter=200):
    """The five other families (and z-space L-BFGS) through ``solve`` on
    medium x 128, one shared ``lipschitz=`` per curvature kind."""
    lips = family_lipschitz(dp)
    total = {}
    for method, space, kernels, chunk in FAMILIES:
        counts = phase_solve(f"solve_{method}" + ("_z" if space == "z" else ""), prob, dp,
                             "exact", max_iter, kernels, method=method, space=space,
                             lipschitz=lips[space], chunk=chunk)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    emit("solve_families", families=[m + ("_z" if sp == "z" else "") for m, sp, _, _ in FAMILIES],
         lipschitz=lips, launches=total)
    return total


def phase_cross_check_families(base):
    """lbfgs and afw: the port on the card against the port on the CPU, one
    step from the card's state (L-BFGS memory included) at every chunk end,
    and the ends of both solves."""
    from bsls_tpu_torch.solvers.base import SolveOptions, _get_solver

    prob = bt.synthetic.with_scenarios(base, 4, seed=1)
    dp_gpu = bt.prepare(prob, layout="gather", device=DEV)
    dp_cpu = bt.prepare(prob, layout="gather", device="cpu")
    L_est = bt.solvers.power_lipschitz(dp_gpu)
    kw = dict(tol=0.0, max_iter=200, chunk=50, lipschitz=L_est)
    out = {}
    for method in ("lbfgs", "afw"):
        on_card, states = _states_at_chunk_ends(dp_gpu, method, kw)
        on_cpu = bt.solve(dp_cpu, method=method, **kw)
        opts, mod = SolveOptions(method=method), _get_solver(method)
        steps = [_one_step_diff(prob, mod, opts, L_est, dp_gpu, st, dp_cpu, _state_to(st, "cpu"))
                 for st in states]
        check(max(steps) <= ONE_STEP_LIMIT, f"cross_check_families: {method}, one step from "
              f"the same state differs by {max(steps):.2e} relative on the card and the CPU")
        rel = np.abs(on_card.trace_f - on_cpu.trace_f) / np.abs(on_cpu.trace_f)
        check(float(rel[:, -1].max()) <= 1e-3,
              f"cross_check_families: {method} ends differ by {rel[:, -1].max():.2e} relative")
        past = np.nonzero(rel.max(0) > 1e-3)[0]
        out[method] = dict(one_step_rel_diff_by_chunk_end=steps,
                           max_rel_end_diff=float(rel[:, -1].max()),
                           first_iteration_past_1e_3=int(past[0]) if past.size else None,
                           max_rel_trace_diff=float(rel.max()),
                           max_abs_x_diff=float(np.abs(on_card.x - on_cpu.x).max()))
    emit("cross_check_families", scenarios=4, iterations=200, **out)


def _fw_gap_rel(prob, X):
    """Float64 objective and FW duality gap g.x - sum_b min g of each row of
    X, the gap relative (gap / max(1, |f|)), and the relative size of the
    terms the gap is the difference of (its float64 rounding scales with it)."""
    A = prob.A.to_scipy().astype(np.float64).tocsr()
    B = np.atleast_2d(np.asarray(prob.b, np.float64))
    X = np.atleast_2d(np.asarray(X, np.float64))
    R = (A @ X.T).T - B
    G = (A.T @ R.T).T
    f = 0.5 * (R * R).sum(-1)
    offs = np.concatenate([[0], np.cumsum(prob.partition.sizes)[:-1]])
    mins = np.minimum.reduceat(G, offs, axis=1)
    gaps = (G * X).sum(-1) - mins.sum(-1)
    terms = np.abs(G * X).sum(-1) + np.abs(mins).sum(-1)
    norm = np.maximum(1.0, np.abs(f))
    return f, gaps / norm, terms / norm


def _repaired(prob, X):
    """X clipped at 0 and renormalised per block in float64: the feasible
    point that refine_polish starts from."""
    sizes = prob.partition.sizes
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    X = np.maximum(np.atleast_2d(np.asarray(X, np.float64)), 0.0)
    return X / np.repeat(np.maximum(np.add.reduceat(X, offs, axis=1), 1e-300), sizes, axis=1)


def phase_certify(prob, dp, max_iter=400, certify=150):
    """pgd/bbm, then the same solve with ``certify``: K afw steps from its end."""
    kw = dict(method="pgd", line_search="bbm", tol=0.0, max_iter=max_iter, chunk=100,
              lipschitz=bt.solvers.power_lipschitz(dp))
    r0 = bt.solve(dp, **kw)
    reset_counts()
    t0 = time.perf_counter()
    r1 = bt.solve(dp, certify=certify, **kw)
    secs = time.perf_counter() - t0
    counts = read_counts()
    f0, f1 = np.asarray(r0.objective, np.float64), np.asarray(r1.objective, np.float64)
    g0, g1 = np.asarray(r0.gap, np.float64), np.asarray(r1.gap, np.float64)
    check(bool(np.isfinite(r1.x).all() and np.isfinite(g1).all()), "certify: non-finite result")
    check(bool(np.all(f1 <= f0 * (1 + 1e-6))), "certify: an objective got worse by more than "
          f"1e-6 relative ({np.max(f1 / f0 - 1):.2e})")
    check(bool(np.all(g1 < g0)), "certify: the gap did not shrink in every scenario "
          f"({int(np.sum(g1 >= g0))} of {len(g0)} did not; the polish is all or nothing)")
    ratio = g1 / g0
    twin = graph_twin("certify", lambda: bt.solve(dp, certify=certify, **{
        **kw, "max_iter": GRAPH_TWIN_CHUNKS * kw["chunk"]}), solve_ends)
    emit("certify", scenarios=len(g0), iterations=max_iter, certify=certify, graph_vs_eager=twin,
         gap_ratio_max=float(ratio.max()), gap_ratio_median=float(np.median(ratio)),
         scenarios_below_0_1=int(np.sum(ratio < 0.1)), gap_before_median=float(np.median(g0)),
         gap_after_median=float(np.median(g1)), max_rel_objective_change=float(np.max(f1 / f0 - 1)),
         secs_with_certify=secs, launches=counts)
    return counts


def phase_refine(prob, dp, max_iter=400, rounds=3):
    """lbfgs, then ``refine_polish`` with the device CG (what ``solve(refine=)``
    runs after its main solve), on medium x 128.  The CG is wrapped here to
    time its share (synchronised before and after each call)."""
    from bsls_tpu_torch.solvers import base as TB

    res = bt.solve(dp, method="lbfgs", tol=0.0, max_iter=max_iter, chunk=100)
    cg_secs, real_cg = [0.0], TB._polish_cg

    def timed_cg(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_cg(*a)
        torch.cuda.synchronize()
        cg_secs[0] += time.perf_counter() - t0
        return out

    f_raw = _fw_gap_rel(prob, res.x)[0]
    # the unrefined point made feasible in float64 (its fp32 block sums are
    # off by ~1e-7, which moves f64 objectives by ~1e-6 either way)
    f0, gap0, _ = _fw_gap_rel(prob, _repaired(prob, res.x))
    reset_counts()
    TB._polish_cg = timed_cg
    try:
        pol = TB.refine_polish(prob, dp, res, rounds=rounds)
    finally:
        TB._polish_cg = real_cg
    counts = read_counts()
    f1, gap1, _ = _fw_gap_rel(prob, pol.x)
    x = np.asarray(pol.x)
    offs = np.concatenate([[0], np.cumsum(prob.partition.sizes)[:-1]])
    sums = np.add.reduceat(x, offs, axis=1)
    check(pol.x.dtype == np.float64 and x.shape == res.x.shape, "refine: wrong x")
    check(bool(np.all(f1 <= f0 + 1e-12)), f"refine: {int(np.sum(f1 > f0 + 1e-12))} scenarios "
          "got worse in float64")
    check(float(x.min()) >= -1e-12, f"refine: x has an entry {x.min():.2e}")
    check(float(np.abs(sums - 1.0).max()) <= 1e-9,
          f"refine: block sums off by {np.abs(sums - 1).max():.2e}")
    emit("refine", scenarios=len(f0), iterations=max_iter, rounds=rounds, path="device CG",
         refine_secs=pol.refine_secs, device_cg_secs=cg_secs[0],
         host_secs=pol.refine_secs - cg_secs[0], cg_iterations=pol.iterations - max_iter,
         fw_gap_rel_before_max=float(gap0.max()), fw_gap_rel_after_max=float(gap1.max()),
         fw_gap_rel_before_median=float(np.median(gap0)),
         fw_gap_rel_after_median=float(np.median(gap1)),
         max_rel_objective_gain=float(np.max((f0 - f1) / f0)),
         median_rel_objective_gain=float(np.median((f0 - f1) / f0)),
         scenarios_above_unrefined_fp32_x=int(np.sum(f1 > f_raw)), launches=counts)
    return counts


def phase_refine_certified(base, scenarios=8, max_iter=400, target=1e-6):
    """Certified refine through ``solve(refine_tol=)`` (host float64 Jacobi-PCG)
    on medium x 8: the cut from 128 scenarios keeps the host PCG inside the
    script's time."""
    prob = bt.synthetic.with_scenarios(base, scenarios, seed=1)
    lines = io.StringIO()
    saved = os.environ.get("BSLS_REFINE_TRACE")
    os.environ["BSLS_REFINE_TRACE"] = "1"
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(lines):
            res = bt.solve(prob, method="lbfgs", tol=0.0, max_iter=max_iter, chunk=100,
                           refine_tol=target, device=DEV)
    finally:
        if saved is None:
            os.environ.pop("BSLS_REFINE_TRACE", None)
        else:
            os.environ["BSLS_REFINE_TRACE"] = saved
    secs = time.perf_counter() - t0
    counts = read_counts()
    f, gap, terms = _fw_gap_rel(prob, res.x)
    # the certificate bounds f - f* by the FW gap and by f itself (f* >= 0);
    # recomputed here with sums in another order, to float64 rounding of the
    # terms the gap is the difference of
    bound = np.minimum(gap * np.maximum(1.0, np.abs(f)), f) / np.maximum(1.0, np.abs(f))
    slack = 1e-12 * terms
    check(res.refine_fw_gap is not None and np.isfinite(res.refine_fw_gap),
          "refine_certified: no certificate")
    check(bool(np.all(bound <= res.refine_fw_gap + slack)),
          f"refine_certified: the float64 bound {bound.max():.3e} exceeds the certificate "
          f"{res.refine_fw_gap:.3e} by more than its rounding ({slack.max():.1e})")
    emit("refine_certified", scenarios=scenarios, iterations=max_iter, refine_tol=target,
         reduced={"scenarios": f"{SCENARIOS} -> {scenarios}: the host float64 PCG of certified "
                  "refine grows with S"},
         path="host Jacobi-PCG", refine_fw_gap=res.refine_fw_gap, certified=bool(
             res.refine_fw_gap <= target), rounds_logged=lines.getvalue().count("[refine] round="),
         cg_iterations=res.iterations - max_iter, refine_secs=res.refine_secs,
         solve_and_refine_secs=secs, fw_gap_rel_max=float(gap.max()),
         bound_rel_max=float(bound.max()), rounding_slack_max=float(slack.max()),
         launches=counts)
    return counts


def phase_solve_banded_families(ctx, max_iter=200):
    """lbfgs and afw on the banded layout of medium_banded x 4 against the
    gather layout, one ``lipschitz=``: one step from the banded iterate at
    every chunk end mapped to the gather layout (a fresh state there and on
    the band, the counter kept: afw's mix and the first L-BFGS step without
    memory), and L-BFGS's converged ends at the limit of banded_vs_gather."""
    from bsls_tpu_torch.ops import layout as TL
    from bsls_tpu_torch.solvers.base import SolveOptions, _get_solver

    prob, dp = ctx["banded_prob"][4], ctx["banded"][4]
    dp_g = bt.prepare(prob, layout="gather", device=DEV)
    L_est = bt.solvers.power_lipschitz(dp)
    kw = dict(tol=0.0, max_iter=max_iter, chunk=50, lipschitz=L_est)
    total, out = {}, {}
    for method in ("lbfgs", "afw"):
        reset_counts()
        rb, states = _states_at_chunk_ends(dp, method, kw)
        counts = read_counts()
        rg = bt.solve(dp_g, method=method, **kw)
        for k in ("band_zmv", "band_grmv"):
            check(counts[k] >= max_iter, f"solve_banded_families: {method} launched {k} "
                  f"{counts[k]} times in {max_iter} iterations")
        check(bool(np.isfinite(rb.x).all()), f"solve_banded_families: {method} non-finite x")
        opts, mod = SolveOptions(method=method), _get_solver(method)
        steps = []
        for st in states:
            xg = TL.inject_user_flat(dp_g, TL.extract_user_flat(dp, st.xp))
            sb = dataclasses.replace(mod.init(dp, L_est, opts, xp0=st.xp), k=st.k)
            sg = dataclasses.replace(mod.init(dp_g, L_est, opts, xp0=xg), k=st.k)
            steps.append(_one_step_diff(prob, mod, opts, L_est, dp, sb, dp_g, sg))
        check(max(steps) <= ONE_STEP_LIMIT, f"solve_banded_families: {method}, one step from "
              f"the same iterate differs by {max(steps):.2e} relative on the two layouts")
        rel = np.abs(rb.trace_f - rg.trace_f) / np.abs(rg.trace_f)
        if method == "lbfgs":  # converged by 200 iterations
            check(float(rel[:, -1].max()) <= 5e-4,
                  f"solve_banded_families: lbfgs banded and gather ends differ by "
                  f"{rel[:, -1].max():.2e}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        twin = graph_twin(f"solve_banded_families_{method}", lambda: bt.solve(
            dp, method=method, **{**kw, "max_iter": GRAPH_TWIN_CHUNKS * kw["chunk"]}),
            solve_ends)
        past = np.nonzero(rel.max(0) > 5e-4)[0]
        out[method] = dict(one_step_rel_diff_by_chunk_end=steps,
                           max_rel_end_diff=float(rel[:, -1].max()),
                           first_iteration_past_5e_4=int(past[0]) if past.size else None,
                           objective_banded=np.asarray(rb.objective).tolist(),
                           objective_gather=np.asarray(rg.objective).tolist(),
                           aggregate_iters_per_sec_banded=4 * rb.steady_iters_per_sec(),
                           aggregate_iters_per_sec_gather=4 * rg.steady_iters_per_sec(),
                           launches=counts, graph_vs_eager=twin)
    emit("solve_banded_families", scenarios=4, iterations=max_iter, **out)
    return total

# ------------------------------------------------ the equality-constrained path

# traffic_like at the width of the reference's traffic_random preset: 10,000
# blocks of width 2-12, A 100,000 x 69,989 with 454,722 nonzeros, a dense C of
# 50 x 69,989, times 128 scenarios with their own targets d
EQ_SCENARIOS = 128
# total inner iterations (three outers) of solve_eq, of its mesh twins and of
# serve_eq's traffic_like requests: the reference runs 10,000, cut to the
# script's time
EQ_BUDGET = 1200
EQ_INNER = 400  # at most this many per outer
EQ_CROSS_ITERS = 100  # the first outer of the card-against-CPU check, S = 4
EQ_PAVA_ITERS, EQ_PAVA_INNER = 400, 200  # solve_eq_pava and its mesh twin, S = 4


class OuterRecords:
    """A metrics sink of ``solve_equality_constrained`` that keeps its "outer"
    records (violation, rho, the inner solve's rho, inner iterations, the
    seconds of the inner solve and of the host multiplier update)."""

    def __init__(self):
        self.outer = []

    def log(self, kind, **fields):
        if kind == "outer":
            self.outer.append(fields)


def _tensor_bytes(obj):
    """Bytes of every tensor in a prepared problem (dataclasses, tuples)."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, tuple):
        return sum(_tensor_bytes(v) for v in obj)
    if dataclasses.is_dataclass(obj):
        return sum(_tensor_bytes(getattr(obj, f.name)) for f in dataclasses.fields(obj))
    return 0


def eq_instance(scenarios):
    base = bt.synthetic.traffic_like(seed=0, num_blocks=10_000, m=100_000, num_eq=50)
    return base, bt.synthetic.with_scenarios(base, scenarios, seed=1)


def _check_simplices(phase, prob, x, limit=1e-5):
    x = np.atleast_2d(np.asarray(x, np.float64))
    offs = np.concatenate([[0], np.cumsum(prob.partition.sizes)[:-1]])
    sums = np.add.reduceat(x, offs, axis=1)
    check(bool(np.isfinite(x).all()), f"{phase}: non-finite x")
    check(float(x.min()) >= 0.0 and float(np.abs(sums - 1.0).max()) <= limit,
          f"{phase}: x is not on the simplices (block sums off by {np.abs(sums - 1).max():.2e})")


def _eq_residual_f64(prob, x):
    """C x - d per scenario, in float64 on the host, and d at the same shape."""
    C = prob.C.to_scipy()
    X = np.atleast_2d(np.asarray(x, np.float64))
    d = np.broadcast_to(np.atleast_2d(np.asarray(prob.d, np.float64)), (X.shape[0], C.shape[0]))
    return np.asarray(C @ X.T).T - d, d


def check_rows_at(name, dp, scenarios, seed):
    """A row kernel against its plain version at the buckets of a path: the
    widths and radii of its prepared problem, ``scenarios`` leading. Each
    bucket is also timed (device time of one launch, inputs cycled past the
    L2) beside its bytes bound, under the form its kernel's plan gives its
    width; then all buckets in one launch, as its path launches them
    (``grouped``)."""
    spec, errs, per_bucket, inputs = KERNELS[name], [], [], []
    for i, bk in enumerate(dp.buckets):
        Bk, w = bk.mask.shape
        widths = spec["widths_of"](bk)
        rng = np.random.default_rng(seed + i)
        n_in = inputs_in_turn(4 * scenarios * Bk * w)
        vs = [torch.from_numpy((rng.standard_normal((scenarios, Bk, w)) * 2).astype(np.float32))
              .to(DEV) * bk.radius[:, None] for _ in range(n_in)]
        errs.append(compare_rows(name, spec, vs[0], widths, bk.radius))
        k_ms = device_ms(lambda j: spec["fn"](vs[j % n_in], widths, bk.radius))
        b_ms, by = bound(2 * 4 * scenarios * Bk * w + 8 * Bk,
                         scenarios * Bk * spec["ops_per_row"](w))
        per_bucket.append({"shape": [scenarios, Bk, w], "form": spec["plan"](w),
                           "ms": k_ms, "bound_ms": b_ms, "bound_by": by,
                           "share_of_bound": b_ms / k_ms})
        inputs.append((vs, widths, bk.radius))
        del vs
    grouped = grouped_rows(name, inputs, errs) if spec.get("buckets_fn") else None
    return max(errs), per_bucket, grouped


def top_products_ms(dp, scenarios=(1, 4, 128)):
    """Device time of the stacked top's two products (A^T r over the (m, S)
    residual's r[..., :split], A x over the (n_pf, S) iterate), each one
    transpose and one ell_gather_dot launch, with this path's indices at
    several S: whether their time follows the bytes they move or the count
    of indices."""
    top = dp.A.top
    out = {"indices": [int(top.rows.numel()), int(top.mv_cols.numel())]}
    for S in scenarios:
        r = torch.randn((S, dp.num_rows), device=DEV)
        x = torch.randn((S, dp.n_pf), device=DEV)
        out[f"S={S}"] = {
            "rmatvec_ms": device_ms(lambda j: TL.rmatvec(top, r[..., :dp.A.split])),
            "matvec_ms": device_ms(lambda j: TL.matvec(top, x)),
            "out_bytes": 4 * S * (dp.n_pf + dp.A.split)}
    return out


def phase_solve_eq(ctx):
    """``solve_equality_constrained`` (pgd/exact inners) on traffic_like x 128
    at full width; then the first outer on the card against the CPU at S = 4
    with one set of Lipschitz constants."""
    from bsls_tpu_torch.solvers.base import OneCard
    from bsls_tpu_torch.solvers.eq_constrained import EqInstance, op_cache_key
    from bsls_tpu_torch.utils.profiling import profile_steps

    base, prob = ctx["eq_base"], ctx["eq_prob"]
    cache, rec = {}, OuterRecords()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    snap = graph_since()
    t0 = time.perf_counter()
    res = bt.solve_equality_constrained(
        prob, method="pgd", line_search="exact", eq_tol=1e-6, max_iter=EQ_BUDGET,
        inner_iters=EQ_INNER, chunk=100, op_cache=cache, metrics=rec, device=DEV)
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    graph = graph_since(snap)
    # a new sqrt(rho), b and L every outer, one program for all of them
    check(graph["captures"] == 1, f"solve_eq: {graph['captures']} captures for "
          f"{len(rec.outer)} outers (one key)")
    (inst,) = cache.values()
    dp, rho_base, L_base, LC = inst.place.dp, inst.rho_base, inst.L_base, inst.LC
    S, n = EQ_SCENARIOS, prob.partition.n_flat
    check(res.x.shape == (S, n) and res.eq_lam.shape == (S, prob.C.shape[0]),
          f"solve_eq: x {res.x.shape}, eq_lam {res.eq_lam.shape}")
    _check_simplices("solve_eq", prob, res.x)
    cx_d, d = _eq_residual_f64(prob, res.x)
    viol = float(np.abs(cx_d).max()) / max(1.0, float(np.abs(d).max()))
    check(abs(viol - res.eq_violation) <= 1e-6 * viol,
          f"solve_eq: eq_violation {res.eq_violation} against {viol} in float64 on the host")
    # the device's fp32 objective at the end of the last inner solve (the
    # stacked one, [A; sqrt(rho) C] x against [b; sqrt(rho)(d - lam/rho)]
    # with that solve's rho and multipliers) against its float64 value at
    # the returned x
    rho_in = rec.outer[-1]["inner_rho"]
    lam_in = res.eq_lam - rho_in * cx_d
    A = prob.A.to_scipy().astype(np.float64).tocsr()
    r_top = np.asarray(A @ res.x.astype(np.float64).T).T - np.asarray(prob.b, np.float64)
    r_bot = np.sqrt(rho_in) * (cx_d + lam_in / rho_in)
    f64 = 0.5 * ((r_top * r_top).sum(-1) + (r_bot * r_bot).sum(-1))
    f32 = res.trace_f[:, -1].astype(np.float64)
    rel = float(np.max(np.abs(f32 - f64) / np.maximum(1.0, np.abs(f64))))
    check(rel <= 1e-4, f"solve_eq: device objective differs from the float64 host one by {rel:.2e}")
    check(counts["proj_simplex_rows"] >= res.iterations,
          f"solve_eq: proj_simplex_rows launched {counts['proj_simplex_rows']} times in "
          f"{res.iterations} inner iterations")
    # kernel 1 against its plain version at this path's buckets, S = 128
    err, rows, grouped = check_rows_at("proj_simplex_rows", dp, S, seed=610)
    ctx["eq_row_errs"]["proj_simplex_rows"] = err
    # the step of the stacked operator under the profiler: idle share and
    # launches per inner step
    prof = profile_steps(dp, "exact", iters=20)
    # two outers of the same loop graphed (the cached program) and eager
    twin = graph_twin("solve_eq", lambda: bt.solve_equality_constrained(
        prob, method="pgd", line_search="exact", eq_tol=1e-6, max_iter=GRAPH_TWIN_CHUNKS * 100,
        inner_iters=100, chunk=100, op_cache=cache, device=DEV), solve_ends)
    outer = rec.outer
    ctx["eq_unsharded"] = {"outer": outer, "objective": res.objective, "x": res.x,
                           "viol": res.eq_violation, "iterations": res.iterations,
                           "consts": (rho_base, L_base, LC)}
    emit("solve_eq", instance=f"traffic_like(seed=0, num_blocks=10000, m=100000, num_eq=50) x {S}",
         shape=list(prob.A.shape), nnz=int(prob.A.nnz), C=list(prob.C.shape),
         buckets=[list(bk.mask.shape) for bk in dp.buckets], n_pf=int(dp.n_pf),
         operator_bytes={"top": _tensor_bytes(dp.A.top), "bottom": _tensor_bytes(dp.A.bottom)},
         rhs_bytes=_tensor_bytes(dp.b), iterate_bytes=S * int(dp.n_pf) * 4,
         budget=EQ_BUDGET, inner_iters_max=EQ_INNER, iterations=res.iterations,
         outer_iterations=len(outer), rho_end=res.eq_rho, rho_by_outer=[o["rho"] for o in outer],
         eq_violation_worst=res.eq_violation, eq_violation_f64=viol,
         violation_by_outer=[o["viol"] for o in outer], stop_reason=res.stop_reason,
         converged=res.converged, L_base=L_base, L_C=LC, rho_base=rho_base,
         # inner iterations over the inner solves' wall time; secs also holds
         # the stacked prepare, the two power iterations and the host updates
         aggregate_inner_iters_per_sec=S * res.iterations / sum(o["solve_secs"] for o in outer),
         secs=secs, solve_secs_by_outer=[o["solve_secs"] for o in outer],
         host_update_secs_by_outer=[o["host_secs"] for o in outer],
         objective_max=float(np.max(res.objective)), device_vs_f64_rel=rel,
         peak_bytes=peak, launches=counts,
         kernel_launches_per_inner_step=counts["proj_simplex_rows"] / res.iterations,
         device_idle_share=prof["device_idle_share"],
         device_busy_ms_per_inner_step=prof["device_busy_ms_per_iter"],
         wall_ms_per_inner_step=prof["wall_ms_per_iter"],
         launches_per_inner_step=prof["launches_per_iter"],
         largest_device_items_ms_per_step=[[k["name"][:60], k["ms_per_iter"],
                                            k["launches_per_iter"]] for k in prof["kernels"][:8]],
         graph_step_profile=_graph_profile(prof), captures=graph["captures"],
         capture_secs=graph["capture_secs"], graph_replays=graph["replays"],
         graph_pool_bytes=graph["pool_bytes"], graph_vs_eager=twin,
         rows_by_bucket=rows, rows_grouped=grouped, rows_max_err=err)

    # the card against the CPU, S = 4, one set of Lipschitz constants
    prob4 = ctx["eq_prob4"]
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=EQ_CROSS_ITERS,
              inner_iters=EQ_CROSS_ITERS, chunk=50)
    cache4 = {}
    on_card = bt.solve_equality_constrained(prob4, op_cache=cache4, device=DEV, **kw)
    (inst4,) = cache4.values()
    key = op_cache_key(prob4, torch.float32, "pgd", "exact", "cpu")
    on_cpu_op = EqInstance.of(prob4, "cpu", place=OneCard(_state_to(inst4.place.dp, "cpu"),
                                                          keep_x=True),
                              rho_base=inst4.rho_base, L_base=inst4.L_base, LC=inst4.LC)
    on_cpu = bt.solve_equality_constrained(prob4, op_cache={key: on_cpu_op}, device="cpu", **kw)
    rel = np.abs(on_card.trace_f - on_cpu.trace_f) / np.abs(on_cpu.trace_f)
    check(on_card.trace_f.shape == (4, EQ_CROSS_ITERS), "solve_eq: cross-check trace shape")
    check(float(rel.max()) <= 1e-3, f"solve_eq: the first outer's trace differs on the card and "
          f"the CPU by {rel.max():.2e} relative")
    emit("solve_eq_cross_check", scenarios=4, iterations=EQ_CROSS_ITERS,
         max_rel_trace_diff=float(rel.max()),
         max_abs_x_diff=float(np.abs(on_card.x - on_cpu.x).max()),
         eq_violation_card=on_card.eq_violation, eq_violation_cpu=on_cpu.eq_violation)
    return counts


def phase_solve_eq_pava(ctx, max_iter=EQ_PAVA_ITERS, inner=EQ_PAVA_INNER):
    """The same instance at S = 4 with the pava line search: z-space inners,
    kernel 2 on the equality-constrained path; its step profiled."""
    from bsls_tpu_torch.utils.profiling import profile_steps

    prob4 = ctx["eq_prob4"]
    cache, rec = {}, OuterRecords()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    snap = graph_since()
    t0 = time.perf_counter()
    res = bt.solve_equality_constrained(prob4, method="pgd", line_search="pava",
                                        max_iter=max_iter, inner_iters=inner, chunk=100,
                                        op_cache=cache, metrics=rec, device=DEV)
    secs = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    graph = graph_since(snap)
    check(graph["captures"] == 1, f"solve_eq_pava: {graph['captures']} captures for "
          f"{len(rec.outer)} outers (one key)")
    (inst,) = cache.values()
    dp, rho_base, L_base, LC = inst.place.dp, inst.rho_base, inst.L_base, inst.LC
    ctx["eq_pava_unsharded"] = {"outer": rec.outer, "objective": res.objective,
                                "viol": res.eq_violation, "iterations": res.iterations,
                                "consts": (rho_base, L_base, LC)}
    _check_simplices("solve_eq_pava", prob4, res.x)
    check(np.isfinite(res.eq_violation) and bool(np.isfinite(res.objective).all()),
          "solve_eq_pava: non-finite result")
    # one launch a step for the four buckets (read_counts holds one a call),
    # and at most one more an outer: the throwaway step of a capture (one for
    # the whole loop: one key)
    check(res.iterations <= counts["pava_rows"] <= res.iterations + len(rec.outer),
          f"solve_eq_pava: pava_rows launched {counts['pava_rows']} times in "
          f"{res.iterations} inner iterations and {len(rec.outer)} outers")
    # each bucket a launch (w = 12 alone among them) and the four in one
    # launch, as the step makes it
    err, rows, grouped = check_rows_at("pava_rows", dp, 4, seed=620)
    # the same buckets at S = 128, where a launch is no longer only its latency
    err128, rows128, grouped128 = check_rows_at("pava_rows", dp, EQ_SCENARIOS, seed=630)
    ctx["eq_row_errs"]["pava_rows"] = max(err, err128)
    # the z-space step of the stacked operator under the profiler
    prof = profile_steps(dp, "pava", iters=20)
    top_products = top_products_ms(dp)
    twin = graph_twin("solve_eq_pava", lambda: bt.solve_equality_constrained(
        prob4, method="pgd", line_search="pava", max_iter=GRAPH_TWIN_CHUNKS * 100,
        inner_iters=100, chunk=100, op_cache=cache, device=DEV), solve_ends)
    emit("solve_eq_pava", scenarios=4, iterations=res.iterations, stop_reason=res.stop_reason,
         eq_violation_worst=res.eq_violation, rho_end=res.eq_rho, L_z_base=L_base, L_z_C=LC,
         objective_max=float(np.max(res.objective)), secs=secs,
         solve_secs_by_outer=[o["solve_secs"] for o in rec.outer],
         aggregate_inner_iters_per_sec=4 * res.iterations / sum(o["solve_secs"]
                                                                for o in rec.outer),
         launches=counts,
         device_idle_share=prof["device_idle_share"],
         device_busy_ms_per_inner_step=prof["device_busy_ms_per_iter"],
         wall_ms_per_inner_step=prof["wall_ms_per_iter"],
         launches_per_inner_step=prof["launches_per_iter"],
         largest_device_items_ms_per_step=[[k["name"][:60], k["ms_per_iter"],
                                            k["launches_per_iter"]] for k in prof["kernels"][:8]],
         graph_step_profile=_graph_profile(prof), captures=graph["captures"],
         capture_secs=graph["capture_secs"], graph_replays=graph["replays"],
         graph_pool_bytes=graph["pool_bytes"], peak_bytes=peak, graph_vs_eager=twin,
         top_products=top_products,
         rows_by_bucket=rows, rows_grouped=grouped, rows_by_bucket_s128=rows128,
         rows_grouped_s128=grouped128, rows_max_err=max(err, err128))
    return counts


def phase_solve_eq_traffic(target=1e-6):
    """The preset ``traffic`` (grid network, lbfgs inners, S = 1) through
    ``solve`` with ``refine_tol``: the certified finisher against the float64
    oracle."""
    from bsls_tpu_torch.solvers import base as TB
    from bsls_tpu_torch.solvers.eq_constrained import eq_dual_bound, eq_multiplier_polish
    from bsls_tpu_torch.utils.config import load_config

    cfg = load_config("traffic")
    prob = bt.synthetic.make_config(cfg.config, seed=cfg.seed)
    cg_secs, real_cg = [0.0], TB._polish_cg

    def timed_cg(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_cg(*a)
        torch.cuda.synchronize()
        cg_secs[0] += time.perf_counter() - t0
        return out

    reset_counts()
    TB._polish_cg = timed_cg
    t0 = time.perf_counter()
    try:
        res = bt.solve(prob, method=cfg.method, line_search=cfg.line_search, tol=cfg.tol,
                       max_iter=cfg.max_iter, chunk=cfg.chunk, refine_tol=target, device=DEV)
    finally:
        TB._polish_cg = real_cg
    secs = time.perf_counter() - t0
    counts = read_counts()
    t1 = time.perf_counter()
    orc = bt.oracle_solve_eq(prob)
    oracle_secs = time.perf_counter() - t1
    f = float(res.objective)
    _check_simplices("solve_eq_traffic", prob, res.x)
    check(abs(f - orc.objective) <= 1e-9, f"solve_eq_traffic: objective {f!r} against the "
          f"oracle's {orc.objective!r}")
    check(res.eq_violation <= 1e-6, f"solve_eq_traffic: violation {res.eq_violation:.2e}")
    check(res.refine_fw_gap is not None and res.refine_fw_gap <= target,
          f"solve_eq_traffic: certificate {res.refine_fw_gap}")
    # the Lagrangian dual bound recomputed on the host from the returned x
    # and multipliers: the certificate is the tightest bound the finisher
    # found (these multipliers, or their face refit), and both bound the
    # gap to the oracle (relative to max(1, |f|), float64 rounding aside)
    bound = eq_dual_bound(prob, res.x, res.eq_lam)
    bound_fit = eq_dual_bound(prob, res.x, eq_multiplier_polish(prob, res.x))
    true_gap = (f - orc.objective) / max(1.0, abs(f))
    check(res.refine_fw_gap <= bound * (1 + 1e-6) + 1e-12,
          f"solve_eq_traffic: certificate {res.refine_fw_gap:.3e} above the recomputed bound "
          f"{bound:.3e}")
    check(true_gap <= min(bound, res.refine_fw_gap) + 1e-12,
          f"solve_eq_traffic: the gap to the oracle {true_gap:.3e} exceeds the bound "
          f"{bound:.3e} or the certificate {res.refine_fw_gap:.3e}")
    check(counts["proj_simplex_rows"] >= res.iterations,
          f"solve_eq_traffic: proj_simplex_rows launched {counts['proj_simplex_rows']} times")
    emit("solve_eq_traffic", preset="traffic", method=cfg.method, shape=list(prob.A.shape),
         C=list(prob.C.shape), iterations=res.iterations, stop_reason=res.stop_reason,
         objective=f, oracle_objective=orc.objective, abs_diff_to_oracle=abs(f - orc.objective),
         oracle_eq_violation=orc.eq_violation, oracle_secs=oracle_secs,
         eq_violation=res.eq_violation, rho_end=res.eq_rho, refine_fw_gap=res.refine_fw_gap,
         recomputed_bound=bound, recomputed_bound_refit=bound_fit, true_rel_gap=true_gap, refine_secs=res.refine_secs,
         refine_device_cg_secs=cg_secs[0], refine_host_secs=res.refine_secs - cg_secs[0],
         solve_secs=secs - res.refine_secs, secs=secs, launches=counts)
    return counts


# ------------------------------------------------------------------ serving


SERVE_ITERS = 200  # every serving request: tol=0, this many pgd/exact iterations


def _rel_diff(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def phase_serve(prob, base):
    """``Endpoint`` at full width: medium x 128 (``prob``) prepared once
    (gather layout), three streamed (128, m) requests held against a direct
    ``bt.solve`` of the same problem, and where a request's time goes
    outside the chunk loop."""
    from bsls_tpu_torch.solvers import pgd
    from bsls_tpu_torch.solvers.base import SolveOptions, power_lipschitz

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    ep = bt.Endpoint(prob, method="pgd", line_search="exact", chunk=100, device=DEV)
    build_secs = time.perf_counter() - t0
    layout = "banded" if isinstance(ep._dp.A, DeviceBanded) else "gather"
    check(layout == "gather", f"serve: the endpoint took the {layout} layout")
    snap = graph_since()
    t0 = time.perf_counter()
    ep.warmup(SCENARIOS)
    warmup_secs = time.perf_counter() - t0
    warmup_captures = graph_since(snap)["captures"]
    check(warmup_captures == 1, f"serve: the warm-up made {warmup_captures} captures")
    reqs = [np.asarray(bt.synthetic.with_scenarios(base, SCENARIOS, seed=s).b) for s in (2, 3, 4)]
    reset_counts()
    snap = graph_since()
    results, walls = [], []
    for B in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(ep.solve(B, tol=0.0, max_iter=SERVE_ITERS))
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    graph = graph_since(snap)
    check(graph["captures"] == 0, f"serve: {graph['captures']} captures on a warm endpoint")
    check(counts["proj_simplex_rows"] >= len(reqs) * SERVE_ITERS,
          f"serve: proj_simplex_rows launched {counts['proj_simplex_rows']} times")
    # what a request pays outside its chunk loop, piece by piece: the upload
    # of b, the power iteration (the endpoint's build makes it now, a request
    # none), and the eager throwaway step that a request made before its
    # chunks were captured (a warm endpoint's request makes none now)
    dp_b = ep._placed(reqs[0]).dp
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp_b = ep._placed(reqs[0]).dp
    torch.cuda.synchronize()
    upload_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    L_est = power_lipschitz(dp_b)
    power_secs = time.perf_counter() - t0
    opts = SolveOptions(method="pgd", line_search="exact")
    st = pgd.init(dp_b, L_est, opts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pgd.step(dp_b, st, L_est, opts)
    torch.cuda.synchronize()
    warm_step_secs = time.perf_counter() - t0
    # each request against a direct solve of the same problem (its own
    # prepare, the same layout and Lipschitz estimate); the first is also
    # the cold call: prepare included.  Each captures a program on its own
    # prepared problem, which goes with that problem.
    cached_before = graph_since()["cached"]
    diffs, cold_secs = [], None
    for B, res in zip(reqs, results):
        check(res.x.shape == (SCENARIOS, prob.partition.n_flat), f"serve: x {res.x.shape}")
        check(bool(np.isfinite(res.objective).all()), "serve: non-finite objective")
        _check_simplices("serve", prob, res.x)
        t0 = time.perf_counter()
        direct = bt.solve(dataclasses.replace(prob, b=B), method="pgd", line_search="exact",
                          tol=0.0, max_iter=SERVE_ITERS, chunk=100, device=DEV)
        if cold_secs is None:
            cold_secs = time.perf_counter() - t0
        diffs.append(_rel_diff(res.objective, direct.objective))
    check(max(diffs) <= 1e-5, f"serve: per-scenario objectives differ from a direct solve by "
          f"{max(diffs):.2e} relative")
    gc.collect()
    cached_after = graph_since()["cached"]
    check(cached_after <= cached_before, f"serve: {cached_after - cached_before} programs "
          "outlived the direct solves' prepared problems")
    loop = [float(np.sum(r.chunk_times)) for r in results]
    outside = [w - lp for w, lp in zip(walls, loop)]
    twin = graph_twin("serve", lambda: ep.solve(reqs[0], tol=0.0, max_iter=SERVE_ITERS),
                      solve_ends)
    emit("serve", instance=f"medium_sparse(seed=0) x {SCENARIOS}", layout=layout,
         endpoint_build_secs=build_secs, warmup_secs=warmup_secs,
         warmup_captures=warmup_captures, request_captures=graph["captures"],
         request_replays=graph["replays"], graph_vs_eager=twin, requests=len(reqs),
         iterations=SERVE_ITERS, request_wall_secs=walls, chunk_loop_secs=loop,
         outside_chunk_loop_secs=outside,
         outside_share=[o / w for o, w in zip(outside, walls)],
         upload_secs=upload_secs, power_iteration_secs=power_secs,
         warm_up_step_secs=warm_step_secs,
         aggregate_steady_iters_per_sec=[SCENARIOS * r.steady_iters_per_sec() for r in results],
         aggregate_iters_per_sec_by_wall=[SCENARIOS * SERVE_ITERS / w for w in walls],
         cold_solve_secs_with_prepare=cold_secs, max_rel_diff_to_direct=max(diffs),
         objective_max=[float(np.max(r.objective)) for r in results], launches=counts,
         phase_secs=time.perf_counter() - t_phase)
    return counts


def phase_serve_queue(prob, base, threads=8, per_thread=8, width=32, mesh=None):
    """``BatchQueue`` over an endpoint of the same instance (built with the
    first 32 rows of ``prob``'s b): 8 client threads, each sending its
    requests one after the other, 64 single-RHS requests in all; each answer
    against that scenario's objective in one batched solve of all 64 (with
    ``mesh``: a mesh endpoint, and the batched solve on it)."""
    import threading

    t_phase = time.perf_counter()
    prob = dataclasses.replace(prob, b=np.asarray(prob.b)[:width], x_true=None)
    batch = bt.synthetic.with_scenarios(base, threads * per_thread, seed=5)
    B = np.asarray(batch.b)
    ep = bt.Endpoint(prob, method="pgd", line_search="exact", chunk=100, device=DEV, mesh=mesh)
    snap = graph_since()
    for w in (8, width):  # the widths the queue will send, first launches before traffic
        ep.warmup(w)
    warmup_captures = graph_since(snap)["captures"]
    q = bt.BatchQueue(ep, max_batch=width, max_wait_ms=20, tol=0.0, max_iter=SERVE_ITERS)
    out, lat, errors = [None] * len(B), [0.0] * len(B), []

    def client(k):
        try:
            for j in range(per_thread):
                i = k * per_thread + j
                t0 = time.perf_counter()
                out[i] = q.submit(B[i]).result(timeout=300)  # re-raises a batch's failure
                lat[i] = time.perf_counter() - t0
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    reset_counts()
    snap = graph_since()
    workers = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    wall = time.perf_counter() - t0
    counts = read_counts()
    traffic_graph = graph_since(snap)
    q.close(timeout=30)
    check(not q._worker.is_alive() and not any(w.is_alive() for w in workers),
          "serve_queue: a thread did not stop")
    if errors:
        raise errors[0]
    check(q.requests_served == len(B), f"serve_queue: served {q.requests_served} of {len(B)}")
    check(counts["proj_simplex_rows"] > 0, "serve_queue: proj_simplex_rows was not launched")
    if mesh is None:
        ref = bt.solve(batch, method="pgd", line_search="exact", tol=0.0,
                       max_iter=SERVE_ITERS, chunk=100, device=DEV)
    else:
        ref = ep.solve(B, tol=0.0, max_iter=SERVE_ITERS)
    got = np.array([r.objective for r in out])
    diff = _rel_diff(got, ref.objective)
    check(diff <= 1e-4, f"serve_queue: answers differ from one batched solve by {diff:.2e}")
    check(all(r.x.shape == (prob.partition.n_flat,) for r in out), "serve_queue: x shape")
    twin = None
    if mesh is None:  # the worker's chunk, a batch of full width, graphed and eager
        twin = graph_twin("serve_queue", lambda: ep.solve(B[:width], tol=0.0,
                                                          max_iter=SERVE_ITERS), solve_ends)
    lat_s = np.sort(np.asarray(lat))
    emit("serve_queue" if mesh is None else "serve_mesh_queue", clients=threads,
         requests=len(B), max_batch=width, max_wait_ms=20,
         iterations=SERVE_ITERS, batches_run=q.batches_run,
         mean_width=q.requests_served / q.batches_run,
         latency_p50_secs=float(np.percentile(lat_s, 50)),
         latency_p99_secs=float(np.percentile(lat_s, 99)), wall_secs=wall,
         requests_per_sec=len(B) / wall, max_rel_diff_to_batched=diff, launches=counts,
         warmup_captures=warmup_captures, traffic_captures=traffic_graph["captures"],
         traffic_replays=traffic_graph["replays"], graph_vs_eager=twin,
         phase_secs=time.perf_counter() - t_phase)
    return counts


def phase_serve_eq(ctx, perturb=0.02, target=1e-6):
    """Two equality-constrained endpoints: (a) the preset ``traffic`` with a
    certified first request and a perturbed second one that takes the
    float64 sensitivity fast path, against ``oracle_solve_eq``; (b)
    traffic_like at full width x 128 at ``solve_eq``'s budget, two requests
    with the fast path off, one prepared stacked operator for both."""
    import bsls_tpu_torch.ops.layout as TL
    import bsls_tpu_torch.solvers.base as TB
    from bsls_tpu_torch.utils.config import load_config

    t_phase = time.perf_counter()
    cfg = load_config("traffic")
    prob = bt.synthetic.make_config(cfg.config, seed=cfg.seed)
    ep = bt.Endpoint(prob, method=cfg.method, line_search=cfg.line_search, chunk=cfg.chunk,
                     device=DEV)
    reset_counts()
    t0 = time.perf_counter()
    r1 = ep.solve(np.asarray(prob.b), tol=cfg.tol, max_iter=cfg.max_iter, refine_tol=target)
    secs1 = time.perf_counter() - t0
    counts = read_counts()
    check(r1.converged and r1.eq_violation <= 1e-6, f"serve_eq: request 1 converged "
          f"{r1.converged}, violation {r1.eq_violation:.2e}")
    check(r1.refine_fw_gap is not None and r1.refine_fw_gap <= target,
          f"serve_eq: request 1's certificate {r1.refine_fw_gap}")
    check(counts["proj_simplex_rows"] > 0, "serve_eq: proj_simplex_rows was not launched")
    # the perturbation of the reference's test of the fast path (seed 1):
    # the walk is certificate-gated and falls back to the AL solve where it
    # does not converge, which some 2% draws do on this instance
    rng = np.random.default_rng(1)
    b2 = (np.asarray(prob.b, np.float64)
          * (1.0 + perturb * rng.standard_normal(prob.A.shape[0]))).astype(np.float32)
    t0 = time.perf_counter()
    r2 = ep.solve(b2, tol=cfg.tol, max_iter=cfg.max_iter)
    secs2 = time.perf_counter() - t0
    t0 = time.perf_counter()
    orc = bt.oracle_solve_eq(dataclasses.replace(prob, b=b2))
    oracle_secs = time.perf_counter() - t0
    f2 = float(r2.objective)
    rel2 = abs(f2 - orc.objective) / max(abs(orc.objective), 1e-30)
    check(r2.stop_reason == "sensitivity", f"serve_eq: request 2 stopped by {r2.stop_reason!r}")
    check(rel2 <= 1e-9, f"serve_eq: request 2's objective {f2!r} against the oracle's "
          f"{orc.objective!r} ({rel2:.2e} relative)")
    check(r2.eq_violation <= 1e-6, f"serve_eq: request 2's violation {r2.eq_violation:.2e}")
    _check_simplices("serve_eq", prob, r2.x)
    ctx["serve_eq_traffic"] = {"b2": b2, "oracle": orc.objective}

    # (b) the full-width instance: one stacked operator for both requests
    big = ctx["eq_prob"]
    ep_big = bt.Endpoint(big, method="pgd", line_search="exact", chunk=100, device=DEV)
    # the prepares and the inner solves (one per outer, with their seconds)
    # counted by wrapping the two functions: a metrics sink would add a
    # float64 host objective per outer to the request
    prepares, real_prepare, inner, real_solve = [0], TL.prepare, [], TB.solve

    def counting_prepare(*a, **k):
        prepares[0] += 1
        return real_prepare(*a, **k)

    def timed_solve(*a, **k):
        t0 = time.perf_counter()
        out = real_solve(*a, **k)
        inner.append(time.perf_counter() - t0)
        return out

    B1 = np.asarray(big.b)
    B2 = (B1 * (1.0 + 0.01 * np.random.default_rng(71).standard_normal(B1.shape))
          ).astype(np.float32)
    rows, entry = [], None
    TL.prepare, TB.solve = counting_prepare, timed_solve
    try:
        for k, B in enumerate((B1, B2)):
            inner.clear()
            reset_counts()
            snap = graph_since()
            t0 = time.perf_counter()
            res = ep_big.solve(B, max_iter=EQ_BUDGET, inner_iters=EQ_INNER, eq_tol=1e-6,
                               sensitivity=False)
            secs = time.perf_counter() - t0
            c = read_counts()
            graph = graph_since(snap)
            # one program for every outer of both requests
            check(graph["captures"] == (1 if k == 0 else 0),
                  f"serve_eq: request {k + 1} made {graph['captures']} captures")
            for name in counts:
                counts[name] += c[name]
            check(res.x.shape == (EQ_SCENARIOS, big.partition.n_flat), "serve_eq: x shape")
            check(bool(np.isfinite(res.objective).all()) and np.isfinite(res.eq_violation),
                  "serve_eq: non-finite result")
            check(len(ep_big._eq_ops) == 1, f"serve_eq: {len(ep_big._eq_ops)} op_cache entries")
            (now,) = ep_big._eq_ops.values()
            check(entry is None or now.place is entry, "serve_eq: request 2 re-prepared")
            entry = now.place
            rows.append({"outers": len(inner), "iterations": res.iterations, "secs": secs,
                         "solve_secs": sum(inner),
                         "eq_violation": res.eq_violation, "stop_reason": res.stop_reason,
                         "proj_simplex_rows_launches": c["proj_simplex_rows"],
                         "captures": graph["captures"], "capture_secs": graph["capture_secs"],
                         "replays": graph["replays"]})
    finally:
        TL.prepare, TB.solve = real_prepare, real_solve
    # two outers of a request graphed and eager, from the same start (the
    # warm start of the last converged request is off for both)
    ep_big.warm_start = False
    try:
        twin = graph_twin("serve_eq", lambda: ep_big.solve(
            B1, max_iter=GRAPH_TWIN_CHUNKS * 100, inner_iters=100, eq_tol=1e-6,
            sensitivity=False), solve_ends)
    finally:
        ep_big.warm_start = True
    # the float64 host objective of the (S, n) x: the AL loop computes it
    # once for the result (and for each outer's record when given a sink)
    t0 = time.perf_counter()
    big.objective_np(np.asarray(res.x, np.float64))
    objective_secs = time.perf_counter() - t0
    check(prepares[0] == 1, f"serve_eq: {prepares[0]} prepares for two requests")
    emit("serve_eq", traffic={"shape": list(prob.A.shape), "C": list(prob.C.shape),
                              "request1_secs": secs1, "request1_iterations": r1.iterations,
                              "request1_eq_violation": r1.eq_violation,
                              "request1_certificate": r1.refine_fw_gap,
                              "request2_secs": secs2, "request2_stop_reason": r2.stop_reason,
                              "request2_objective": f2, "oracle_objective": orc.objective,
                              "request2_rel_to_oracle": rel2,
                              "request2_eq_violation": r2.eq_violation,
                              "request2_certificate": r2.refine_fw_gap,
                              "oracle_secs": oracle_secs},
         traffic_like_x128={"requests": rows, "prepares": prepares[0],
                            "perturbation": 0.01, "host_objective_secs": objective_secs,
                            "graph_vs_eager": twin},
         launches=counts, phase_secs=time.perf_counter() - t_phase)
    return counts


# --------------------------------------------------------------- checkpoint


def checkpoint_child(path):
    """``--checkpoint-child PATH``: medium x 128 (pgd/exact, the b that the
    parent saved beside PATH as ``b.npy``) that checkpoints every chunk (two
    kept) until it is killed; each chunk is stretched to about a second so
    that the kill lands well before iteration 400, and the budget ends an
    orphaned child within a minute."""
    base = bt.synthetic.medium_sparse(seed=0)
    b = np.load(os.path.join(os.path.dirname(path), "b.npy"))
    dp = bt.prepare(dataclasses.replace(base, b=b), device=DEV)
    bt.solve(dp, method="pgd", line_search="exact", tol=0.0, max_iter=3000, chunk=100,
             checkpoint_path=path, checkpoint_every=1, checkpoint_keep=2,
             callback=lambda it, st: time.sleep(1.0))


def phase_checkpoint(prob, dp, total=400):
    """SIGKILL a solving child after its first checkpoint, resume to
    ``total`` iterations and hold the result against an uninterrupted run;
    then the CLI on the card with --checkpoint and --profile-dir."""
    import signal
    import tempfile

    from bsls_tpu_torch.utils.checkpoint import latest_checkpoint, load_state, save_state
    from bsls_tpu_torch.solvers import pgd
    from bsls_tpu_torch.solvers.base import SolveOptions

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ck.npz")
        np.save(os.path.join(tmp, "b.npy"), np.asarray(prob.b))
        err_path = os.path.join(tmp, "child.err")
        with open(err_path, "w") as err:
            proc = subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"),
                                     "--checkpoint-child", ck], cwd=here,
                                    stdout=subprocess.DEVNULL, stderr=err)
        try:
            deadline = time.time() + 300
            while time.time() < deadline and latest_checkpoint(ck) is None:
                if proc.poll() is not None:
                    with open(err_path) as fh:
                        raise PhaseFailed("checkpoint: the child exited before its first "
                                          f"checkpoint:\n{fh.read()[-2000:]}")
                time.sleep(0.05)
            check(latest_checkpoint(ck) is not None, "checkpoint: no checkpoint appeared")
            os.kill(proc.pid, signal.SIGKILL)  # the exact PID, never a pattern
        finally:
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
        found = latest_checkpoint(ck)
        like = pgd.init(dp, 1.0, SolveOptions())
        _, meta = load_state(found, like)
        resumed_from = int(meta["iteration"])
        check(0 < resumed_from < total, f"checkpoint: resumed from iteration {resumed_from}")
        reset_counts()
        resumed = bt.solve(dp, method="pgd", line_search="exact", tol=0.0, max_iter=total,
                           chunk=100, checkpoint_path=ck, checkpoint_every=1, checkpoint_keep=2,
                           resume=True)
        counts = read_counts()
        full = bt.solve(dp, method="pgd", line_search="exact", tol=0.0, max_iter=total,
                        chunk=100)
        diff = _rel_diff(resumed.objective, full.objective)
        check(resumed.iterations == total and diff <= 1e-5,
              f"checkpoint: resumed run ({resumed.iterations} iterations) differs from the "
              f"uninterrupted one by {diff:.2e} relative")
        # the save's seconds and bytes at this state (S = 128, medium)
        save_secs = []
        state = pgd.init(dp, 1.0, SolveOptions())
        for k in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            save_state(os.path.join(tmp, "timed.npz"), state, meta={"iteration": k})
            save_secs.append(time.perf_counter() - t0)
        file_bytes = os.path.getsize(os.path.join(tmp, "timed.npz"))
        t0 = time.perf_counter()
        load_state(os.path.join(tmp, "timed.npz"), state)
        torch.cuda.synchronize()
        load_secs = time.perf_counter() - t0

        # the CLI on the card: checkpoints and a profiler trace with kernels
        prof = os.path.join(tmp, "prof")
        cli = subprocess.run([sys.executable, "-m", "bsls_tpu_torch", "--config", "tiny",
                              "--max-iter", "300", "--checkpoint", os.path.join(tmp, "cli.npz"),
                              "--checkpoint-every", "1", "--profile-dir", prof],
                             capture_output=True, text=True, cwd=here, timeout=600)
        check(cli.returncode == 0, f"checkpoint: the CLI failed:\n{cli.stderr[-2000:]}")
        line = json.loads(cli.stdout.strip().splitlines()[-1])
        check(os.path.exists(os.path.join(tmp, "cli.npz")), "checkpoint: the CLI saved nothing")
        traces = os.listdir(prof)
        check(len(traces) == 1, f"checkpoint: profile dir holds {traces}")
        with open(os.path.join(prof, traces[0])) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        check(len(kernels) > 0, "checkpoint: the CLI's trace holds no CUDA kernel event")
        csrc = sum(1 for e in kernels if "bsls::" in e.get("name", ""))
    emit("checkpoint", scenarios=SCENARIOS, resumed_from=resumed_from, total=total,
         max_rel_diff_to_uninterrupted=diff, save_secs=save_secs, load_secs=load_secs,
         bytes_per_file=file_bytes, cli_device=line["device"],
         cli_iterations=line["iterations"], cli_trace_kernel_events=len(kernels),
         cli_trace_csrc_kernel_events=csrc, launches=counts,
         phase_secs=time.perf_counter() - t_phase)
    return counts


# ------------------------------------------------------------------- the mesh

MESH_ITERS = 100  # mesh_world1: two chunks of the preset `large`'s 50
MESH_CHUNK = 50
MESH_WORLD1_RTOL = 2e-5  # 5.1e-6 read on the H100 (layouts that sum in another order)
MESH_RANKS = 4  # mesh_ranks: block 2 x scenario 2 on the one card, over gloo
MESH_RANK_ITERS = 50
MESH_RANK_TIMEOUT = 420


def rank_view(shape, coords):
    """One rank's view of a mesh without process groups: what a rank of that
    mesh prepares and hands its kernels, made in this process."""
    from bsls_tpu_torch.parallel.mesh import AXES, Mesh

    return Mesh(shape={**dict.fromkeys(AXES, 1), **shape},
                coords={**dict.fromkeys(AXES, 0), **coords},
                groups=dict.fromkeys(AXES), device=DEV, device_mesh=None)


def _peak_gb():
    return torch.cuda.max_memory_allocated(DEV) / 1e9


def phase_mesh_world1(ctx):
    """Config 4 at full width: the unsharded solve against the world-of-one
    mesh over NCCL (this process; the default backend takes NCCL for CUDA
    tensors), 100 pgd/exact iterations with one Lipschitz constant.

    The two layouts differ as the reference routes them: unsharded, the rows
    are bucketed by nonzero count (and permuted); on a mesh they never are.
    Their fp32 sums run in another order, and the fp32 trajectories part from
    that alone: 5.1e-6 relative after 100 steps on the H100.  The limit,
    MESH_WORLD1_RTOL, is set from that reading.  (The kernels take float32
    only: no float64 pair on the card.)"""
    from bsls_tpu_torch.ops.layout import _prepare_banded
    from bsls_tpu_torch.parallel.sharding import shard_problem, solve_sharded
    from bsls_tpu_torch.utils.profiling import profile_steps

    t_phase = time.perf_counter()
    prob = ctx["large"]
    S = int(prob.b.shape[0])
    # layout="auto" tries the band first at S < 16: its attempt, alone
    t0 = time.perf_counter()
    band = _prepare_banded(prob, torch.float32, True, False, DEV)
    band_secs = time.perf_counter() - t0
    check(band is None, "mesh_world1: the random-incidence instance took the band")
    t0 = time.perf_counter()
    dp = bt.prepare(prob, device=DEV)
    prepare_secs = time.perf_counter() - t0
    check(not isinstance(dp.A, DeviceBanded), "mesh_world1: unsharded layout is banded")
    mesh = bt.make_mesh(block=1, device=DEV)
    t0 = time.perf_counter()
    dpm, part = shard_problem(prob, mesh)
    prepare_mesh_secs = time.perf_counter() - t0
    L_est = bt.solvers.power_lipschitz(dp)
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=MESH_ITERS, chunk=MESH_CHUNK,
              lipschitz=L_est)
    runs, peaks = {}, {}
    for key, run in (("unsharded", lambda: bt.solve(dp, **kw)),
                     ("mesh", lambda: solve_sharded((dpm, part, False), mesh, **kw))):
        torch.cuda.reset_peak_memory_stats(DEV)
        resident = torch.cuda.memory_allocated(DEV) / 1e9  # both problems and earlier phases
        reset_counts()
        runs[key] = run()
        launches = read_counts()  # the mesh's, read last
        peaks[key] = {"peak": _peak_gb(), "resident_before": resident}
    fm = np.asarray(runs["mesh"].objective, np.float64)
    check(fm.shape == (S,) and np.all(np.isfinite(fm)), "mesh_world1: bad mesh objective")
    ends = runs["mesh"].trace_f[:, MESH_CHUNK - 1::MESH_CHUNK]
    check(np.all(np.diff(ends, axis=1) <= 0), "mesh_world1: objective rose between chunks")
    check(launches["proj_simplex_rows"] > 0, "mesh_world1: no projection launch on the mesh")
    fu = np.asarray(runs["unsharded"].objective, np.float64)
    rel = float(np.max(np.abs(fm - fu) / np.maximum(np.abs(fu), 1e-30)))
    check(rel <= MESH_WORLD1_RTOL, f"mesh_world1: mesh objective {rel:.2e} relative off the "
          f"unsharded one (limit {MESH_WORLD1_RTOL})")
    prof = profile_steps(dpm, "exact", iters=10)
    prof_u = profile_steps(dp, "exact", iters=10, graph=False)  # its kernels only
    # kernels 1-2 at a rank's shard of the bucket: Bk / 2 rows, S / 2 scenarios
    bk = dpm.buckets[0]
    half = bk.mask.shape[0] // 2
    shard = types.SimpleNamespace(buckets=(dataclasses.replace(
        bk, mask=bk.mask[half:], sizes=bk.sizes[half:], radius=bk.radius[half:]),))
    row_checks = {}
    for name in ("proj_simplex_rows", "pava_rows"):
        err, per_bucket, _ = check_rows_at(name, shard, S // 2, seed=81)
        row_checks[name] = {"max_abs_err": err, **per_bucket[0]}
    ctx["mesh_trace_at_rank_iters"] = runs["mesh"].trace_f[:, MESH_RANK_ITERS - 1]
    ctx["mesh_L"] = L_est
    rows, vals = np.asarray(prob.A.rows), np.asarray(prob.A.vals)
    profile_keys = ("wall_ms_per_iter", "device_busy_ms_per_iter", "device_idle_share",
                    "launches_per_iter", "nccl_ms_per_iter", "nccl_share_of_busy")
    emit("mesh_world1", config="large_sharded(seed=0)", blocks=int(prob.partition.num_blocks),
         shape=list(prob.A.shape), nnz=int(prob.A.nnz),
         row_nnz_max=int(np.bincount(rows[vals != 0], minlength=prob.A.shape[0]).max()),
         scenarios=S, gen_secs=ctx["large_gen_secs"], band_attempt_secs=band_secs,
         prepare_secs=prepare_secs, prepare_mesh_secs=prepare_mesh_secs,
         device_bytes={"unsharded": _tensor_bytes(dp), "mesh": _tensor_bytes(dpm)},
         row_groups={"unsharded": [list(c.shape) for c in dp.A.mv_cols]
                     if isinstance(dp.A.mv_cols, tuple) else None,
                     "mesh": None if dpm.A.mv_cols is None else list(dpm.A.mv_cols.shape)},
         backend=torch.distributed.get_backend(), mesh=dict(mesh.shape), lipschitz=L_est,
         iterations=MESH_ITERS, chunk=MESH_CHUNK,
         aggregate_iters_per_sec={k: S * r.steady_iters_per_sec() for k, r in runs.items()},
         objective={k: np.asarray(r.objective).tolist() for k, r in runs.items()},
         mesh_rel_diff=rel, mesh_rtol=MESH_WORLD1_RTOL,
         x_max_abs_diff=float(np.abs(runs["mesh"].x - runs["unsharded"].x).max()),
         memory_gb=peaks, launches=launches,
         step_profile={k: prof[k] for k in profile_keys},
         step_profile_unsharded={k: prof_u[k] for k in profile_keys},
         top_kernels=prof["kernels"][:8], top_kernels_unsharded=prof_u["kernels"][:8],
         kernels_at_shard_shapes=row_checks, secs=time.perf_counter() - t_phase)
    del dp, dpm
    torch.cuda.empty_cache()
    return launches, row_checks


def check_pages_at_shard(ctx):
    """Kernels 3-4 at one rank's band groups: medium_banded x 4 split over a
    block axis of 2, rank 1 (its groups start at ladder page gl), on the
    operands that rank's products hand them: its segment of x, and the page
    windows of the padded residual from its page offset on."""
    from bsls_tpu_torch.parallel.sharding import shard_problem

    prob = ctx["banded_prob"][4]
    dp, _ = shard_problem(prob, rank_view({"block": 2}, {"block": 1}), layout="banded")
    A, S = dp.A, 4
    check(isinstance(A, DeviceBanded) and 2 * A.bands[0].shape[0] == A.pages
          and A.page_off == A.bands[0].shape[0], "mesh: the band is not split over 2 ranks")
    gen = torch.Generator(device=DEV).manual_seed(29)
    out = {}
    for name in ("band_zmv", "band_grmv"):
        spec = KERNELS[name]
        errs, ms, bytes_, ops, shapes = [], 0.0, 0.0, 0.0, []
        for band in A.bands:
            gl, C, W = band.shape
            if name == "band_zmv":
                v = torch.randn((S, gl, C), generator=gen, device=DEV)
            else:
                rp = torch.randn((S, (A.pages + A.wpages) * PAGE), generator=gen, device=DEV)
                v = rp[:, A.page_off * PAGE:].as_strided((S, gl, W), (rp.stride(0), PAGE, 1))
            errs.append(compare_pages(name, spec, band, v))
            ms += device_ms(lambda j: spec["fn"](band, v), reps=10)
            bytes_ += 4 * (band.numel() + S * gl * (C + W))
            ops += 2 * S * band.numel()
            shapes.append([S, gl, C, W])
        b_ms, by = bound(bytes_, ops)
        out[name] = {"max_abs_err": max(errs), "ms": ms, "bound_ms": b_ms, "bound_by": by,
                     "bands": shapes, "page_off": A.page_off, "pages": A.pages}
    emit("mesh_kernels_at_shard", **out)
    return out


def mesh_large_rank(spec, workdir):
    """A rank of mesh_ranks: config 4 from DIR/large.npz on a block 2 x
    scenario 2 mesh, pgd/exact at mesh_world1's Lipschitz estimate."""
    from bsls_tpu_torch.models import Problem

    t0 = time.perf_counter()
    prob = Problem.load(os.path.join(workdir, "large.npz"))
    load_secs = time.perf_counter() - t0
    mesh = bt.make_mesh(block=2, scenario=2, device=DEV)
    reset_counts()
    t0 = time.perf_counter()
    res = bt.solve(prob, mesh=mesh, method="pgd", line_search="exact", tol=0.0,
                   max_iter=MESH_RANK_ITERS, chunk=MESH_RANK_ITERS, lipschitz=spec["L"])
    solve_secs = time.perf_counter() - t0
    return {"coords": mesh.coords, "launches": read_counts(),
            "loop_secs": float(np.sum(res.chunk_times)), "solve_secs": solve_secs,
            "load_secs": load_secs, "objective": np.asarray(res.objective).tolist(),
            "x_sum": float(np.sum(res.x))}


def mesh_rank_child(rank, workdir):
    """``--mesh-rank-child R DIR``: rank R of a world of MESH_RANKS processes,
    every rank on cuda:0, over gloo on a ``file://`` store in DIR, running the
    case that DIR/spec.json names (``large``: mesh_ranks; ``eq``:
    mesh_eq_ranks).  Writes DIR/rank{R}.json: the case's results, the host
    seconds in the rank's collectives (each call's wait for the card's prior
    work included) and its peak memory."""
    import torch.distributed as dist

    with open(os.path.join(workdir, "spec.json")) as fh:
        spec = json.load(fh)
    torch.cuda.set_device(DEV)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'init')}",
                            rank=rank, world_size=MESH_RANKS)
    coll = {"secs": 0.0, "calls": 0}

    def timed(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                coll["secs"] += time.perf_counter() - t0
                coll["calls"] += 1
        return run

    for name in ("all_reduce", "all_gather", "broadcast", "broadcast_object_list"):
        setattr(dist, name, timed(getattr(dist, name)))
    case = {"large": mesh_large_rank, "eq": mesh_eq_rank}[spec["case"]]
    out = {"rank": rank, **case(spec, workdir), "collective_secs": coll["secs"],
           "collective_calls": coll["calls"], "peak_gb": _peak_gb()}
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)
    dist.barrier()
    dist.destroy_process_group()


def run_rank_children(phase, spec, files):
    """Write ``files`` ({name: arrays}) and spec.json into a temporary
    directory, run MESH_RANKS ``--mesh-rank-child`` processes there (each
    stopped by its PID at MESH_RANK_TIMEOUT) and return (every rank's
    results, the seconds the files took to write, the phase's seconds)."""
    import tempfile

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        for name, arrays in files.items():
            np.savez(os.path.join(tmp, name), **arrays)
        write_secs = time.perf_counter() - t0
        with open(os.path.join(tmp, "spec.json"), "w") as fh:
            json.dump(spec, fh)
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w") for r in range(MESH_RANKS)]
        procs = [subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"),
                                   "--mesh-rank-child", str(r), tmp], cwd=here,
                                  stdout=logs[r], stderr=subprocess.STDOUT,
                                  env={**os.environ, "LOCAL_RANK": str(r)})
                 for r in range(MESH_RANKS)]
        deadline = time.monotonic() + MESH_RANK_TIMEOUT
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:  # every rank is stopped, by its own PID
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for fh in logs:
                fh.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(tmp, f"rank{r}.log")) as fh:
                    raise PhaseFailed(f"{phase}: rank {r} exited with {p.returncode}:\n"
                                      f"{fh.read()[-3000:]}")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                ranks.append(json.load(fh))
    return ranks, write_secs, time.perf_counter() - t_phase


def phase_mesh_ranks(ctx):
    """Four rank processes on the one card over gloo (block 2 x scenario 2),
    the same instance written once by this process: held against
    mesh_world1's trace at 50 iterations.  A correctness run: four processes
    share one card, so its rates are no scaling figure."""
    prob = ctx["large"]
    ranks, write_secs, secs = run_rank_children(
        "mesh_ranks", {"case": "large", "L": ctx["mesh_L"]},
        {"large.npz": dict(A_rows=prob.A.rows, A_vals=prob.A.vals,
                           A_num_rows=np.array(prob.A.num_rows), b=prob.b,
                           block_sizes=prob.partition.sizes, name=np.array(prob.name))})
    want = np.asarray(ctx["mesh_trace_at_rank_iters"], np.float64)
    f0 = np.asarray(ranks[0]["objective"], np.float64)
    rel = float(np.max(np.abs(f0 - want) / np.maximum(np.abs(want), 1e-30)))
    check(rel <= 1e-4, f"mesh_ranks: {rel:.2e} relative off mesh_world1's trace at "
          f"{MESH_RANK_ITERS}")
    for rk in ranks:
        check(rk["objective"] == ranks[0]["objective"] and rk["x_sum"] == ranks[0]["x_sum"],
              f"mesh_ranks: rank {rk['rank']} returned another result")
        check(rk["launches"]["proj_simplex_rows"] > 0,
              f"mesh_ranks: rank {rk['rank']} made no projection launch")
    launches = dict.fromkeys(bt.launch_counts(), 0)
    for rk in ranks:
        for name, c in rk["launches"].items():
            launches[name] += c
    S = len(ranks[0]["objective"])
    emit("mesh_ranks", ranks=MESH_RANKS, mesh={"row": 1, "block": 2, "scenario": 2},
         backend="gloo", device="cuda:0 (every rank)", iterations=MESH_RANK_ITERS,
         objective=ranks[0]["objective"], rel_diff_vs_world1_trace=rel,
         aggregate_iters_per_sec=S * MESH_RANK_ITERS / max(rk["loop_secs"] for rk in ranks),
         per_rank=[{k: rk[k] for k in ("rank", "coords", "launches", "collective_secs",
                                       "collective_calls", "loop_secs", "solve_secs",
                                       "load_secs", "peak_gb")} for rk in ranks],
         write_secs=write_secs, launches=launches, secs=secs)
    return launches


def phase_mesh_dryrun():
    """``dryrun_multichip(4, device="cuda")``: every sharded code path on
    tiny shapes against its unsharded twin, four ranks on the card (gloo).
    Its launches are those of the sharded solves alone; the twins' are
    reported apart."""
    from bsls_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    out = dryrun_multichip(MESH_RANKS, device="cuda", timeout=400)
    cases = out["cases"]
    check(len(cases) == 17 and max(cases.values()) <= 1e-4, f"mesh_dryrun: {cases}")
    for name in ("proj_simplex_rows", "pava_rows", "band_zmv", "band_grmv"):
        check(out["launches"].get(name, 0) > 0,
              f"mesh_dryrun: the ranks' sharded solves made no {name} launch")
    emit("mesh_dryrun", ranks=MESH_RANKS, cases=cases, launches=out["launches"],
         twin_launches=out["twin_launches"], secs=time.perf_counter() - t0)
    return {name: out["launches"].get(name, 0) for name in KERNELS}


# ------------------------------------------- the equality-constrained mesh

EQ_RANK_ITERS = 100  # mesh_eq_ranks: two outers of 50 at S = 128
EQ_RANK_INNER = 50
EQ_MESH_KW = dict(method="pgd", line_search="exact", eq_tol=1e-6, max_iter=EQ_BUDGET,
                  inner_iters=EQ_INNER, chunk=100)
# the reference's mesh-against-single-device limits: the objective of every
# outer (tests/test_serving.py holds a mesh endpoint's so) and the violation,
# max(1e-6, 3 x the single device's) (tests/test_sharding.py)
EQ_MESH_RTOL = 1e-4


def eq_on_mesh(prob, mesh, rows, consts, **kw):
    """``solve_equality_constrained`` on ``mesh`` with the unsharded loop's
    (rho_base, L_base, L_C) in its op_cache, so that the two loops take the
    same steps: a first call of one inner iteration builds the rank's tile of
    the stacked operator (and its own power iterations), whose constants are
    then replaced.  Returns (result, outer records, the tile, its build
    seconds, the second call's launches and seconds)."""
    cache = {}
    t0 = time.perf_counter()
    bt.solve_equality_constrained(prob, mesh=mesh, shard_rows=rows, op_cache=cache,
                                  method=kw["method"], line_search=kw["line_search"],
                                  max_iter=1, inner_iters=1, chunk=1)
    build_secs = time.perf_counter() - t0
    (key, entry), = cache.items()
    cache[key] = dataclasses.replace(entry, **dict(zip(("rho_base", "L_base", "LC"), consts)))
    rec = OuterRecords()
    reset_counts()
    t0 = time.perf_counter()
    res = bt.solve_equality_constrained(prob, mesh=mesh, shard_rows=rows, op_cache=cache,
                                        metrics=rec, **kw)
    secs = time.perf_counter() - t0
    return res, rec.outer, entry.place.dp, build_secs, read_counts(), secs


def _outer_rel(outer, want):
    """Largest relative difference of the per-outer objectives (every scenario)."""
    a = np.array([o["f"] for o in outer], np.float64)
    b = np.array([o["f"] for o in want], np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def phase_mesh_eq_world1(ctx):
    """The eq loop on traffic_like x 128 at full width on a world of one over
    NCCL, column-sharded and row-sharded, against the unsharded loop of
    ``solve_eq`` (the same budget and Lipschitz pair): every outer's
    objective and rho, the final violation; then the stacked step profiled,
    the pava line search at S = 4 (kernel 2, the z-space pair) against
    ``solve_eq_pava``, a reduced run that mesh_eq_ranks is held against, and
    kernel 1 at a rank's tile of the block 2 x scenario 2 mesh."""
    from bsls_tpu_torch.utils.profiling import profile_steps

    t_phase = time.perf_counter()
    prob, want = ctx["eq_prob"], ctx["eq_unsharded"]
    mesh = bt.make_mesh(block=1, device=DEV)
    runs, launches = {}, dict.fromkeys(bt.launch_counts(), 0)
    for name, rows in (("col", False), ("rows", True)):
        torch.cuda.reset_peak_memory_stats(DEV)
        res, outer, dp, build_secs, counts, secs = eq_on_mesh(prob, mesh, rows, want["consts"],
                                                              **EQ_MESH_KW)
        for k, c in counts.items():
            launches[k] += c
        _check_simplices(f"mesh_eq_world1 {name}", prob, res.x)
        rel = _outer_rel(outer, want["outer"])
        rho, rho_want = [o["rho"] for o in outer], [o["rho"] for o in want["outer"]]
        runs[name] = {
            "outers": len(outer), "iterations": res.iterations, "rho_by_outer": rho,
            "outer_objective_max_rel_diff": rel, "eq_violation": res.eq_violation,
            "eq_violation_unsharded": want["viol"], "stop_reason": res.stop_reason,
            "x_max_abs_diff": float(np.abs(res.x - want["x"]).max()),
            "build_secs": build_secs, "secs": secs,
            "aggregate_inner_iters_per_sec": EQ_SCENARIOS * res.iterations / sum(
                o["solve_secs"] for o in outer),
            "peak_gb": _peak_gb(), "launches": counts,
            "tile_bytes": {"top": _tensor_bytes(dp.A.top), "bottom": _tensor_bytes(dp.A.bottom)}}
        # the readings are printed with the line below, the checks after it
        runs[name]["_checks"] = (rho == rho_want, rel, res.eq_violation)
        ctx.setdefault("eq_mesh_tile", dp)
    # the pava line search at S = 4: kernel 2 and the z-space Lipschitz pair
    pava_want = ctx["eq_pava_unsharded"]
    res4, outer4, dp4, _, counts4, secs4 = eq_on_mesh(
        ctx["eq_prob4"], mesh, False, pava_want["consts"], method="pgd", line_search="pava",
        max_iter=EQ_PAVA_ITERS, inner_iters=EQ_PAVA_INNER, chunk=100)
    for k, c in counts4.items():
        launches[k] += c
    _check_simplices("mesh_eq_world1 pava", ctx["eq_prob4"], res4.x)
    pava = {"iterations": res4.iterations, "eq_violation": res4.eq_violation,
            "eq_violation_unsharded": pava_want["viol"],
            "outer_objective_max_rel_diff": _outer_rel(outer4, pava_want["outer"]),
            "secs": secs4, "launches": counts4}
    # the reduced run the four ranks are held against
    ranks_kw = dict(EQ_MESH_KW, max_iter=EQ_RANK_ITERS, inner_iters=EQ_RANK_INNER, chunk=50)
    res_r, outer_r, *_ = eq_on_mesh(prob, mesh, False, want["consts"], **ranks_kw)
    ctx["eq_ranks_want"] = {"objective": np.asarray(res_r.objective),
                            "outer_f": [o["f"] for o in outer_r]}
    dp = ctx["eq_mesh_tile"]
    prof = profile_steps(dp, "exact", iters=20)
    # kernel 1 at the tile of one rank of block 2 x scenario 2: half of each
    # bucket's rows (w = 12 included), 64 scenarios
    half = types.SimpleNamespace(buckets=tuple(
        dataclasses.replace(bk, mask=bk.mask[: bk.mask.shape[0] // 2],
                            sizes=bk.sizes[: bk.mask.shape[0] // 2],
                            radius=bk.radius[: bk.mask.shape[0] // 2]) for bk in dp.buckets))
    err, rows_at, grouped = check_rows_at("proj_simplex_rows", half, EQ_SCENARIOS // 2, seed=91)
    emit("mesh_eq_world1", instance=f"traffic_like(seed=0, num_blocks=10000, m=100000, "
         f"num_eq=50) x {EQ_SCENARIOS}", backend=torch.distributed.get_backend(),
         mesh=dict(mesh.shape), budget=EQ_BUDGET, inner_iters_max=EQ_INNER,
         lipschitz_pair_of_solve_eq=list(want["consts"]),
         **{name: {k: v for k, v in r.items() if k != "_checks"} for name, r in runs.items()},
         pava_s4=pava, launches=launches,
         device_idle_share=prof["device_idle_share"],
         device_busy_ms_per_inner_step=prof["device_busy_ms_per_iter"],
         wall_ms_per_inner_step=prof["wall_ms_per_iter"],
         launches_per_inner_step=prof["launches_per_iter"],
         nccl_share_of_busy=prof.get("nccl_share_of_busy"),
         largest_device_items_ms_per_step=[[k["name"][:60], k["ms_per_iter"],
                                            k["launches_per_iter"]] for k in prof["kernels"][:8]],
         kernel1_at_rank_tile={"max_abs_err": err, "by_bucket": rows_at, "grouped": grouped},
         secs=time.perf_counter() - t_phase)
    for name, r in runs.items():
        same_rho, rel, viol = r["_checks"]
        check(same_rho, f"mesh_eq_world1 {name}: rho by outer {r['rho_by_outer']}")
        check(rel <= EQ_MESH_RTOL, f"mesh_eq_world1 {name}: outer objectives {rel:.2e} "
              f"relative off the unsharded loop's (limit {EQ_MESH_RTOL})")
        check(viol <= max(1e-6, 3 * want["viol"]), f"mesh_eq_world1 {name}: violation {viol}")
        check(r["launches"]["proj_simplex_rows"] >= r["iterations"],
              f"mesh_eq_world1 {name}: {r['launches']['proj_simplex_rows']} projections")
    check(res4.iterations <= counts4["pava_rows"] <= res4.iterations + len(outer4),
          f"mesh_eq_world1 pava: {counts4['pava_rows']} pava_rows launches in "
          f"{res4.iterations} inner iterations and {len(outer4)} outers")
    check(res4.eq_violation <= max(1e-6, 3 * pava_want["viol"]),
          f"mesh_eq_world1 pava: violation {res4.eq_violation}")
    return launches, err


def mesh_eq_rank(spec, workdir):
    """A rank of mesh_eq_ranks: the eq loop on traffic_like x 128 (from
    DIR/eq.npz) over a block 2 x scenario 2 mesh, by column and by row, at
    the reduced budget, with solve_eq's Lipschitz pair."""
    from bsls_tpu_torch.models import Problem

    prob = Problem.load(os.path.join(workdir, "eq.npz"))
    mesh = bt.make_mesh(block=2, scenario=2, device=DEV)
    kw = dict(EQ_MESH_KW, max_iter=EQ_RANK_ITERS, inner_iters=EQ_RANK_INNER, chunk=50)
    out = {"coords": mesh.coords}
    for name, rows in (("col", False), ("rows", True)):
        res, outer, dp, build_secs, counts, secs = eq_on_mesh(prob, mesh, rows,
                                                              spec["consts"], **kw)
        out[name] = {"objective": np.asarray(res.objective).tolist(),
                     "outer_f": [o["f"] for o in outer] if mesh.rank == 0 else None,
                     "eq_violation": res.eq_violation, "rho": res.eq_rho,
                     "x_sum": float(np.sum(res.x)), "launches": counts,
                     "build_secs": build_secs, "secs": secs,
                     "tile_rows": [list(bk.mask.shape) for bk in dp.buckets]}
    return out


def phase_mesh_eq_ranks(ctx):
    """Four rank processes on the one card over gloo, block 2 x scenario 2,
    the eq loop by column and by row at the reduced budget: every rank the
    same result, held against mesh_eq_world1's reduced run.  A correctness
    run, no scaling figure."""
    prob = ctx["eq_prob"]
    A = prob.A
    arrays = dict(A_rows=A.rows, A_vals=A.vals, A_num_rows=np.array(A.num_rows), b=prob.b,
                  block_sizes=prob.partition.sizes, C_dense=prob.C.data, d=prob.d,
                  name=np.array(prob.name))
    ranks, write_secs, secs = run_rank_children(
        "mesh_eq_ranks", {"case": "eq", "consts": list(ctx["eq_unsharded"]["consts"])},
        {"eq.npz": arrays})
    want = ctx["eq_ranks_want"]
    rels = {}
    for name in ("col", "rows"):
        f0 = np.asarray(ranks[0][name]["objective"], np.float64)
        rels[name] = float(np.max(np.abs(f0 - want["objective"]) / np.abs(want["objective"])))
    launches = dict.fromkeys(bt.launch_counts(), 0)
    for rk in ranks:
        for name in ("col", "rows"):
            for k, c in rk[name]["launches"].items():
                launches[k] += c
    emit("mesh_eq_ranks", ranks=MESH_RANKS, mesh={"row": 1, "block": 2, "scenario": 2},
         backend="gloo", device="cuda:0 (every rank)", iterations=EQ_RANK_ITERS,
         inner_iters_max=EQ_RANK_INNER, rel_diff_vs_world1=rels,
         per_rank=[{"rank": rk["rank"], "coords": rk["coords"],
                    **{name: {k: rk[name][k] for k in ("eq_violation", "build_secs", "secs",
                                                       "launches", "tile_rows")}
                       for name in ("col", "rows")},
                    "collective_secs": rk["collective_secs"],
                    "collective_calls": rk["collective_calls"], "peak_gb": rk["peak_gb"]}
                   for rk in ranks],
         # the loops' seconds, their host updates and warm-up steps included
         aggregate_inner_iters_per_sec={
             name: EQ_SCENARIOS * EQ_RANK_ITERS / max(rk[name]["secs"] for rk in ranks)
             for name in ("col", "rows")},
         write_secs=write_secs, launches=launches, secs=secs)
    for name in ("col", "rows"):
        check(rels[name] <= EQ_MESH_RTOL, f"mesh_eq_ranks {name}: {rels[name]:.2e} relative off "
              f"mesh_eq_world1's reduced run")
        for rk in ranks:
            check(rk[name]["objective"] == ranks[0][name]["objective"]
                  and rk[name]["x_sum"] == ranks[0][name]["x_sum"]
                  and rk[name]["rho"] == ranks[0][name]["rho"],
                  f"mesh_eq_ranks {name}: rank {rk['rank']} returned another result")
            check(rk[name]["launches"]["proj_simplex_rows"] > 0,
                  f"mesh_eq_ranks {name}: rank {rk['rank']} made no projection launch")
    return launches


SERVE_EQ_BUDGET = 800  # serve_mesh's traffic_like x 128 requests: two outers of 400


def phase_serve_mesh(ctx, prob, base):
    """Serving on a world of one over NCCL: an ``Endpoint(mesh=)`` of medium x
    128 answers three streamed requests, each held against the unsharded
    endpoint with the mesh endpoint's Lipschitz estimate; two eq mesh
    endpoints: the preset ``traffic`` (a certified request, then one on the
    sensitivity fast path from the gathered warm x, against serve_eq's
    oracle) and traffic_like x 128 (two requests on one stacked operator); a
    ``BatchQueue`` over the mesh endpoint, 8 client threads, against one
    batched solve on it."""
    from bsls_tpu_torch.parallel import sharding as SH

    t_phase = time.perf_counter()
    mesh = bt.make_mesh(block=1, device=DEV)
    t0 = time.perf_counter()
    ep = bt.Endpoint(prob, method="pgd", line_search="exact", chunk=100, mesh=mesh)
    build_secs = time.perf_counter() - t0
    ep.warmup(SCENARIOS)
    reqs = [np.asarray(bt.synthetic.with_scenarios(base, SCENARIOS, seed=s).b) for s in (2, 3, 4)]
    reset_counts()
    results, walls = [], []
    for B in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(ep.solve(B, tol=0.0, max_iter=SERVE_ITERS))
        walls.append(time.perf_counter() - t0)
    counts = read_counts()
    check(counts["proj_simplex_rows"] >= len(reqs) * SERVE_ITERS,
          f"serve_mesh: proj_simplex_rows launched {counts['proj_simplex_rows']} times")
    ep_u = bt.Endpoint(prob, method="pgd", line_search="exact", chunk=100, device=DEV)
    diffs = []
    for B, res in zip(reqs, results):
        _check_simplices("serve_mesh", prob, res.x)
        direct = ep_u.solve(B, tol=0.0, max_iter=SERVE_ITERS, lipschitz=ep._lip)
        diffs.append(_rel_diff(res.objective, direct.objective))
    loop = [float(np.sum(r.chunk_times)) for r in results]
    del ep_u

    # eq mesh endpoints: (a) the preset traffic, a certified request, then a
    # perturbed one on the float64 sensitivity fast path from the gathered
    # warm x, against serve_eq's oracle; (b) traffic_like x 128, two requests
    # on one stacked operator (counted by wrapping the two sharded prepares)
    from bsls_tpu_torch.utils.config import load_config

    cfg = load_config("traffic")
    small = bt.synthetic.make_config(cfg.config, seed=cfg.seed)
    ep_t = bt.Endpoint(small, method=cfg.method, line_search=cfg.line_search,
                       chunk=cfg.chunk, mesh=mesh)
    reset_counts()
    t0 = time.perf_counter()
    r1 = ep_t.solve(np.asarray(small.b), tol=cfg.tol, max_iter=cfg.max_iter, refine_tol=1e-6)
    t1 = time.perf_counter()
    r2 = ep_t.solve(ctx["serve_eq_traffic"]["b2"], tol=cfg.tol, max_iter=cfg.max_iter)
    t2 = time.perf_counter()
    for k, c in read_counts().items():
        counts[k] += c
    f_orc = ctx["serve_eq_traffic"]["oracle"]
    traffic = {"request1_secs": t1 - t0, "request1_converged": r1.converged,
               "request1_eq_violation": r1.eq_violation,
               "request1_certificate": r1.refine_fw_gap, "request2_secs": t2 - t1,
               "request2_stop_reason": r2.stop_reason, "request2_eq_violation": r2.eq_violation,
               "request2_rel_to_oracle": abs(float(r2.objective) - f_orc) / max(abs(f_orc),
                                                                                1e-30)}
    big = ctx["eq_prob"]
    ep_eq = bt.Endpoint(big, method="pgd", line_search="exact", chunk=100, mesh=mesh)
    builds, real = [0], (SH.shard_problem, SH.shard_problem_rows)

    def counted(fn):
        def run(*a, **k):
            builds[0] += 1
            return fn(*a, **k)
        return run

    B1 = np.asarray(big.b)
    B2 = (B1 * (1.0 + 0.01 * np.random.default_rng(71).standard_normal(B1.shape))
          ).astype(np.float32)
    eq_rows = []
    SH.shard_problem, SH.shard_problem_rows = counted(real[0]), counted(real[1])
    try:
        for B in (B1, B2):
            reset_counts()
            t0 = time.perf_counter()
            res = ep_eq.solve(B, max_iter=SERVE_EQ_BUDGET, inner_iters=EQ_INNER, eq_tol=1e-6,
                              sensitivity=False)
            secs = time.perf_counter() - t0
            c = read_counts()
            for k in counts:
                counts[k] += c[k]
            _check_simplices("serve_mesh eq", big, res.x)
            eq_rows.append({"secs": secs, "iterations": res.iterations,
                            "converged": res.converged, "stop_reason": res.stop_reason,
                            "eq_violation": res.eq_violation,
                            "warm_entries_after": len(ep_eq._eq_warm),
                            "proj_simplex_rows_launches": c["proj_simplex_rows"]})
    finally:
        SH.shard_problem, SH.shard_problem_rows = real
    n_ops = len(ep_eq._eq_ops)
    del ep_eq
    emit("serve_mesh", instance=f"medium_sparse(seed=0) x {SCENARIOS}", mesh=dict(mesh.shape),
         endpoint_build_secs=build_secs, lipschitz=ep._lip, requests=len(reqs),
         iterations=SERVE_ITERS, request_wall_secs=walls, chunk_loop_secs=loop,
         outside_chunk_loop_secs=[w - lp for w, lp in zip(walls, loop)],
         max_rel_diff_to_unsharded_endpoint=max(diffs), rel_diff_by_request=diffs,
         aggregate_iters_per_sec_by_wall=[SCENARIOS * SERVE_ITERS / w for w in walls],
         eq_traffic=traffic, eq={"instance": f"traffic_like x {EQ_SCENARIOS}",
                                 "stacked_builds": builds[0], "requests": eq_rows},
         launches=counts, phase_secs=time.perf_counter() - t_phase)
    check(max(diffs) <= MESH_WORLD1_RTOL, f"serve_mesh: requests {max(diffs):.2e} relative "
          f"off the unsharded endpoint's (limit {MESH_WORLD1_RTOL})")
    check(builds[0] == 1 and n_ops == 1,
          f"serve_mesh: {builds[0]} stacked builds, {n_ops} op_cache entries")
    # the warm state is kept from converged requests only, as in the reference
    check(all(r["warm_entries_after"] == int(r["converged"]) for r in eq_rows),
          f"serve_mesh: warm state after unconverged requests ({eq_rows})")
    check(r1.converged and r1.refine_fw_gap is not None and r1.refine_fw_gap <= 1e-6,
          f"serve_mesh: the traffic request converged {r1.converged}, certificate "
          f"{r1.refine_fw_gap}")
    check(r2.stop_reason == "sensitivity" and r2.eq_violation <= 1e-6
          and traffic["request2_rel_to_oracle"] <= 1e-9,
          f"serve_mesh: the warm traffic request {traffic}")
    q_counts = phase_serve_queue(prob, base, mesh=mesh)
    for k in counts:
        counts[k] += q_counts[k]
    return counts


def phase_mesh(ctx, report):
    """The mesh phases (config 4, then the equality-constrained loop); their
    launches and the kernels' errors at the shard shapes go into
    ``report``."""
    t0 = time.perf_counter()
    ctx["large"] = bt.synthetic.large_sharded(seed=0)
    ctx["large_gen_secs"] = time.perf_counter() - t0
    launches, row_checks = phase_mesh_world1(ctx)
    page_checks = check_pages_at_shard(ctx)
    paths = [launches, phase_mesh_ranks(ctx), phase_mesh_dryrun()]
    for name, nums in {**row_checks, **page_checks}.items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], nums["max_abs_err"])
        report[name]["at_shard_shapes"] = nums
    del ctx["large"]
    eq_launches, eq_err = phase_mesh_eq_world1(ctx)
    paths += [eq_launches, phase_mesh_eq_ranks(ctx)]
    row = report["proj_simplex_rows"]
    row["max_abs_err"] = max(row["max_abs_err"], eq_err)
    row["at_eq_rank_tile_max_abs_err"] = eq_err
    return paths


def chunk0_child():
    """``--chunk0-child``: a fresh process that solves medium x 128 (pgd,
    exact, three chunks of 100) and prints its chunk wall times.  The kernel
    library is already built; what chunk 0 may carry beyond chunk 1 is the
    library's load and every first launch."""
    base = bt.synthetic.medium_sparse(seed=0)
    dp = bt.prepare(bt.synthetic.with_scenarios(base, SCENARIOS, seed=1), device=DEV)
    res = bt.solve(dp, method="pgd", line_search="exact", tol=0.0, max_iter=300, chunk=100)
    print(json.dumps({"chunk_secs": [float(t) for t in res.chunk_times]}), flush=True)


def phase_chunk0():
    """Chunk 0 against chunk 1 of the exact path in a fresh process: the
    library's load and the first launches come before the clock."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.join(here, "chip_smoke.py"), "--chunk0-child"],
                          capture_output=True, text=True, cwd=here, timeout=600)
    check(proc.returncode == 0, f"chunk0: the child failed:\n{proc.stderr[-2000:]}")
    secs = json.loads(proc.stdout.strip().splitlines()[-1])["chunk_secs"]
    ratio = secs[0] / secs[1]
    emit("chunk0", scenarios=SCENARIOS, chunk_secs=secs, chunk0_secs=secs[0],
         chunk1_secs=secs[1], ratio=ratio)
    check(ratio <= 3.0, f"chunk0: chunk 0 took {ratio:.2f} x chunk 1 after the warm-up")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true", help="print nvcc's per-kernel resource report")
    ap.add_argument("--stop-after", choices=["kernels"], default=None,
                    help="stop (exit code 3, no result line) after this phase: a short first "
                         "run for a new kernel")
    ap.add_argument("--chunk0-child", action="store_true",
                    help="the fresh process of the chunk0 phase (prints its chunk times only)")
    ap.add_argument("--checkpoint-child", default=None, metavar="PATH",
                    help="the process of the checkpoint phase that is killed mid-run")
    ap.add_argument("--mesh-rank-child", nargs=2, default=None, metavar=("RANK", "DIR"),
                    help="a rank process of the mesh_ranks phase")
    args = ap.parse_args()
    count_calls()
    if args.chunk0_child:
        chunk0_child()
        return
    if args.checkpoint_child:
        checkpoint_child(args.checkpoint_child)
        return
    if args.mesh_rank_child:
        mesh_rank_child(int(args.mesh_rank_child[0]), args.mesh_rank_child[1])
        return
    t_start = time.perf_counter()

    phase_device()
    phase_build(args.ptxas)

    t0 = time.perf_counter()
    base = bt.synthetic.medium_sparse(seed=0)
    prob = bt.synthetic.with_scenarios(base, SCENARIOS, seed=1)
    dp = bt.prepare(prob, device=DEV)
    emit("instance", name=prob.name, blocks=int(prob.partition.num_blocks),
         shape=list(prob.A.shape), nnz=int(prob.A.nnz), n_pf=int(dp.n_pf),
         buckets=[list(bk.mask.shape) for bk in dp.buckets], scenarios=SCENARIOS,
         row_groups=[list(c.shape) for c in dp.A.mv_cols],
         col_groups=[list(c.shape) for c in dp.A.rt_rows],
         prepare_secs=round(time.perf_counter() - t0, 2))

    ctx = {"medium": dp, "medium_base": base, "banded": {}, "banded_prob": {},
           "banded_info": {}}
    banded_base = bt.synthetic.medium_banded(seed=0)
    for S in (1, 4):
        ctx["banded_prob"][S], ctx["banded"][S], ctx["banded_info"][S] = prepare_banded(
            banded_base, S)
    t0 = time.perf_counter()
    ctx["eq_base"], ctx["eq_prob"] = eq_instance(EQ_SCENARIOS)
    ctx["eq_prob4"] = bt.synthetic.with_scenarios(ctx["eq_base"], 4, seed=1)
    ctx["eq_row_errs"] = {}
    emit("instance_eq", name=ctx["eq_prob"].name, blocks=int(ctx["eq_base"].partition.num_blocks),
         shape=list(ctx["eq_base"].A.shape), nnz=int(ctx["eq_base"].A.nnz),
         C=list(ctx["eq_base"].C.shape), scenarios=EQ_SCENARIOS,
         gen_secs=round(time.perf_counter() - t0, 2))
    ctx["tiny_prob"] = bt.synthetic.tiny_dense(seed=0)
    ctx["tiny"] = bt.prepare(ctx["tiny_prob"], device=DEV)
    ctx["pava_inputs"] = capture_pava_inputs(dp)

    report = phase_kernels(ctx)
    if args.stop_after == "kernels":
        sys.exit(3)

    def graphed(phase, fn, *a):
        """``fn(*a)`` with a line of its captures, hits, replays and pools."""
        with graph_report(phase):
            return fn(*a)

    launches = graphed("solve_exact", phase_solve, "solve_exact", prob, dp, "exact", 200,
                       ("proj_simplex_rows", "ell_gather_dot") + STEP_KERNELS)
    report["proj_simplex_rows"]["launches"] = launches["proj_simplex_rows"]
    report["ell_gather_dot"]["launches"] = launches["ell_gather_dot"]
    report["pgd_step"]["launches"] = sum(launches[k] for k in STEP_KERNELS)
    launches = graphed("solve_pava", phase_solve, "solve_pava", prob, dp, "pava", 200,
                       ("pava_rows", "ell_gather_dot"))
    report["pava_rows"]["launches"] = launches["pava_rows"]
    report["ell_gather_dot"]["launches"] += launches["ell_gather_dot"]
    graphed("cross_check", phase_cross_check, base)
    phase_float64_refused(ctx, base)
    launches = graphed("solve_banded", phase_solve_banded, ctx)
    report["band_zmv"]["launches"] = launches["band_zmv"]
    report["band_grmv"]["launches"] = launches["band_grmv"]
    report["ell_gather_dot"]["launches"] += launches["ell_gather_dot"]  # the residual ELL
    launches, eager_ms, graphed_ms = graphed("solve_mega", phase_solve_mega, ctx)
    report["pgd_chunk"]["launches"] = launches["pgd_chunk"]
    report["pgd_chunk"]["eager_solve_ms_per_step"] = eager_ms
    report["pgd_chunk"]["graphed_solve_ms_per_step"] = graphed_ms

    # the other families, certify and refine add their launches to the rows
    # of the kernels they run
    new_paths = [graphed("solve_families", phase_solve_families, prob, dp)]
    graphed("cross_check_families", phase_cross_check_families, base)
    new_paths.append(graphed("certify", phase_certify, prob, dp))
    new_paths.append(graphed("refine", phase_refine, prob, dp))
    new_paths.append(graphed("refine_certified", phase_refine_certified, base))
    new_paths.append(graphed("solve_banded_families", phase_solve_banded_families, ctx))
    # the equality-constrained path: kernel 1 in every inner solve, kernel 2
    # in the z-space ones
    new_paths.append(graphed("solve_eq", phase_solve_eq, ctx))
    new_paths.append(graphed("solve_eq_pava", phase_solve_eq_pava, ctx))
    new_paths.append(graphed("solve_eq_traffic", phase_solve_eq_traffic))
    # serving and checkpoint/resume: kernel 1 in every request
    new_paths.append(graphed("serve", phase_serve, prob, base))
    new_paths.append(graphed("serve_queue", phase_serve_queue, prob, base))
    new_paths.append(graphed("serve_eq", phase_serve_eq, ctx))
    new_paths.append(graphed("checkpoint", phase_checkpoint, prob, dp))
    # the mesh: config 4 at full width (world of one over NCCL, four ranks on
    # the card over gloo) and the dry run; kernels 1-4 at rank shard shapes
    # (the mesh's chunks run eager; the unsharded twins are graphed)
    new_paths.extend(graphed("mesh", phase_mesh, ctx, report))
    # serving on a mesh: both endpoint kinds and the queue over one
    new_paths.append(graphed("serve_mesh", phase_serve_mesh, ctx, prob, base))
    for name, err in ctx["eq_row_errs"].items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    phase_chunk0()
    for counts in new_paths:
        for name in report:
            report[name]["launches"] += counts.get(name, 0)
        report["pgd_step"]["launches"] += sum(counts.get(k, 0) for k in STEP_KERNELS)

    for name, row in report.items():
        check(row["launches"] > 0, f"{name} was not launched on its path")
    emit("total", secs=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
