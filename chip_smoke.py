#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device, nvcc and g++
    python3 chip_smoke.py --ptxas    # also print registers/spills per kernel
    python3 chip_smoke.py --ptxas --stop-after kernels   # short run for a new kernel

Drives ``bsls_tpu_torch`` only (nothing of JAX): builds the native host
library and the CUDA kernels from the sources in this checkout, holds every
kernel against its plain PyTorch version on the card, and runs three paths
through ``prepare``/``solve``:

* the batched PGD solve on ``synthetic.medium_sparse`` x 128 scenarios with the
  exact and the pava line search (gather layout; projection and PAVA kernels),
  cross-checked against the CPU;
* the banded layout on ``synthetic.medium_banded`` (the preset
  ``medium-banded``: bbm line search), single right-hand side and 4 scenarios
  (the two page kernels), and forced-banded against gather;
* the fused chunk (``BSLS_MEGA=1``) on ``synthetic.tiny_dense`` against the
  eager path of the same solve.

Every phase prints one JSON line; a failed phase raises and the script exits
non-zero without the result line.  The last line is ``{"ok": true, "device":
{...}}``, the line before it lists every kernel with its launches on its path,
its error, its time, the plain version's time, its bound and, where one
PyTorch call computes the same function, that call's time.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script runs on a GPU only")

import bsls_tpu_torch as bt  # noqa: E402
from bsls_tpu_torch import native  # noqa: E402
from bsls_tpu_torch.ops import chunkkernel, cudalib, pagekernels, rowkernels  # noqa: E402
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


def phase_build(ptxas):
    t0 = time.perf_counter()
    host_native = native.native_available()  # builds the host library with g++
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    lib = cudalib.build_library(verbose=ptxas)
    t_cuda = time.perf_counter() - t0
    emit("build", host_layout_engine="native" if host_native else "numpy fallback",
         native_secs=round(t_native, 2), cuda_library=lib.split("bsls_tpu_torch/")[-1],
         cuda_secs=round(t_cuda, 2))


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


def random_rows(lead, Bk, w, seed):
    """Ragged widths (0 = dummy row, radius 1), per-row radius, values of the
    size the solver produces (a few radii)."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, w + 1, size=Bk).astype(np.int32)
    radius = rng.uniform(0.5, 5.0, size=Bk).astype(np.float32)
    radius[widths == 0] = 1.0
    v = (rng.standard_normal(lead + (Bk, w)) * 2).astype(np.float32) * radius[:, None]
    to = lambda a: torch.from_numpy(a).to(DEV)
    return to(v), to(widths), to(radius)


def _mask(v, widths):
    return (torch.arange(v.shape[-1], device=v.device) < widths[:, None]).to(v.dtype)


def _proj_structure(name, got, widths, radius, pad):
    real = widths > 0
    sums = got.sum(-1)[..., real]
    rel = ((sums - radius[real]).abs() / radius[real]).max() if real.any() else 0.0
    check(float(rel) <= 1e-5, f"{name}: row sums off by {float(rel):.2e} relative")
    check(float(got.min()) >= 0.0, f"{name}: negative entry")


def _pava_structure(name, got, widths, radius, pad):
    inner = ~pad[:, 1:]
    steps = (got[..., 1:] - got[..., :-1]).masked_select(inner.expand_as(got[..., 1:]))
    check(steps.numel() == 0 or float(steps.min()) >= 0.0, f"{name}: fit is not nondecreasing")
    check(float(got.min()) >= 0.0 and bool((got <= radius[:, None]).all()),
          f"{name}: fit leaves [0, radius]")


def compare_rows(name, spec, v, widths, radius):
    """Max abs difference kernel vs plain, in units of the largest radius,
    plus the structural checks."""
    got = spec["fn"](v, widths, radius)
    torch.cuda.synchronize()
    want = spec["plain"](v, widths, radius)
    check(got.shape == v.shape and got.dtype == v.dtype, f"{name}: wrong output shape/dtype")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    pad = torch.arange(v.shape[-1], device=DEV) >= widths[:, None]
    check(float(got.masked_select(pad.expand_as(got)).abs().sum()) == 0.0,
          f"{name}: padding slots or dummy rows are not zero")
    spec["structure"](name, got, widths, radius, pad)
    err = float((got - want).abs().max() / radius.max())
    check(err <= ROW_ERR_LIMIT, f"{name}: differs from the plain version by {err:.2e} x max "
          f"radius at shape {tuple(v.shape)}")
    return err


def check_rows(name, spec, ctx):
    """Ragged random cases, then the bucket shapes of medium x 128."""
    errs, shapes = [], []
    for w in (1, 2, 3, 4, 8, 16, 32, 64):
        for lead in ((), (3,)):  # (Bk, w) rows and a folded scenario axis
            v, widths, radius = random_rows(lead, 1003, w, seed=100 * w + len(lead))
            errs.append(compare_rows(name, spec, v, widths, radius))
            shapes.append(list(v.shape))
    return max(errs), shapes, ROW_ERR_LIMIT


def measure_rows(name, spec, ctx):
    """One application to all buckets of medium x 128 (one launch each)."""
    dp = ctx["medium"]
    ms = plain_ms = bytes_ = ops = 0.0
    errs, per_bucket = [], []
    for i, bk in enumerate(dp.buckets):
        # the tensors the main path hands the kernel: (S, Bk, w), the bucket's
        # own sizes (sizes - 1 for the z-space fit) and radii
        widths = spec["widths_of"](bk)
        gen = torch.Generator(device=DEV).manual_seed(7 + i)
        # four inputs in turn: together they exceed the 50 MB L2 cache, so
        # every launch finds its rows in device memory
        vs = [torch.randn((SCENARIOS,) + tuple(bk.mask.shape), generator=gen, device=DEV)
              * 2 * bk.radius[:, None] for _ in range(4)]
        errs.append(compare_rows(name, spec, vs[0], widths, bk.radius))
        launch = lambda j: spec["fn"](vs[j % 4], widths, bk.radius)
        k_ms, c_ms = device_ms(launch), call_ms(launch)
        p_ms = call_ms(lambda j: spec["plain"](vs[j % 4], widths, bk.radius), reps=4)
        rows, w = vs[0].numel() // bk.width, bk.width
        b_bytes = 2 * 4 * rows * w + 8 * bk.mask.shape[0]
        b_ops = rows * spec["ops_per_row"](w)
        per_bucket.append({"shape": list(vs[0].shape), "ms": k_ms, "call_ms": c_ms,
                           "plain_ms": p_ms, "bound_ms": bound(b_bytes, b_ops)[0]})
        ms, plain_ms, bytes_, ops = ms + k_ms, plain_ms + p_ms, bytes_ + b_bytes, ops + b_ops
    b_ms, by = bound(bytes_, ops)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                library_ms=None, per_bucket=per_bucket)


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


def check_pages(name, spec, ctx):
    """Every S x C x W of the grid, Mp a prime, plus strided operands."""
    gen = torch.Generator(device=DEV).manual_seed(11)
    errs, shapes = [], []
    Mp = 37
    for C in (1, 7, 52, 160):
        for W in (128, 384, 512, 1024):
            band = torch.randn((Mp, C, W), generator=gen, device=DEV)
            K = band.shape[spec["contracted"]]
            for S in (1, 2, 3, 4, 15, 16, 33):
                v = torch.randn((S, Mp, K), generator=gen, device=DEV)
                errs.append(compare_pages(name, spec, band, v))
                shapes.append([S, Mp, C, W])
    # operands as the layout hands them over: the segment of a PF-flat vector,
    # and the sliding page windows of a padded residual
    band = torch.randn((Mp, 7, 384), generator=gen, device=DEV)
    if spec["contracted"] == 1:
        x_pf = torch.randn((3, 11 + Mp * 7 + 5), generator=gen, device=DEV)
        v = x_pf[:, 11:11 + Mp * 7].reshape(3, Mp, 7)
    else:
        rp = torch.randn((3, (Mp + 3) * PAGE), generator=gen, device=DEV)
        v = rp.as_strided((3, Mp, 384), (rp.stride(0), PAGE, 1))
    check(not v.is_contiguous(), f"{name}: the strided case is contiguous")
    errs.append(compare_pages(name, spec, band, v))
    shapes.append("strided view")
    return max(errs), shapes, PAGE_ERR_LIMIT


def measure_pages(name, spec, ctx):
    """The real band tensors of medium_banded, S = 1 and S = 4: all buckets of
    one product (one launch each).  ``ms`` etc. are the single-RHS numbers;
    ``per_s`` has both."""
    errs, per_s = [], {}
    for S, dp in sorted(ctx["banded"].items()):
        A = dp.A
        gen = torch.Generator(device=DEV).manual_seed(13 + S)
        ms = c_ms = plain_ms = lib_ms = bytes_ = ops = 0.0
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
            bytes_ += 4 * (band.numel() + v.numel() + S * Mp * out_w)
            ops += 2 * S * band.numel()
        b_ms, by = bound(bytes_, ops)
        per_s[S] = {"S": S, "bands": [list(b.shape) for b in A.bands], "ms": ms,
                    "call_ms": c_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": b_ms, "bound_by": by}
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


def check_chunk(name, spec, ctx):
    """200 steps on tiny_dense against the plain loop; twice, bit for bit."""
    dp = ctx["tiny"]
    args = _chunk_inputs(dp)
    bk = dp.buckets[0]
    x, f = spec["fn"](*args, 200)
    x2, f2 = spec["fn"](*args, 200)
    torch.cuda.synchronize()
    xp, fp = spec["plain"](*args, 200)
    check(x.shape == xp.shape and f.shape == (200,), f"{name}: wrong output shapes")
    check(bool(torch.isfinite(x).all() and torch.isfinite(f).all()), f"{name}: non-finite output")
    check(bool(torch.equal(f, f2) and torch.equal(x, x2)),
          f"{name}: two launches on the same input differ")
    rel = float(((f - fp).abs() / torch.clamp(fp.abs(), min=1e-9)).max())
    check(rel <= CHUNK_TRACE_LIMIT, f"{name}: f-trace differs by {rel:.2e} relative")
    err = float((x - xp).abs().max())
    check(err <= CHUNK_X_LIMIT, f"{name}: x differs by {err:.2e}")
    check(float(x.min()) >= 0.0, f"{name}: negative entry")
    sums = (x * bk.mask).sum(-1)
    check(float(((sums - bk.radius).abs() / bk.radius).max()) <= 1e-5,
          f"{name}: block sums leave the radius")
    check(bool((f[1:] <= f[:-1] * (1 + 1e-5)).all()), f"{name}: the objective rose")
    # one step, and a step count that is no multiple of anything
    for steps in (1, 7):
        xs, fs = spec["fn"](*args, steps)
        xq, fq = spec["plain"](*args, steps)
        check(float((xs - xq).abs().max()) <= CHUNK_X_LIMIT
              and float(((fs - fq).abs() / fq.abs()).max()) <= CHUNK_TRACE_LIMIT,
              f"{name}: {steps} steps differ from the plain loop")
    ctx["chunk_err"] = {"x_abs": err, "trace_rel": rel}
    return err, [list(dp.A.data.shape), list(x.shape), 200], CHUNK_X_LIMIT


def measure_chunk(name, spec, ctx, steps=100):
    """One launch of ``steps`` iterations on tiny_dense, as solve makes it."""
    dp = ctx["tiny"]
    args = _chunk_inputs(dp)
    m, n = dp.A.data.shape
    # a cooperative launch is timed between events, not in a graph; at a
    # millisecond a launch the host's share is nothing
    ms = call_ms(lambda j: spec["fn"](*args, steps), reps=10)
    plain_ms = call_ms(lambda j: spec["plain"](*args, steps), reps=2, warm=1)
    bytes_ = 4 * (m * n + 2 * m + 2 * n + n + steps)  # A, b, x0, widths+radius, x, f
    ops = steps * (4 * m * n + 10 * n + 6 * m)
    b_ms, by = bound(bytes_, ops)
    return dict(max_abs_err=ctx["chunk_err"]["x_abs"], trace_rel_err=ctx["chunk_err"]["trace_rel"],
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by, library_ms=None,
                steps_per_launch=steps, ms_per_step=ms / steps)


# Every kernel brings its wrapper, its plain version, its cases (check) and
# its timing at the shapes of its path with its bound (measure).
KERNELS = {
    "proj_simplex_rows": dict(
        fn=rowkernels.proj_simplex_rows,
        plain=lambda v, widths, radius: proj_simplex_padded(v, _mask(v, widths), radius),
        source="bsls_tpu_torch/csrc/proj_simplex_rows.cu",
        # the lane-major kernel; its row-major twin is projection_kernel.py:187
        replaces="bsls_tpu/ops/pallas/projection_kernel.py:132",
        check=check_rows, measure=measure_rows, structure=_proj_structure,
        widths_of=lambda bk: bk.sizes,
        # per row: w^2/2 compare-exchanges of 2 operations, ~8 more per slot
        ops_per_row=lambda w: w * w + 8 * w,
    ),
    "pava_rows": dict(
        fn=rowkernels.pava_rows,
        plain=lambda v, widths, radius: pava_padded(v, _mask(v, widths), 0.0, radius,
                                                    chunk=1 << 17),
        source="bsls_tpu_torch/csrc/pava_rows.cu",
        # the lane-major kernel; its row-major twin is pava_kernel.py:181
        replaces="bsls_tpu/ops/pallas/pava_kernel.py:132",
        check=check_rows, measure=measure_rows, structure=_pava_structure,
        widths_of=lambda bk: torch.clamp(bk.sizes - 1, min=0),
        # per row: at most 2w pushes/pops of ~5 operations, ~4 more per slot
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
}


def phase_kernels(ctx):
    """Each kernel against its plain version on its own cases, then timed at
    the shapes its path gives it.  Returns the per-kernel numbers of the last
    JSON line but one."""
    report = {}
    for name, spec in KERNELS.items():
        err, shapes, limit = spec["check"](name, spec, ctx)
        nums = spec["measure"](name, spec, ctx)
        nums["max_abs_err"] = max(err, nums["max_abs_err"])
        report[name] = {"name": name, "route": "cuda", "source": spec["source"],
                        "replaces": spec["replaces"], "launches": 0, **nums}
        emit("kernels", kernel=name, limit=limit, cases=len(shapes),
             shapes_checked=shapes if len(shapes) <= 24 else shapes[:6] + ["..."] + shapes[-2:],
             **nums)
    return report


# --------------------------------------------------------------- the solves


def f64_objective(prob, x, scenario):
    A = prob.A.to_scipy().astype(np.float64)
    b = np.asarray(prob.b, np.float64)
    xs, bs = (x, b) if b.ndim == 1 else (x[scenario], b[scenario])
    r = A @ xs.astype(np.float64) - bs
    return 0.5 * float(r @ r)


def phase_solve(phase, prob, dp, line_search, max_iter, kernels):
    """One path: ``solve`` on a prepared instance.  The launch counts are set
    to 0 just before and read just after; each kernel of ``kernels`` must
    have been launched at least once per iteration and bucket."""
    torch.cuda.reset_peak_memory_stats()
    bt.reset_launch_counts()
    res = bt.solve(dp, method="pgd", line_search=line_search, tol=0.0,
                   max_iter=max_iter, chunk=100)
    counts = bt.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    multi = dp.b.ndim == 2
    S, n_buckets = (dp.b.shape[0] if multi else 1), len(dp.buckets)
    lead = (S,) if multi else ()
    check(res.x.shape == lead + (prob.partition.n_flat,), f"{phase}: x has shape {res.x.shape}")
    check(res.trace_f.shape == lead + (max_iter,), f"{phase}: trace has shape {res.trace_f.shape}")
    check(bool(np.isfinite(res.trace_f).all() and np.isfinite(res.x).all()),
          f"{phase}: non-finite objective or x")
    x, trace = np.atleast_2d(res.x), np.atleast_2d(res.trace_f)
    ends = trace[:, 99::100].astype(np.float64)
    check(bool(np.all(ends[:, 1:] <= ends[:, :-1] * (1 + 1e-4))),
          f"{phase}: objective rose between chunk ends")
    check(bool(np.all(ends[:, -1] < ends[:, 0])), f"{phase}: no descent")
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
        check(counts[kernel] >= max_iter * n_buckets,
              f"{phase}: {kernel} launched {counts[kernel]} times, expected >= "
              f"{max_iter * n_buckets}")
    emit(phase, line_search=line_search, iterations=res.iterations, scenarios=S,
         aggregate_iters_per_sec=S * res.steady_iters_per_sec(),
         chunk_secs=[round(float(t), 4) for t in res.chunk_times],
         objective_s0=f32, objective_s0_f64=f64,
         objective_max=float(np.max(res.objective)),
         launches=counts, buckets=n_buckets, peak_bytes=peak)
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
    one launch per chunk, and the trace of the eager path of the same solve."""
    prob = ctx["tiny_prob"]
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=max_iter, chunk=chunk,
              lipschitz=bt.solvers.power_lipschitz(ctx["tiny"]), device=DEV)
    saved = {k: os.environ.get(k) for k in ("BSLS_MEGA", "BSLS_NO_MEGA")}
    try:
        os.environ.pop("BSLS_NO_MEGA", None)
        os.environ["BSLS_MEGA"] = "1"
        mega.use_mega.cache_clear()
        bt.solve(prob, **{**kw, "max_iter": chunk})  # first launch, outside the timing
        bt.reset_launch_counts()
        fused = bt.solve(prob, **kw)
        counts = bt.launch_counts()
        os.environ["BSLS_MEGA"] = "0"
        mega.use_mega.cache_clear()
        eager = bt.solve(prob, **kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        mega.use_mega.cache_clear()
    check(counts["pgd_chunk"] == max_iter // chunk,
          f"solve_mega: pgd_chunk launched {counts['pgd_chunk']} times for "
          f"{max_iter // chunk} chunks")
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
    emit("solve_mega", iterations=fused.iterations, chunks=max_iter // chunk, launches=counts,
         max_rel_trace_diff=float(rel.max()), max_abs_x_diff=float(np.abs(fused.x - eager.x).max()),
         objective=float(fused.objective), objective_f64=f64,
         fused_ms_per_step=per_step(fused), eager_ms_per_step=per_step(eager),
         fused_iters_per_sec=fused.steady_iters_per_sec(),
         eager_iters_per_sec=eager.steady_iters_per_sec())
    return counts, per_step(eager)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ptxas", action="store_true", help="print nvcc's per-kernel resource report")
    ap.add_argument("--stop-after", choices=["kernels"], default=None,
                    help="stop (exit code 3, no result line) after this phase: a short first "
                         "run for a new kernel")
    args = ap.parse_args()
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

    ctx = {"medium": dp, "banded": {}, "banded_prob": {}, "banded_info": {}}
    banded_base = bt.synthetic.medium_banded(seed=0)
    for S in (1, 4):
        ctx["banded_prob"][S], ctx["banded"][S], ctx["banded_info"][S] = prepare_banded(
            banded_base, S)
    ctx["tiny_prob"] = bt.synthetic.tiny_dense(seed=0)
    ctx["tiny"] = bt.prepare(ctx["tiny_prob"], device=DEV)

    report = phase_kernels(ctx)
    if args.stop_after == "kernels":
        sys.exit(3)
    launches = phase_solve("solve_exact", prob, dp, "exact", 300, ("proj_simplex_rows",))
    report["proj_simplex_rows"]["launches"] = launches["proj_simplex_rows"]
    launches = phase_solve("solve_pava", prob, dp, "pava", 200, ("pava_rows",))
    report["pava_rows"]["launches"] = launches["pava_rows"]
    phase_cross_check(base)
    launches = phase_solve_banded(ctx)
    report["band_zmv"]["launches"] = launches["band_zmv"]
    report["band_grmv"]["launches"] = launches["band_grmv"]
    launches, eager_ms = phase_solve_mega(ctx)
    report["pgd_chunk"]["launches"] = launches["pgd_chunk"]
    report["pgd_chunk"]["eager_solve_ms_per_step"] = eager_ms

    for name, row in report.items():
        check(row["launches"] > 0, f"{name} was not launched on its path")
    emit("total", secs=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
