#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA device, nvcc and g++
    python3 chip_smoke.py --ptxas    # also print registers/spills per kernel

Drives ``bsls_tpu_torch`` only (nothing of JAX): builds the native host
library and the CUDA kernels from the sources in this checkout, holds every
kernel against its plain PyTorch version on the card, runs the batched PGD
solve on ``synthetic.medium_sparse`` x 128 scenarios with the exact and the
pava line search through ``prepare``/``solve``, and cross-checks the card
against the CPU.  Every phase prints one JSON line; a failed phase raises and
the script exits non-zero without the result line.  The last line is
``{"ok": true, "device": {...}}``, the line before it lists every kernel with
its launches on the main path, its error, its time, the plain version's time
and its bound.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script runs on a GPU only")

import bsls_tpu_torch as bt  # noqa: E402
from bsls_tpu_torch import native  # noqa: E402
from bsls_tpu_torch.ops import rowkernels  # noqa: E402
from bsls_tpu_torch.ops.isotonic import pava_padded  # noqa: E402
from bsls_tpu_torch.ops.projection import proj_simplex_padded  # noqa: E402

DEV = torch.device("cuda", 0)
SCENARIOS = 128
# published peaks of one H100 SXM: device memory rate and fp32 rate outside
# the tensor cores; the bound of a kernel is stated against these
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# a kernel agrees with its plain version within this, times the largest radius
ERR_LIMIT = 3e-5


class PhaseFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    lib = rowkernels.build_library(verbose=ptxas)
    t_cuda = time.perf_counter() - t0
    emit("build", host_layout_engine="native" if host_native else "numpy fallback",
         native_secs=round(t_native, 2), cuda_library=lib.split("bsls_tpu_torch/")[-1],
         cuda_secs=round(t_cuda, 2))


# ------------------------------------------------------------------ phase 3

KERNELS = {
    "proj_simplex_rows": dict(
        fn=rowkernels.proj_simplex_rows,
        source="bsls_tpu_torch/csrc/proj_simplex_rows.cu",
        replaces="bsls_tpu/ops/pallas/projection_kernel.py:109",
        # per row: w^2/2 compare-exchanges of 2 operations, ~8 more per slot
        ops_per_row=lambda w: w * w + 8 * w,
    ),
    "pava_rows": dict(
        fn=rowkernels.pava_rows,
        source="bsls_tpu_torch/csrc/pava_rows.cu",
        replaces="bsls_tpu/ops/pallas/pava_kernel.py:112",
        # per row: at most 2w pushes/pops of ~5 operations, ~4 more per slot
        ops_per_row=lambda w: 14 * w,
    ),
}


def plain(name, v, widths, radius):
    mask = (torch.arange(v.shape[-1], device=v.device) < widths[:, None]).to(v.dtype)
    if name == "proj_simplex_rows":
        return proj_simplex_padded(v, mask, radius)
    return pava_padded(v, mask, 0.0, radius, chunk=1 << 17)


def random_case(lead, Bk, w, seed):
    """Ragged widths (0 = dummy row, radius 1), per-row radius, values of the
    size the solver produces (a few radii)."""
    rng = np.random.default_rng(seed)
    widths = rng.integers(0, w + 1, size=Bk).astype(np.int32)
    radius = rng.uniform(0.5, 5.0, size=Bk).astype(np.float32)
    radius[widths == 0] = 1.0
    v = (rng.standard_normal(lead + (Bk, w)) * 2).astype(np.float32) * radius[:, None]
    to = lambda a: torch.from_numpy(a).to(DEV)
    return to(v), to(widths), to(radius)


def compare(name, v, widths, radius):
    """Max abs difference kernel vs plain, in units of the largest radius,
    plus the structural checks."""
    got = KERNELS[name]["fn"](v, widths, radius)
    torch.cuda.synchronize()
    want = plain(name, v, widths, radius)
    check(got.shape == v.shape and got.dtype == v.dtype, f"{name}: wrong output shape/dtype")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    pad = torch.arange(v.shape[-1], device=DEV) >= widths[:, None]
    check(float(got.masked_select(pad.expand_as(got)).abs().sum()) == 0.0,
          f"{name}: padding slots or dummy rows are not zero")
    real = widths > 0
    if name == "proj_simplex_rows":
        sums = got.sum(-1)[..., real]
        rel = ((sums - radius[real]).abs() / radius[real]).max() if real.any() else 0.0
        check(float(rel) <= 1e-5, f"{name}: row sums off by {float(rel):.2e} relative")
        check(float(got.min()) >= 0.0, f"{name}: negative entry")
    else:
        inner = ~pad[:, 1:]
        steps = (got[..., 1:] - got[..., :-1]).masked_select(inner.expand_as(got[..., 1:]))
        check(steps.numel() == 0 or float(steps.min()) >= 0.0, f"{name}: fit is not nondecreasing")
        check(float(got.min()) >= 0.0 and bool((got <= radius[:, None]).all()),
              f"{name}: fit leaves [0, radius]")
    err = float((got - want).abs().max() / radius.max())
    check(err <= ERR_LIMIT, f"{name}: differs from the plain version by {err:.2e} x max radius "
          f"at shape {tuple(v.shape)}")
    return err


def _elapsed_ms(run):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def call_ms(fn, reps=20):
    """Time of one call as the solver makes it (eager, wrapper included):
    the larger of the host's time to enqueue and the device's time to run."""
    for _ in range(3):
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


def phase_kernels(dp):
    """Each kernel against its plain version, then timed at the bucket shapes
    of medium x 128.  Returns the per-kernel numbers of the last JSON line."""
    report = {}
    for name, spec in KERNELS.items():
        errs, shapes = [], []
        for w in (1, 2, 3, 4, 8, 16, 32, 64):
            for lead in ((), (3,)):  # (Bk, w) rows and a folded scenario axis
                v, widths, radius = random_case(lead, 1003, w, seed=100 * w + len(lead))
                errs.append(compare(name, v, widths, radius))
                shapes.append(list(v.shape))
        ms = plain_ms = bytes_ = ops = 0.0
        per_bucket = []
        for i, bk in enumerate(dp.buckets):
            # the tensors the main path hands the kernel: (S, Bk, w), the
            # bucket's own sizes (sizes - 1 for the z-space fit) and radii
            widths = bk.sizes if name == "proj_simplex_rows" else torch.clamp(bk.sizes - 1, min=0)
            gen = torch.Generator(device=DEV).manual_seed(7 + i)
            # four inputs in turn: together they exceed the 50 MB L2 cache,
            # so every launch finds its rows in device memory
            vs = [torch.randn((SCENARIOS,) + tuple(bk.mask.shape), generator=gen, device=DEV)
                  * 2 * bk.radius[:, None] for _ in range(4)]
            errs.append(compare(name, vs[0], widths, bk.radius))
            shapes.append(list(vs[0].shape))
            launch = lambda j: spec["fn"](vs[j % 4], widths, bk.radius)
            k_ms, c_ms = device_ms(launch), call_ms(launch)
            p_ms = call_ms(lambda j: plain(name, vs[j % 4], widths, bk.radius), reps=4)
            rows, w = vs[0].numel() // bk.width, bk.width
            b_bytes = 2 * 4 * rows * w + 8 * bk.mask.shape[0]
            b_ops = rows * spec["ops_per_row"](w)
            per_bucket.append({"shape": list(vs[0].shape), "ms": k_ms, "call_ms": c_ms,
                               "plain_ms": p_ms,
                               "bound_ms": 1e3 * max(b_bytes / PEAK_BYTES_PER_S,
                                                     b_ops / PEAK_FP32_PER_S)})
            ms, plain_ms, bytes_, ops = ms + k_ms, plain_ms + p_ms, bytes_ + b_bytes, ops + b_ops
        t_bytes, t_ops = bytes_ / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S
        report[name] = {
            "name": name, "route": "cuda", "source": spec["source"],
            "replaces": spec["replaces"], "max_abs_err": max(errs),
            # one application to all buckets of medium x 128 (one launch each);
            # ms is device time, per_bucket has the eager call's time beside it
            "ms": ms, "plain_ms": plain_ms, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "per_bucket": per_bucket,
        }
        emit("kernels", kernel=name, max_abs_err_over_max_radius=max(errs), limit=ERR_LIMIT,
             shapes_checked=shapes, per_bucket=per_bucket)
    return report


# --------------------------------------------------------------- phases 4-6


def f64_objective(prob, x, scenario):
    A = prob.A.to_scipy().astype(np.float64)
    r = A @ x[scenario].astype(np.float64) - np.asarray(prob.b, np.float64)[scenario]
    return 0.5 * float(r @ r)


def phase_solve(phase, prob, dp, line_search, max_iter, kernel):
    """The main path: ``solve`` on the prepared medium x 128 instance.  The
    launch counts are set to 0 just before and read just after."""
    torch.cuda.reset_peak_memory_stats()
    bt.reset_launch_counts()
    res = bt.solve(dp, method="pgd", line_search=line_search, tol=0.0,
                   max_iter=max_iter, chunk=100)
    counts = bt.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    S, n_buckets = SCENARIOS, len(dp.buckets)
    check(res.x.shape == (S, prob.partition.n_flat), f"{phase}: x has shape {res.x.shape}")
    check(res.trace_f.shape == (S, max_iter), f"{phase}: trace has shape {res.trace_f.shape}")
    check(bool(np.isfinite(res.trace_f).all() and np.isfinite(res.x).all()),
          f"{phase}: non-finite objective or x")
    ends = res.trace_f[:, 99::100].astype(np.float64)
    check(bool(np.all(ends[:, 1:] <= ends[:, :-1] * (1 + 1e-4))),
          f"{phase}: objective rose between chunk ends")
    check(bool(np.all(ends[:, -1] < ends[:, 0])), f"{phase}: no descent")
    sizes = prob.partition.sizes
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    sums = np.add.reduceat(res.x.astype(np.float64), offs, axis=1)
    check(float(res.x.min()) >= 0.0 and float(np.abs(sums - 1.0).max()) <= 1e-5,
          f"{phase}: x is not feasible (block sums off by {np.abs(sums - 1).max():.2e})")
    f64 = f64_objective(prob, res.x, 0)
    f32 = float(res.objective[0])
    check(abs(f64 - f32) <= 1e-4 * max(1.0, abs(f64)),
          f"{phase}: device objective {f32} vs float64 host objective {f64}")
    check(counts[kernel] >= max_iter * n_buckets,
          f"{phase}: {kernel} launched {counts[kernel]} times, expected >= "
          f"{max_iter * n_buckets}")
    emit(phase, line_search=line_search, iterations=res.iterations, scenarios=S,
         aggregate_iters_per_sec=S * res.steady_iters_per_sec(),
         chunk_secs=[round(float(t), 4) for t in res.chunk_times],
         objective_s0=f32, objective_s0_f64=f64, objective_max=float(res.objective.max()),
         launches=counts, buckets=n_buckets, peak_bytes=peak)
    return counts


def phase_cross_check(base):
    """The port on the card against the port on the CPU (plain versions)."""
    prob = bt.synthetic.with_scenarios(base, 4, seed=1)
    dp_gpu = bt.prepare(prob, device=DEV)
    L_est = bt.solvers.power_lipschitz(dp_gpu)
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=200, chunk=100,
              lipschitz=L_est)
    on_card = bt.solve(dp_gpu, **kw)
    on_cpu = bt.solve(prob, device="cpu", **kw)
    # fp32 on both, sums in another order, 200 steps deep
    rel = np.abs(on_card.trace_f - on_cpu.trace_f) / np.abs(on_cpu.trace_f)
    check(float(rel.max()) <= 1e-3, f"cross_check: traces differ by {rel.max():.2e} relative")
    check(float(np.abs(on_card.x - on_cpu.x).max()) <= 1e-3, "cross_check: x differs")
    emit("cross_check", scenarios=4, iterations=200, max_rel_trace_diff=float(rel.max()),
         max_abs_x_diff=float(np.abs(on_card.x - on_cpu.x).max()))


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

    report = phase_kernels(dp)
    if args.stop_after == "kernels":
        sys.exit(3)
    launches = phase_solve("solve_exact", prob, dp, "exact", 600, "proj_simplex_rows")
    report["proj_simplex_rows"]["launches"] = launches["proj_simplex_rows"]
    launches = phase_solve("solve_pava", prob, dp, "pava", 300, "pava_rows")
    report["pava_rows"]["launches"] = launches["pava_rows"]
    phase_cross_check(base)

    emit("total", secs=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
