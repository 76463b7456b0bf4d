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
* in a fresh process, the first chunk of the exact path against the second:
  the kernel library's load and the first launches come before the clock.

Every phase prints one JSON line; a failed phase raises and the script exits
non-zero without the result line.  The last line is ``{"ok": true, "device":
{...}}``, the line before it lists every kernel with its launches on its path,
its error, its time, the plain version's time, its bound and, where one
PyTorch call computes the same function, that call's time.  ``pava_rows`` is
also held and timed on the inputs that a short pava solve of medium x 128
hands it (captured before the kernels phase), with the share of rows that
pool, and on rows with a NaN.  With ``--ptxas`` the build phase fails unless
the PAVA kernels of widths 4 and 8 keep everything in registers (no stack
frame, no spills).
"""
import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this script runs on a GPU only")

import bsls_tpu_torch as bt  # noqa: E402
from bsls_tpu_torch import native  # noqa: E402
from bsls_tpu_torch.ops import chunkkernel, cudalib, isotonic, pagekernels, rowkernels  # noqa: E402
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


def pava_resources(log):
    """ptxas's report on the fixed-width PAVA kernels: {"<w>": {stack frame,
    spill stores, spill loads, registers}}."""
    out = {}
    pat = (r"Function properties for \S*pava_rows_fixedILi(\d+)E\S*\s+(\d+) bytes "
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
        # the widths of the solve path keep their row and its fit in
        # registers: no stack frame, no spills
        res = pava_resources(log.getvalue())
        for w in ("4", "8"):
            r = res.get(w)
            check(r is not None, f"ptxas: no report on pava_rows_fixed<{w}>")
            check(r["stack_frame"] == r["spill_stores"] == r["spill_loads"] == 0,
                  f"ptxas: pava_rows_fixed<{w}> uses local memory: {r}")
        emit("ptxas", pava_rows_fixed=res)


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
    if spec.get("nan_widths"):
        errs.append(check_nan_rows(name, spec))
    return max(errs), shapes, ROW_ERR_LIMIT


def check_nan_rows(name, spec):
    """Rows with a NaN among their first widths[b] slots, and rows with one in
    a padding slot, against the plain version: the same slots NaN, the rest
    within the row limit."""
    errs = []
    for w in spec["nan_widths"]:
        v, widths, radius = random_rows((3,), 1003, w, seed=900 + w)
        rng = np.random.default_rng(w)
        y, n = v.cpu().numpy(), widths.cpu().numpy()
        for b in range(0, 1003, 5):
            if n[b] > 0:  # a NaN among the fitted slots of scenario b % 3
                y[b % 3, b, rng.integers(0, n[b])] = np.nan
            if n[b] < w:  # a NaN in a padding slot of every scenario
                y[:, b, rng.integers(n[b], w)] = np.nan
        v = torch.from_numpy(y).to(DEV)
        got = spec["fn"](v, widths, radius)
        torch.cuda.synchronize()
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
    ``isotonic.pava_bounded``, by bucket shape, in the order of the iterations.
    The function is wrapped here for the capture only."""
    seen = {}
    plain_fn = isotonic.pava_bounded

    def spy(y, widths, radius):
        seen.setdefault(tuple(y.shape), []).append(y.clone())
        return plain_fn(y, widths, radius)

    isotonic.pava_bounded = spy
    try:
        bt.solve(dp, method="pgd", line_search="pava", tol=0.0, max_iter=iters, chunk=iters)
    finally:
        isotonic.pava_bounded = plain_fn
    # one more per bucket: solve's throwaway warm-up step before its clock,
    # from the same state as the first iteration
    check(len(seen) == len(dp.buckets) and all(len(v) == iters + 1 for v in seen.values()),
          f"capture: {[len(v) for v in seen.values()]} pava inputs for {len(dp.buckets)} buckets "
          f"and {iters} iterations plus the warm-up step")
    return {shape: v[1:] for shape, v in seen.items()}


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
    errs, per_bucket = [], []
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
        launch = lambda j: spec["fn"](vs[j % n_in], widths, bk.radius)
        k_ms, c_ms = device_ms(launch), call_ms(launch)
        p_ms = call_ms(lambda j: spec["plain"](vs[j % n_in], widths, bk.radius), reps=4)
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
    out = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
               library_ms=None, per_bucket=per_bucket)
    if solve_inputs is not None:
        out.update(solve_inputs_ms=sum(e["solve_inputs_ms"] for e in per_bucket),
                   form_by_width={str(w): f for w, f in rowkernels.PAVA_FORMS.items()})
    return out


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
        # the fixed-width kernels carry a NaN over a row's fitted slots
        nan_widths=(4, 8, 32),
        # per row, minimax form: w(w+1)/2 segments of an add, a multiply, a max
        # and a min (less the w adds and w maxes of the first segments), 4 more
        # per slot; stack form: at most 2w pushes/pops of ~5, ~4 more per slot
        ops_per_row=lambda w: (2 * w * w + 4 * w if rowkernels.PAVA_FORMS.get(w) == "minimax"
                               else 14 * w),
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
    have been launched at least once per iteration and bucket.  Every
    family checked here descends by construction (apgd by its safeguard, the
    others by an exact step clipped to [0, 1]), so the objective must not
    rise between chunk ends."""
    torch.cuda.reset_peak_memory_stats()
    bt.reset_launch_counts()
    res = bt.solve(dp, method=method, line_search=line_search, space=space, tol=0.0,
                   max_iter=max_iter, chunk=chunk, lipschitz=lipschitz)
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
        check(counts[kernel] >= max_iter * n_buckets,
              f"{phase}: {kernel} launched {counts[kernel]} times, expected >= "
              f"{max_iter * n_buckets}")
    emit(phase, method=method, space=space, line_search=line_search, chunk=chunk,
         iterations=res.iterations, scenarios=S,
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
    one launch per chunk (and the warm-up's), and the trace of the eager path
    of the same solve."""
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
    emit("solve_mega", iterations=fused.iterations, chunks=max_iter // chunk, launches=counts,
         max_rel_trace_diff=float(rel.max()), max_abs_x_diff=float(np.abs(fused.x - eager.x).max()),
         objective=float(fused.objective), objective_f64=f64,
         fused_ms_per_step=per_step(fused), eager_ms_per_step=per_step(eager),
         fused_iters_per_sec=fused.steady_iters_per_sec(),
         eager_iters_per_sec=eager.steady_iters_per_sec())
    return counts, per_step(eager)

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

    return type(st)(**{f.name: move(getattr(st, f.name)) for f in dataclasses.fields(st)})


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
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    r1 = bt.solve(dp, certify=certify, **kw)
    secs = time.perf_counter() - t0
    counts = bt.launch_counts()
    f0, f1 = np.asarray(r0.objective, np.float64), np.asarray(r1.objective, np.float64)
    g0, g1 = np.asarray(r0.gap, np.float64), np.asarray(r1.gap, np.float64)
    check(bool(np.isfinite(r1.x).all() and np.isfinite(g1).all()), "certify: non-finite result")
    check(bool(np.all(f1 <= f0 * (1 + 1e-6))), "certify: an objective got worse by more than "
          f"1e-6 relative ({np.max(f1 / f0 - 1):.2e})")
    check(bool(np.all(g1 < g0)), "certify: the gap did not shrink in every scenario "
          f"({int(np.sum(g1 >= g0))} of {len(g0)} did not; the polish is all or nothing)")
    ratio = g1 / g0
    emit("certify", scenarios=len(g0), iterations=max_iter, certify=certify,
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
    bt.reset_launch_counts()
    TB._polish_cg = timed_cg
    try:
        pol = TB.refine_polish(prob, dp, res, rounds=rounds)
    finally:
        TB._polish_cg = real_cg
    counts = bt.launch_counts()
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
    bt.reset_launch_counts()
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
    counts = bt.launch_counts()
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
        bt.reset_launch_counts()
        rb, states = _states_at_chunk_ends(dp, method, kw)
        counts = bt.launch_counts()
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
        past = np.nonzero(rel.max(0) > 5e-4)[0]
        out[method] = dict(one_step_rel_diff_by_chunk_end=steps,
                           max_rel_end_diff=float(rel[:, -1].max()),
                           first_iteration_past_5e_4=int(past[0]) if past.size else None,
                           objective_banded=np.asarray(rb.objective).tolist(),
                           objective_gather=np.asarray(rg.objective).tolist(),
                           aggregate_iters_per_sec_banded=4 * rb.steady_iters_per_sec(),
                           aggregate_iters_per_sec_gather=4 * rg.steady_iters_per_sec(),
                           launches=counts)
    emit("solve_banded_families", scenarios=4, iterations=max_iter, **out)
    return total

# ------------------------------------------------ the equality-constrained path

# traffic_like at the width of the reference's traffic_random preset: 10,000
# blocks of width 2-12, A 100,000 x 69,989 with 454,722 nonzeros, a dense C of
# 50 x 69,989, times 128 scenarios with their own targets d
EQ_SCENARIOS = 128
EQ_BUDGET = 2000  # total inner iterations of solve_eq
EQ_INNER = 400  # at most this many per outer
EQ_CROSS_ITERS = 100  # the first outer of the card-against-CPU check, S = 4


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
    L2) beside its bytes bound; both kernels template the same widths, and
    every other width takes their generic form."""
    spec, errs, per_bucket = KERNELS[name], [], []
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
        per_bucket.append({"shape": [scenarios, Bk, w],
                           "form": "templated" if w in rowkernels.PAVA_FORMS else "generic",
                           "ms": k_ms, "bound_ms": b_ms, "bound_by": by,
                           "share_of_bound": b_ms / k_ms})
        del vs
    return max(errs), per_bucket


def top_gather_ms(dp, scenarios=(1, 4, 128)):
    """Device time of the stacked top's two ``index_select`` gathers (Aᵀr
    over the (m, S) residual, A·x over the (n_pf, S) iterate) with this
    path's indices at several S: whether their time follows the bytes they
    move or the count of indices."""
    top = dp.A.top
    mv = top.mv_cols if isinstance(top.mv_cols, tuple) else tuple(top.mv_cols)
    cases = [(top.rows.reshape(-1), top.num_rows)] + [(c.reshape(-1), dp.n_pf) for c in mv]
    out = {"indices": [int(idx.numel()) for idx, _ in cases]}
    for S in scenarios:
        ms = 0.0
        for idx, n_src in cases:
            src = torch.randn((n_src, S), device=DEV)
            ms += device_ms(lambda j: src.index_select(0, idx))
        out[f"S={S}"] = {"ms": ms, "out_bytes": 4 * S * sum(out["indices"])}
    return out


def phase_solve_eq(ctx):
    """``solve_equality_constrained`` (pgd/exact inners) on traffic_like x 128
    at full width; then the first outer on the card against the CPU at S = 4
    with one set of Lipschitz constants."""
    from bsls_tpu_torch.solvers.eq_constrained import op_cache_key
    from bsls_tpu_torch.utils.profiling import profile_steps

    base, prob = ctx["eq_base"], ctx["eq_prob"]
    cache, rec = {}, OuterRecords()
    torch.cuda.reset_peak_memory_stats()
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    res = bt.solve_equality_constrained(
        prob, method="pgd", line_search="exact", eq_tol=1e-6, max_iter=EQ_BUDGET,
        inner_iters=EQ_INNER, chunk=100, op_cache=cache, metrics=rec, device=DEV)
    secs = time.perf_counter() - t0
    counts = bt.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    (dp, rho_base, L_base, LC, *_), = cache.values()
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
    n_buckets = len(dp.buckets)
    check(counts["proj_simplex_rows"] >= res.iterations * n_buckets,
          f"solve_eq: proj_simplex_rows launched {counts['proj_simplex_rows']} times in "
          f"{res.iterations} inner iterations over {n_buckets} buckets")
    # kernel 1 against its plain version at this path's buckets, S = 128
    err, rows = check_rows_at("proj_simplex_rows", dp, S, seed=610)
    ctx["eq_row_errs"]["proj_simplex_rows"] = err
    # the step of the stacked operator under the profiler: idle share and
    # launches per inner step
    prof = profile_steps(dp, "exact", iters=20)
    outer = rec.outer
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
         rows_by_bucket=rows, rows_max_err=err)

    # the card against the CPU, S = 4, one set of Lipschitz constants
    prob4 = ctx["eq_prob4"]
    kw = dict(method="pgd", line_search="exact", tol=0.0, max_iter=EQ_CROSS_ITERS,
              inner_iters=EQ_CROSS_ITERS, chunk=50)
    cache4 = {}
    on_card = bt.solve_equality_constrained(prob4, op_cache=cache4, device=DEV, **kw)
    (dp4, rb, Lb, LCb, A4, C4), = cache4.values()
    key = op_cache_key(prob4, torch.float32, "pgd", "exact", "cpu")
    on_cpu = bt.solve_equality_constrained(
        prob4, op_cache={key: (_state_to(dp4, "cpu"), rb, Lb, LCb, A4, C4)}, device="cpu", **kw)
    rel = np.abs(on_card.trace_f - on_cpu.trace_f) / np.abs(on_cpu.trace_f)
    check(on_card.trace_f.shape == (4, EQ_CROSS_ITERS), "solve_eq: cross-check trace shape")
    check(float(rel.max()) <= 1e-3, f"solve_eq: the first outer's trace differs on the card and "
          f"the CPU by {rel.max():.2e} relative")
    emit("solve_eq_cross_check", scenarios=4, iterations=EQ_CROSS_ITERS,
         max_rel_trace_diff=float(rel.max()),
         max_abs_x_diff=float(np.abs(on_card.x - on_cpu.x).max()),
         eq_violation_card=on_card.eq_violation, eq_violation_cpu=on_cpu.eq_violation)
    return counts


def phase_solve_eq_pava(ctx, max_iter=400, inner=200):
    """The same instance at S = 4 with the pava line search: z-space inners,
    kernel 2 on the equality-constrained path; its step profiled."""
    from bsls_tpu_torch.utils.profiling import profile_steps

    prob4 = ctx["eq_prob4"]
    cache, rec = {}, OuterRecords()
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    res = bt.solve_equality_constrained(prob4, method="pgd", line_search="pava",
                                        max_iter=max_iter, inner_iters=inner, chunk=100,
                                        op_cache=cache, metrics=rec, device=DEV)
    secs = time.perf_counter() - t0
    counts = bt.launch_counts()
    (dp, _, L_base, LC, *_), = cache.values()
    _check_simplices("solve_eq_pava", prob4, res.x)
    check(np.isfinite(res.eq_violation) and bool(np.isfinite(res.objective).all()),
          "solve_eq_pava: non-finite result")
    n_buckets = len(dp.buckets)
    check(counts["pava_rows"] >= res.iterations * n_buckets,
          f"solve_eq_pava: pava_rows launched {counts['pava_rows']} times in "
          f"{res.iterations} inner iterations over {n_buckets} buckets")
    err, rows = check_rows_at("pava_rows", dp, 4, seed=620)
    # the same buckets at S = 128, where a launch is no longer only its latency
    err128, rows128 = check_rows_at("pava_rows", dp, EQ_SCENARIOS, seed=630)
    ctx["eq_row_errs"]["pava_rows"] = max(err, err128)
    # the z-space step of the stacked operator under the profiler
    prof = profile_steps(dp, "pava", iters=20)
    gathers = top_gather_ms(dp)
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
         top_gathers=gathers,
         rows_by_bucket=rows, rows_by_bucket_s128=rows128, rows_max_err=max(err, err128))
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

    bt.reset_launch_counts()
    TB._polish_cg = timed_cg
    t0 = time.perf_counter()
    try:
        res = bt.solve(prob, method=cfg.method, line_search=cfg.line_search, tol=cfg.tol,
                       max_iter=cfg.max_iter, chunk=cfg.chunk, refine_tol=target, device=DEV)
    finally:
        TB._polish_cg = real_cg
    secs = time.perf_counter() - t0
    counts = bt.launch_counts()
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
    t0 = time.perf_counter()
    ep.warmup(SCENARIOS)
    warmup_secs = time.perf_counter() - t0
    reqs = [np.asarray(bt.synthetic.with_scenarios(base, SCENARIOS, seed=s).b) for s in (2, 3, 4)]
    bt.reset_launch_counts()
    results, walls = [], []
    for B in reqs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(ep.solve(B, tol=0.0, max_iter=SERVE_ITERS))
        walls.append(time.perf_counter() - t0)
    counts = bt.launch_counts()
    n_buckets = len(ep._dp.buckets)
    check(counts["proj_simplex_rows"] >= len(reqs) * SERVE_ITERS * n_buckets,
          f"serve: proj_simplex_rows launched {counts['proj_simplex_rows']} times")
    # what a request pays outside its chunk loop, piece by piece: the upload
    # of b, the power iteration, the throwaway warm-up step
    dp_b = ep._with_b(reqs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dp_b = ep._with_b(reqs[0])
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
    # the cold call: prepare included
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
    loop = [float(np.sum(r.chunk_times)) for r in results]
    outside = [w - lp for w, lp in zip(walls, loop)]
    emit("serve", instance=f"medium_sparse(seed=0) x {SCENARIOS}", layout=layout,
         endpoint_build_secs=build_secs, warmup_secs=warmup_secs, requests=len(reqs),
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


def phase_serve_queue(prob, base, threads=8, per_thread=8, width=32):
    """``BatchQueue`` over an endpoint of the same instance (built with the
    first 32 rows of ``prob``'s b): 8 client threads, each sending its
    requests one after the other, 64 single-RHS requests in all; each answer
    against that scenario's objective in one batched solve of all 64."""
    import threading

    t_phase = time.perf_counter()
    prob = dataclasses.replace(prob, b=np.asarray(prob.b)[:width], x_true=None)
    batch = bt.synthetic.with_scenarios(base, threads * per_thread, seed=5)
    B = np.asarray(batch.b)
    ep = bt.Endpoint(prob, method="pgd", line_search="exact", chunk=100, device=DEV)
    for w in (8, width):  # the widths the queue will send, first launches before traffic
        ep.warmup(w)
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

    bt.reset_launch_counts()
    workers = [threading.Thread(target=client, args=(k,)) for k in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    wall = time.perf_counter() - t0
    counts = bt.launch_counts()
    q.close(timeout=30)
    check(not q._worker.is_alive() and not any(w.is_alive() for w in workers),
          "serve_queue: a thread did not stop")
    if errors:
        raise errors[0]
    check(q.requests_served == len(B), f"serve_queue: served {q.requests_served} of {len(B)}")
    check(counts["proj_simplex_rows"] > 0, "serve_queue: proj_simplex_rows was not launched")
    ref = bt.solve(batch, method="pgd", line_search="exact", tol=0.0, max_iter=SERVE_ITERS,
                   chunk=100, device=DEV)
    got = np.array([r.objective for r in out])
    diff = _rel_diff(got, ref.objective)
    check(diff <= 1e-4, f"serve_queue: answers differ from one batched solve by {diff:.2e}")
    check(all(r.x.shape == (prob.partition.n_flat,) for r in out), "serve_queue: x shape")
    lat_s = np.sort(np.asarray(lat))
    emit("serve_queue", clients=threads, requests=len(B), max_batch=width, max_wait_ms=20,
         iterations=SERVE_ITERS, batches_run=q.batches_run,
         mean_width=q.requests_served / q.batches_run,
         latency_p50_secs=float(np.percentile(lat_s, 50)),
         latency_p99_secs=float(np.percentile(lat_s, 99)), wall_secs=wall,
         requests_per_sec=len(B) / wall, max_rel_diff_to_batched=diff, launches=counts,
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
    bt.reset_launch_counts()
    t0 = time.perf_counter()
    r1 = ep.solve(np.asarray(prob.b), tol=cfg.tol, max_iter=cfg.max_iter, refine_tol=target)
    secs1 = time.perf_counter() - t0
    counts = bt.launch_counts()
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
            bt.reset_launch_counts()
            t0 = time.perf_counter()
            res = ep_big.solve(B, max_iter=EQ_BUDGET, inner_iters=EQ_INNER, eq_tol=1e-6,
                               sensitivity=False)
            secs = time.perf_counter() - t0
            c = bt.launch_counts()
            for name in counts:
                counts[name] += c[name]
            check(res.x.shape == (EQ_SCENARIOS, big.partition.n_flat), "serve_eq: x shape")
            check(bool(np.isfinite(res.objective).all()) and np.isfinite(res.eq_violation),
                  "serve_eq: non-finite result")
            check(len(ep_big._eq_ops) == 1, f"serve_eq: {len(ep_big._eq_ops)} op_cache entries")
            (now,) = ep_big._eq_ops.values()
            check(entry is None or now[0] is entry, "serve_eq: request 2 re-prepared")
            entry = now[0]
            rows.append({"outers": len(inner), "iterations": res.iterations, "secs": secs,
                         "solve_secs": sum(inner),
                         "eq_violation": res.eq_violation, "stop_reason": res.stop_reason,
                         "proj_simplex_rows_launches": c["proj_simplex_rows"]})
    finally:
        TL.prepare, TB.solve = real_prepare, real_solve
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
                            "perturbation": 0.01, "host_objective_secs": objective_secs},
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
        bt.reset_launch_counts()
        resumed = bt.solve(dp, method="pgd", line_search="exact", tol=0.0, max_iter=total,
                           chunk=100, checkpoint_path=ck, checkpoint_every=1, checkpoint_keep=2,
                           resume=True)
        counts = bt.launch_counts()
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
    args = ap.parse_args()
    if args.chunk0_child:
        chunk0_child()
        return
    if args.checkpoint_child:
        checkpoint_child(args.checkpoint_child)
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

    ctx = {"medium": dp, "banded": {}, "banded_prob": {}, "banded_info": {}}
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
    launches = phase_solve("solve_exact", prob, dp, "exact", 200, ("proj_simplex_rows",))
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

    # the other families, certify and refine add their launches to the rows
    # of the kernels they run
    new_paths = [phase_solve_families(prob, dp)]
    phase_cross_check_families(base)
    new_paths.append(phase_certify(prob, dp))
    new_paths.append(phase_refine(prob, dp))
    new_paths.append(phase_refine_certified(base))
    new_paths.append(phase_solve_banded_families(ctx))
    # the equality-constrained path: kernel 1 in every inner solve, kernel 2
    # in the z-space ones
    new_paths.append(phase_solve_eq(ctx))
    new_paths.append(phase_solve_eq_pava(ctx))
    new_paths.append(phase_solve_eq_traffic())
    # serving and checkpoint/resume: kernel 1 in every request
    new_paths.append(phase_serve(prob, base))
    new_paths.append(phase_serve_queue(prob, base))
    new_paths.append(phase_serve_eq(ctx))
    new_paths.append(phase_checkpoint(prob, dp))
    for name, err in ctx["eq_row_errs"].items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"], err)
    phase_chunk0()
    for counts in new_paths:
        for name in report:
            report[name]["launches"] += counts.get(name, 0)

    for name, row in report.items():
        check(row["launches"] > 0, f"{name} was not launched on its path")
    emit("total", secs=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
