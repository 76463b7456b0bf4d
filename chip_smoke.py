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

    for name, row in report.items():
        check(row["launches"] > 0, f"{name} was not launched on its path")
    emit("total", secs=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": list(report.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
