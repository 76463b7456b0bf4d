"""Profiling: a trace of any block (``trace``), and where a solver
iteration spends the device's time (``profile_steps`` and the command below).

    with trace("prof/"):              # the CLI's --profile-dir
        bt.solve(prob)

    python -m bsls_tpu_torch.utils.profiling --config medium --scenarios 128 \
        --line-search exact,pava --iters 30 [--trace trace.json]
    python -m bsls_tpu_torch.utils.profiling --config medium_banded --scenarios 1 \
        --line-search bbm --layout auto
    python -m bsls_tpu_torch.utils.profiling --method lbfgs,eg,afw --iters 30

Runs ``iters`` steps of a solver (``--method``, default pgd; several
methods or line searches separated by commas, one line each) under
``torch.profiler`` after a warm-up and prints one JSON line per run: wall time per iteration (host clock around
a synchronised window), the device's busy time per iteration (union of the
kernel intervals), its idle share, and the kernels by name with their device
time and launches per iteration (the sixteen largest and every kernel of
``csrc/``).  Needs a CUDA device; a trace without any device event is an
error, not a result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed block with ``torch.profiler`` (CPU and CUDA
    activities) and write its Chrome trace to ``log_dir/trace_<pid>.json``
    (no-op if ``log_dir`` is None)."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def profile_steps(dp, line_search: str, iters: int, warmup: int = 5, trace_path=None,
                  method: str = "pgd") -> dict:
    from ..solvers.base import (
        SolveOptions, _get_solver, power_lipschitz, power_lipschitz_z, uses_zspace,
    )

    solver = _get_solver(method)
    opts = SolveOptions(method=method, line_search=line_search)
    power = power_lipschitz_z if uses_zspace(method, line_search) else power_lipschitz
    L_est = power(dp)
    st = solver.init(dp, L_est, opts)
    for _ in range(warmup):
        st = solver.step(dp, st, L_est, opts)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            st = solver.step(dp, st, L_est, opts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace_path:
        prof.export_chrome_trace(trace_path)

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    if not spans:
        raise RuntimeError("the profiler recorded no device event: time with CUDA events instead")
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0] if len(spans) > 1 else busy
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    # the sixteen largest, and the hand-written kernels of csrc/ wherever they rank
    kernels = kernels[:16] + [kv for kv in kernels[16:] if "bsls::" in kv[0]]
    return {
        "method": method,
        "line_search": line_search,
        "iters": iters,
        "wall_ms_per_iter": 1e3 * wall / iters,
        "device_busy_ms_per_iter": busy / 1e3 / iters,
        "device_idle_share": 1.0 - busy / window,
        "launches_per_iter": sum(c for c, _ in by_name.values()) / iters,
        "kernels": [
            {"name": name[:100], "launches_per_iter": c / iters, "ms_per_iter": us / 1e3 / iters}
            for name, (c, us) in kernels
        ],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bsls_tpu_torch.utils.profiling")
    ap.add_argument("--config", default="medium")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scenarios", type=int, default=128)
    ap.add_argument("--method", default="pgd",
                    help="one solver family, or several separated by commas")
    ap.add_argument("--line-search", dest="line_search", default="exact",
                    help="one line search, or several separated by commas")
    ap.add_argument("--layout", choices=["auto", "banded", "gather"], default="auto")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--trace", default=None, help="also write a chrome trace here")
    args = ap.parse_args(argv)

    from ..models import synthetic
    from ..ops.layout import DeviceBanded, prepare

    prob = synthetic.make_config(args.config, seed=args.seed)
    if args.scenarios > 1:
        prob = synthetic.with_scenarios(prob, args.scenarios, seed=args.seed + 1)
    dp = prepare(prob, layout=args.layout, device="cuda")
    layout = "banded" if isinstance(dp.A, DeviceBanded) else "gather"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    outs = []
    for method in args.method.split(","):
        for ls in args.line_search.split(","):
            out = profile_steps(dp, ls, args.iters, trace_path=args.trace, method=method)
            out.update(config=args.config, scenarios=args.scenarios, layout=layout, card=card)
            print(json.dumps(out), flush=True)
            outs.append(out)
    return outs


if __name__ == "__main__":
    main()
