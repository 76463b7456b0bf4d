"""Profiling: the program's named spans (``span``), a trace of any block
(``trace``), and where a solver iteration spends the device's time
(``profile_steps`` and the command below).

    with trace("prof/"):              # the CLI's --profile-dir
        bt.solve(prob)

Every request opens spans named ``bsls.<phase>`` (``Endpoint.solve``'s
upload, the power iteration, the chunk loop and each chunk, the result, the
eq loop's outers and host work, ``BatchQueue``'s waits): a profiler running
around the call shows them on its host timeline, on the clock of its device
events, and the result's ``phases`` holds their host seconds.

    python -m bsls_tpu_torch.utils.profiling --config medium --scenarios 128 \
        --line-search exact,pava --iters 30 [--trace trace.json]
    python -m bsls_tpu_torch.utils.profiling --config medium_banded --scenarios 1 \
        --line-search bbm --layout auto
    python -m bsls_tpu_torch.utils.profiling --method lbfgs,eg,afw --iters 30

Runs one chunk of ``iters`` iterations of a solver (``--method``, default
pgd; several methods or line searches separated by commas, one line each)
under ``torch.profiler`` after a warm-up, once with the eager runner and
once as a replay of the chunk's captured CUDA graph (under ``graph``), and
prints one JSON line per run: wall time per iteration (host clock around a
synchronised window), the device's busy time per iteration (union of the
kernel intervals), its idle share, the NCCL kernels' device time and share of
the busy time (a sharded problem's collectives), and the kernels by name
with their device time and launches per iteration (the sixteen largest and
every kernel of ``csrc/``).  Needs a CUDA device; an eager trace without any
device event is an error, not a result.  Where the profiler shows none of a
graph's kernels, the graph's device figures are None and its time is the
one read between CUDA events.
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


class span:
    """``with span(name, phases):`` marks the block as ``bsls.<name>`` on
    the host timeline of any ``torch.profiler`` session recording this
    thread, and adds its host seconds (``time.perf_counter``) to
    ``phases[name]`` when a dict is given; ``secs`` and ``t0`` hold them
    after the block.  It synchronises nothing: a phase ends on the device
    only where the block itself waits for the device (a readback, a
    synchronise, a pageable upload).  With no profiler running it costs one
    ``record_function`` enter and exit."""

    __slots__ = ("name", "phases", "t0", "secs", "_rf")

    def __init__(self, name: str, phases: Optional[dict] = None):
        self.name, self.phases = name, phases
        self.t0 = self.secs = 0.0

    def __enter__(self) -> "span":
        self._rf = torch.profiler.record_function(f"bsls.{self.name}")
        self._rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.secs = time.perf_counter() - self.t0
        self._rf.__exit__(*exc)
        if self.phases is not None:
            self.phases[self.name] = self.phases.get(self.name, 0.0) + self.secs


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


def _profile(run, iters: int, trace_path=None) -> dict:
    """``run()`` (``iters`` solver iterations, ending on the device) once
    under ``torch.profiler``: wall time per iteration (host clock around a
    synchronised window), the device's busy time (union of the kernel
    intervals) and idle share, the NCCL kernels' time, the kernels by name,
    and the peak of allocated device memory during the run (a graph's
    intermediates live in its pool, outside that count).  None for the
    device figures when the trace holds no device event."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if trace_path:
        prof.export_chrome_trace(trace_path)

    spans, by_name = [], {}
    for e in prof.events():
        # a span's shadow on the device's timeline is no kernel
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        rec = by_name.setdefault(e.name, [0, 0.0])
        rec[0] += 1
        rec[1] += e.time_range.end - e.time_range.start
    out = {"iters": iters, "wall_ms_per_iter": 1e3 * wall / iters,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if not spans:
        return {**out, "device_busy_ms_per_iter": None, "device_idle_share": None,
                "launches_per_iter": None, "nccl_ms_per_iter": None,
                "nccl_share_of_busy": None, "kernels": []}
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
    # the collectives of a sharded problem: NCCL's kernels (gloo's work runs
    # on the host and shows here only as its copies)
    nccl_us = sum(us for name, (_, us) in by_name.items() if "nccl" in name.lower())
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    # the sixteen largest, and the hand-written kernels of csrc/ wherever they rank
    kernels = kernels[:16] + [kv for kv in kernels[16:] if "bsls::" in kv[0]]
    return {
        **out,
        "device_busy_ms_per_iter": busy / 1e3 / iters,
        "device_idle_share": 1.0 - busy / window,
        "launches_per_iter": sum(c for c, _ in by_name.values()) / iters,
        "nccl_ms_per_iter": nccl_us / 1e3 / iters,
        "nccl_share_of_busy": nccl_us / busy,
        "kernels": [
            {"name": name[:100], "launches_per_iter": c / iters, "ms_per_iter": us / 1e3 / iters}
            for name, (c, us) in kernels
        ],
    }


def _event_ms(run, reps: int = 3) -> float:
    """Mean device time of ``run()`` between two CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_steps(dp, line_search: str, iters: int, warmup: int = 1, trace_path=None,
                  method: str = "pgd", graph: bool = True) -> dict:
    """One chunk of ``iters`` iterations (the exact residual refresh and the
    steps, as ``solve`` runs it) two ways on the same state: the eager
    runner, whose figures are the top-level keys, and replays of the
    chunk's captured CUDA graph (``solvers/graph.py``), under ``graph``
    (None with ``graph=False``, and on a mesh rank, whose chunk is not
    captured yet).  A graph's kernels that the profiler does not see leave
    its device figures None; its wall time is also read between CUDA events
    (``event_ms_per_iter``)."""
    from ..solvers.base import (
        SolveOptions, _get_solver, make_chunk_runner, power_lipschitz, power_lipschitz_z,
        uses_zspace,
    )
    from ..solvers.graph import graph_runner

    solver = _get_solver(method)
    opts = SolveOptions(method=method, line_search=line_search, chunk=iters)
    power = power_lipschitz_z if uses_zspace(method, line_search) else power_lipschitz
    L_est = power(dp)
    st = solver.init(dp, L_est, opts)
    eager = make_chunk_runner(dp, solver, opts, L_est, iters)
    replay = (graph_runner(dp, solver, opts, L_est, iters, st)
              if graph and not dp.sharded else None)
    for _ in range(warmup):
        eager(st)
        if replay is not None:
            replay(st)
    out = _profile(lambda: eager(st), iters, trace_path)
    g = None
    if replay is not None:
        g = _profile(lambda: replay(st), iters)
        g["event_ms_per_iter"] = _event_ms(lambda: replay(st)) / iters
        g["profiler_saw_graph"] = g["device_busy_ms_per_iter"] is not None
        g["pool_bytes"] = replay.program.pool_bytes
    return {"method": method, "line_search": line_search, **out, "graph": g}


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
            if out["device_busy_ms_per_iter"] is None:
                raise RuntimeError("the profiler recorded no device event of the eager "
                                   "steps: time with CUDA events instead")
            out.update(config=args.config, scenarios=args.scenarios, layout=layout, card=card)
            print(json.dumps(out), flush=True)
            outs.append(out)
    return outs


if __name__ == "__main__":
    main()
