"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics, and the result line.

A cell is found by its name in ``BENCHMARK.json``, which names its
configuration and its traffic; everything else is read from files named
after them:

    perfbench/configs/<config>.json     the deployment: generator, reference
    perfbench/traffic/<traffic>.json    the mix: loop, requests, solve options
    perfbench/workloads/<cell>.json     the cell's own numbers: rate, limits
    perfbench/metrics/<metric>.py       ``read(run) -> float | None``

so a later cell, configuration, mix or metric is a set of new files.
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "bsls_tpu")
PROGRAM = "bsls_tpu_torch"

__all__ = ["Cell", "run_cell", "main", "forbidden_modules", "pool_size", "inputs", "serve"]


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_reader(kind: str, name: str, bench_dir: str = BENCH):
    """The module ``perfbench/<kind>/<name>.py`` (names may hold dots)."""
    path = os.path.join(bench_dir, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, compared
    whole (``bsls_tpu_torch`` is not ``bsls_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Cell:
    """A cell's entry in ``BENCHMARK.json`` and the files it names."""

    def __init__(self, name: str, benchmark: dict | None = None, bench_dir: str = BENCH):
        bench = benchmark or _json(ROOT, "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.chips, self.bench_dir = name, int(entry["chips"]), bench_dir
        self.config = _json(bench_dir, "configs", f"{entry['config']}.json")
        own = _json(bench_dir, "workloads", f"{name}.json")
        self.traffic = {**_json(bench_dir, "traffic", f"{entry['traffic']}.json"),
                        **own.get("traffic", {})}
        self.limits = own["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


class OuterSink:
    """A ``metrics`` sink of the equality-constrained loop that keeps its
    "outer" records."""

    def __init__(self):
        self.outer = []

    def log(self, kind, **fields):
        if kind == "outer":
            self.outer.append(fields)


def _program(device):
    """The program under test, from this checkout only."""
    import bsls_tpu_torch as bt

    where = os.path.dirname(os.path.abspath(bt.__file__))
    if os.path.dirname(where) != ROOT:
        raise RuntimeError(f"{PROGRAM} was loaded from {where}, not from this checkout")
    return bt


def _card(device) -> str:
    import torch

    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
        return out[device.index or 0] if out else torch.cuda.get_device_name(device)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device)


def pool_size(cell: "Cell", seconds: float, seed: int) -> int:
    """Requests made before the window: one for each arrival of an open loop;
    for a closed loop ``pool_per_s`` for each second of the window, more than
    it answers (a request past them is made when it is sent)."""
    from . import drive

    tr = cell.traffic
    if tr["loop"] == "open":
        return len(drive.arrival_offsets(tr["rate_per_s"], seconds, seed))
    return max(math.ceil(seconds * float(tr["pool_per_s"])), 1)


def inputs(cell: "Cell", seed: int, dev, count: int):
    """The instance of a run and its requests (``count`` of them made now),
    from the seed."""
    from . import instances

    inst = instances.make_instance(cell.config["generator"], seed)
    instances.plant_base(inst, cell.config["generator"], seed, dev)
    return inst, instances.Requests(inst, cell.traffic, seed, dev, count)


def serve(cell: "Cell", inst, seed: int, dev):
    """The program's endpoint for the instance, warmed up at every width the
    traffic sends (its chunk graphs captured), and for an open loop its
    ``BatchQueue``.  The warm-up's requests are drawn apart from the
    window's, so that no right-hand side of the window was solved before."""
    import torch

    from . import instances

    bt = _program(dev)
    tr = cell.traffic
    warm = instances.Requests(inst, tr, seed, dev, tr["warm_requests"], stream=1)
    A = bt.EllMatrix(rows=inst.rows, vals=inst.vals, num_rows=inst.m)
    C = None if inst.C is None else bt.DenseMatrix(inst.C)
    prob = bt.Problem(A=A, b=warm[0], partition=bt.BlockPartition.from_sizes(inst.sizes), C=C,
                      d=inst.d)
    ep = bt.Endpoint(prob, device=dev, **tr["endpoint"])
    for width in tr["warm_widths"]:
        ep.warmup(width)
    # whole requests before the clock as well: a first request that runs
    # past the warm-up's one chunk (later outers, the host's float64 work,
    # the allocator's first blocks) is slower by up to a tenth
    queue = None
    if tr["loop"] == "open":
        queue = bt.BatchQueue(ep, **tr["queue"], **tr["solve"])
        for fut in [queue.submit(warm[i]) for i in range(tr["warm_requests"])]:
            fut.result()
    else:
        for i in range(tr["warm_requests"]):
            ep.solve(warm[i], **tr["solve"])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return ep, queue


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None, log=None) -> dict:
    """Run ``cell`` once and return its result line as a dict (the checks'
    table under ``checks``, last)."""
    import torch

    from . import check, drive
    from .trace import Tracer

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        dev = torch.device("cuda", 0 if dev.index is None else dev.index)
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)  # the context, before the clock of the inputs
    cfg, tr = cell.config, cell.traffic
    t0 = time.perf_counter()
    inst, pool = inputs(cell, seed, dev, pool_size(cell, seconds, seed))
    input_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ep, queue = serve(cell, inst, seed, dev)
    program_s = time.perf_counter() - t0

    tracer = Tracer(dev) if trace else None
    if tracer:
        tracer.prime()
    sinks = []

    def call(b):
        kw = dict(tr["solve"])
        # outer records cost a float64 objective each: only outside the
        # traced request, whose idle share they would inflate
        if trace and inst.C is not None and tracer.prof is None:
            sinks.append(OuterSink())
            kw["metrics"] = sinks[-1]
        t = time.perf_counter()
        res = ep.solve(b, **kw)
        res.host_s = time.perf_counter() - t
        return res

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    if tr["loop"] == "closed":
        reqs, window = drive.closed_loop(call, pool, seconds, tracer, tr.get("trace_request", 1))
        served = None
    else:
        offsets = drive.arrival_offsets(tr["rate_per_s"], seconds, seed)
        q0 = (queue.batches_run, queue.requests_served)
        reqs, window = drive.open_loop(queue.submit, pool, offsets, seconds, tr["wait_s"], tracer,
                                       tr["trace_from_s"], tr["trace_s"])
        queue.close()
        served = {"batches": queue.batches_run - q0[0], "requests": queue.requests_served - q0[1]}
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    answers = [r for r in reqs if r["ok"]]
    shapes = {"S": int(tr["scenarios"]), "n": inst.n, "m": inst.m, "nnz": inst.nnz,
              "blocks": len(inst.sizes), "p": 0 if inst.C is None else inst.C.shape[0]}
    run = {"requests": reqs, "window": window, "setup_s": setup_s, "served": served,
           "outer": [o for s in sinks for o in s.outer], "outer_requests": len(sinks),
           "trace": tracer.finish() if tracer else None, "shapes": shapes,
           "peaks": _json(BENCH, "peaks.json"), "traffic": tr}
    # the program's state goes before the reference runs on the card
    del ep, queue, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)

    t0 = time.perf_counter()
    values = check.numbers(cfg["reference"], inst, tr, pool, answers, seed, dev)
    correct, table = check.judge(values, cell.limits)
    failed = sum(1 for r in reqs if not r["ok"])
    correct = correct and failed == 0 and bool(answers)
    check_s = time.perf_counter() - t0

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = load_reader("metrics", m["name"], cell.bench_dir).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(reqs), "failed": failed,
           "metrics": metrics, "device": device_info}
    if trace and run["trace"] is not None:
        device_info["busy_s"] = run["trace"]["busy_s"]
        device_info["window_s"] = run["trace"]["window_s"]
        out["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                            "idle_gaps": run["trace"]["idle_gaps"]}
    done = [r for r in reqs if r["ok"]]
    late = [r["start"] - r["due"] for r in reqs]
    log(f"cell {cell.name} seed {seed} card {_card(dev)}")
    log(f"setup_s {setup_s:.4f} = inputs {input_s:.4f} + program {program_s:.4f} + load "
        f"{setup_s - input_s - program_s:.4f}")
    log(f"requests {len(reqs)} answered {len(done)} in window "
        f"{sum(1 for r in done if r['end'] <= window[1])}; request s "
        f"{[round(r['end'] - r['start'], 4) for r in done[:12]]}")
    log(f"generator late s: max {max(late):.6f} mean {float(np.mean(late)):.6f}; check_s "
        f"{check_s:.2f}")
    for name, (v, lim) in table.items():
        log(f"check {name} {v!r} limit {lim!r}")
    out["setup_parts"] = {"inputs_s": input_s, "program_s": program_s}
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in table.items()}
    return out


class ForbiddenImport(RuntimeError):
    pass


def _sanitise(obj):
    if isinstance(obj, float) and not math.isfinite(obj):
        return 1e300
    if isinstance(obj, dict):
        return {k: _sanitise(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitise(v) for v in obj]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def main(argv=None, t_start: float | None = None) -> int:
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
        # again once the check and the metrics' readers have run: they load
        # code too
        found = forbidden_modules()
        if found:
            raise ForbiddenImport(found)
    except ForbiddenImport as exc:
        print(f"forbidden modules loaded: {', '.join(exc.args[0])}", file=sys.stderr)
        return 3
    print(json.dumps(_sanitise(out)), flush=True)
    return 0
