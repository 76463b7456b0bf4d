"""Solve/benchmark CLI of the PyTorch/CUDA port.

    python -m bsls_tpu_torch --config medium --method pgd --scenarios 128
    python -m bsls_tpu_torch --config medium --line-search pava
    python -m bsls_tpu_torch --preset medium-banded [--layout gather]
    python -m bsls_tpu_torch --preset medium-lbfgs --scenarios 128 --refine 3
    python -m bsls_tpu_torch --config tiny --method afw --refine-tol 1e-8 --device cpu
    python -m bsls_tpu_torch --preset traffic --refine-tol 1e-6
    python -m bsls_tpu_torch --config tiny --scenarios 4 --oracle --device cpu
    python -m bsls_tpu_torch --config instance.npz --oracle      # or .mat (v5-v7.3)
    python -m bsls_tpu_torch --config medium --checkpoint ck.npz --checkpoint-every 5 [--resume]
    python -m bsls_tpu_torch --config tiny --profile-dir prof/ --device cpu
    torchrun --nproc-per-node 2 -m bsls_tpu_torch --config tiny --mesh-block 2 --device cpu
    python -m bsls_tpu_torch --preset large --mesh-block 1     # a world of one
    torchrun --nproc-per-node 2 -m bsls_tpu_torch --config traffic --mesh-block 2 --device cpu

Emits one JSON result line: iterations/s, objective, FW gap, the torch
device, ``refine_secs``/``refine_fw_gap`` after a polish, ``eq_violation``
for an equality-constrained instance (``traffic``; it runs the
augmented-Lagrangian loop on the gather layout), and objective-vs-oracle
with time-to-1e-6-relative-gap when --oracle supplies f*: one f* per
scenario, and ``rel_gap_vs_oracle`` is the worst scenario's gap against its
own f*.  Every solver family of the reference runs (``--method``).  The
solve runs in float32 whatever a configuration file's ``dtype`` says, as the
reference's CLI does (the CUDA kernels take float32 only).
``--checkpoint``/``--checkpoint-every``/``--resume`` checkpoint the solver
state every K chunks (outer iterations on an equality-constrained instance)
and resume from the newest checkpoint; ``--profile-dir`` writes a
``torch.profiler`` trace of the solve.  ``--mesh-block B [--mesh-scenario
S]`` solves on a B x S mesh (``parallel.make_mesh``) of the ``torchrun``
world, or of a world of one without ``torchrun`` (an equality-constrained
instance runs its augmented-Lagrangian loop there); the result line gains
``"mesh"`` and is printed by rank 0 only, and metrics and checkpoints are
off under a mesh, as in the reference.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(prog="bsls_tpu_torch")
    p.add_argument("--preset", default=None, help="named preset from utils.config")
    p.add_argument("--config", default=None,
                   help="tiny|medium|medium_banded|traffic|traffic_random|large|path.npz|"
                        "path.mat|path.json")
    p.add_argument("--method", default=None,
                   help="pgd|apgd|fista|lbfgs|eg|mirror_descent|frank_wolfe|fw|afw|pairwise|"
                        "pairwise_fw")
    p.add_argument("--line-search", dest="line_search", default=None,
                   help="exact|bb|bbm|fixed|pava")
    p.add_argument("--scenarios", type=int, default=None,
                   help="batch the instance to S right-hand sides")
    p.add_argument("--layout", choices=["auto", "banded", "gather"], default=None,
                   help="device layout of a sparse A (default auto: banded when the "
                        "instance is bandable and has fewer than 16 scenarios)")
    p.add_argument("--tol", type=float, default=None)
    p.add_argument("--max-iter", dest="max_iter", type=int, default=None)
    p.add_argument("--chunk", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--refine", type=int, default=None,
                   help="post-solve f64-anchored polish rounds (breaks the fp32 ~1e-5 "
                        "true-gap floor)")
    p.add_argument("--refine-tol", dest="refine_tol", type=float, default=None,
                   help="certified adaptive refine: polish until the float64 FW duality "
                        "gap certifies this relative gap (--refine caps rounds); the "
                        "certificate is reported as refine_fw_gap")
    p.add_argument("--mesh-block", dest="mesh_block", type=int, default=None,
                   help="block axis of a mesh over the torch.distributed world (0: no mesh)")
    p.add_argument("--mesh-scenario", dest="mesh_scenario", type=int, default=None,
                   help="scenario axis of the mesh")
    p.add_argument("--oracle", action="store_true", default=None)
    p.add_argument("--profile-dir", dest="profile_dir", default=None,
                   help="write a torch.profiler trace of the solve into this directory")
    p.add_argument("--metrics", dest="metrics_path", default=None)
    p.add_argument("--checkpoint", dest="checkpoint_path", default=None)
    p.add_argument("--checkpoint-every", dest="checkpoint_every", type=int, default=None,
                   help="chunks (outer iterations of an eq instance) between checkpoints")
    p.add_argument("--resume", action="store_true", default=None,
                   help="continue from the newest checkpoint at --checkpoint")
    p.add_argument("--device", default=None, help="cuda (default) | cpu")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)

    import torch

    import bsls_tpu_torch as bsls
    from bsls_tpu_torch.models import Problem, synthetic
    from bsls_tpu_torch.models.synthetic import _CONFIGS
    from bsls_tpu_torch.ops.layout import DeviceBanded, resolve_device
    from bsls_tpu_torch.solvers.base import refine_polish, refine_rounds
    from bsls_tpu_torch.utils.config import load_config
    from bsls_tpu_torch.utils.metrics import MetricsWriter
    from bsls_tpu_torch.utils.profiling import trace

    overrides = {
        k: getattr(args, k)
        for k in ("config method line_search scenarios layout tol max_iter chunk seed "
                  "refine refine_tol oracle profile_dir metrics_path checkpoint_path "
                  "checkpoint_every resume device mesh_block mesh_scenario").split()
        if getattr(args, k) is not None
    }
    cfg = load_config(args.preset or args.config or "tiny", **overrides)
    dev = resolve_device(cfg.device)  # no card and no --device cpu: raises here
    mesh = None
    if cfg.mesh_block:
        mesh = bsls.make_mesh(block=cfg.mesh_block, scenario=cfg.mesh_scenario,
                              device=cfg.device)
        dev = mesh.device

    t_gen = time.perf_counter()
    if cfg.config in _CONFIGS:
        prob = synthetic.make_config(cfg.config, seed=cfg.seed, **cfg.instance_kwargs)
    else:
        prob = Problem.load(cfg.config)
    if cfg.scenarios > 1:
        prob = synthetic.with_scenarios(prob, cfg.scenarios, seed=cfg.seed + 1)
    t_gen = time.perf_counter() - t_gen

    f_star = None
    if cfg.oracle:
        from bsls_tpu_torch.models.oracle import cached_oracle_objective

        # cache per (config, seed[, scenario]): the float64 oracle on large
        # instances costs minutes and is deterministic; ad-hoc file paths
        # skip the cache.  Each scenario is its own instance with its own f*.
        key = f"{cfg.config}_{cfg.seed}" if cfg.config in _CONFIGS else None
        S = prob.num_scenarios
        if np.ndim(prob.b) == 2:
            f_star = np.array([
                cached_oracle_objective(prob, key and f"{key}_x{S}_s{s}", scenario=s)
                for s in range(S)])
        else:
            f_star = cached_oracle_objective(prob, key)

    eq = prob.C is not None
    if eq and (cfg.layout == "banded" or not cfg.equilibrate):
        raise ValueError("an equality-constrained instance runs on the equilibrated gather "
                         "layout of its stacked operator: drop --layout banded / "
                         "equilibrate=false")
    with MetricsWriter(cfg.metrics_path) as mw:
        mw.log("config", **json.loads(cfg.to_json()))
        kw = dict(method=cfg.method, line_search=cfg.line_search, tol=cfg.tol,
                  max_iter=cfg.max_iter, chunk=cfg.chunk, step_size=cfg.step_size,
                  metrics=mw if cfg.metrics_path and mesh is None else None,
                  checkpoint_path=cfg.checkpoint_path if mesh is None else None,
                  checkpoint_every=cfg.checkpoint_every, resume=cfg.resume)
        rounds = refine_rounds(cfg.refine, cfg.refine_tol)
        with trace(cfg.profile_dir):
            if eq:
                # the augmented-Lagrangian loop prepares its stacked operator
                # itself (on a mesh, each rank its tile); refine/refine_tol
                # are its finishing outers
                dp = None
                res = bsls.solve(prob, refine=cfg.refine,
                                 refine_tol=cfg.refine_tol, device=dev, mesh=mesh, **kw)
            elif mesh is not None:
                from bsls_tpu_torch.parallel.sharding import shard_problem, solve_sharded

                dp, part = shard_problem(prob, mesh, equilibrate=cfg.equilibrate, layout=cfg.layout)
                res = solve_sharded((dp, part, np.ndim(prob.b) == 1), mesh, **kw)
                if rounds:  # the gathered result, polished on the host
                    res = refine_polish(prob, None, res, rounds=rounds,
                                        target_rel_gap=cfg.refine_tol)
            else:
                dp = bsls.prepare(prob, equilibrate=cfg.equilibrate, layout=cfg.layout, device=dev)
                res = bsls.solve(dp, **kw)
                # the polish of solve(refine=...) on the prepared layout (solve
                # takes the refine options only with the host Problem, which it
                # prepares itself under layout="auto")
                if rounds:
                    res = refine_polish(prob, dp, res, rounds=rounds,
                                        target_rel_gap=cfg.refine_tol)

        ips = res.steady_iters_per_sec()
        out = {
            "config": cfg.config,
            "method": cfg.method,
            "line_search": cfg.line_search,
            "scenarios": cfg.scenarios,
            "layout": "banded" if dp is not None and isinstance(dp.A, DeviceBanded) else "gather",
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
            "n_devices": 1 if mesh is None else mesh.size,
            "mesh": None if mesh is None else dict(mesh.shape),
            "iterations": int(res.iterations),
            "converged": bool(res.converged),
            "objective": np.asarray(res.objective).tolist(),
            "fw_gap": np.asarray(res.gap).tolist(),
            "iters_per_sec": round(ips, 3),
            "gen_secs": round(t_gen, 3),
        }
        if res.eq_violation is not None:
            out["eq_violation"] = res.eq_violation
        if rounds:
            out["refine_secs"] = round(res.refine_secs, 3)
        if res.refine_fw_gap is not None:
            out["refine_fw_gap"] = res.refine_fw_gap
        if f_star is not None:
            fs = np.asarray(f_star, np.float64)
            out["oracle_objective"] = fs.tolist()
            f = np.asarray(res.objective, np.float64)
            # the worst scenario's gap against its own f*
            out["rel_gap_vs_oracle"] = float(np.max((f - fs) / np.maximum(1.0, np.abs(fs))))
            t6 = res.time_to_gap(f_star, rel=1e-6)
            out["time_to_1e-6_gap_s"] = None if t6 is None else round(t6, 4)
        mw.log("result", **out)
    if mesh is None or mesh.rank == 0:
        print(json.dumps(out))
    return out


def script_main() -> None:
    """Console-script entry: a truthy return from main() would become
    SystemExit(dict) under setuptools."""
    main()


if __name__ == "__main__":
    main()
