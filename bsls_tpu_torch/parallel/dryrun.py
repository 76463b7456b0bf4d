"""Multi-rank dry run: every sharded code path against an unsharded twin.

    python -m bsls_tpu_torch.parallel.dryrun 4 --device cpu
    python -m bsls_tpu_torch.parallel.dryrun 4 --device cuda   # 4 ranks, one or more cards

``dryrun_multichip(n)`` spawns n ranks (a ``torch.distributed`` world on a
``file://`` store), builds a (block, scenario) mesh and runs, on tiny shapes:
every solver family (pgd, apgd, lbfgs, eg, frank_wolfe, afw) and pgd with
``line_search="pava"`` with column sharding; a 3-chunk run and a checkpoint resume; a ragged multi-bucket
partition; row sharding of dense and of ELL A; the 2-D (row x column) grid
when n % 4 == 0; the banded layout under column sharding; and the
equality-constrained loop on the stacked operator sharded by column and by
row, and with a ``refine`` round after a converged loop.  Each sharded solve
is held against an unsharded twin run with the same explicit Lipschitz
constant: the objectives must agree to ``rtol`` (1e-4; 1e-3 for the resumed
run and for the equality-constrained loop, whose twin estimates its own
constants as the reference's does), so a misplaced all-reduce fails the
run, not just a NaN; the refined loop must also hold its constraints to
1e-6.

Ranks that share a card use gloo (NCCL refuses two ranks on one device);
with a card per rank the default backend takes NCCL for CUDA tensors.  A
rank that fails or a world that outlives ``timeout`` fails the run, and every
rank is stopped.

Counterpart of ``__graft_entry__.py::dryrun_multichip``.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np

__all__ = ["dryrun_multichip"]


def _check(report, res, what, twin, rtol=1e-4, scale=1e-30):
    """Hold ``res`` against ``twin`` (objectives to ``rtol``, 1e-7 absolute)
    and report their difference relative to the twin's objective, or to
    ``scale`` where that is larger (an objective at zero)."""
    obj, ref = np.asarray(res.objective), np.asarray(twin.objective)
    if not np.all(np.isfinite(obj)):
        raise AssertionError(f"non-finite objective: {what}")
    if obj.shape != ref.shape:
        raise AssertionError(f"{what}: shape {obj.shape} != {ref.shape}")
    if not np.allclose(obj, ref, rtol=rtol, atol=1e-7):
        raise AssertionError(f"sharded/unsharded objective mismatch: {what}: {obj} vs {ref}")
    report[what] = float(np.max(np.abs(obj - ref) / np.maximum(np.abs(ref), scale)))


def _counted(into: dict, fn):
    """``fn()`` with the kernel launches it makes, and only those, added to
    ``into``."""
    from bsls_tpu_torch.ops.cudalib import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    for name, c in launch_counts().items():
        into[name] = into.get(name, 0) + c
    return out


def _cases(n: int, device: str, workdir: str) -> tuple[dict, dict, dict]:
    """(report, the sharded solves' launches, the twins' launches) of this
    rank."""
    import torch.distributed as dist

    import bsls_tpu_torch as bt
    from bsls_tpu_torch.ops.banded import DeviceBanded
    from bsls_tpu_torch.parallel import make_mesh, shard_problem, solve_sharded
    from bsls_tpu_torch.solvers.base import power_lipschitz, power_lipschitz_z

    block, scenario = (n // 2, 2) if n >= 2 and n % 2 == 0 else (n, 1)
    mesh = make_mesh(block=block, scenario=scenario, device=device)
    mesh_b = make_mesh(block=n, scenario=1, device=device)
    dev = mesh.device
    report: dict = {}
    mesh_launches: dict = {}
    twin_launches: dict = {}

    def sharded(prob, on, **kw):
        return _counted(mesh_launches, lambda: solve_sharded(prob, on, **kw))

    def twin(prob, **kw):
        return _counted(twin_launches, lambda: bt.solve(prob, device=dev, **kw))

    def lipschitz(prob, power=power_lipschitz):
        # one estimate for every rank and the twin: rank 0's, broadcast
        box = [power(bt.prepare(prob, device=dev)) if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    # 1. uniform single-bucket instance, every family, column sharding
    prob = bt.synthetic.large_sharded(seed=0, num_blocks=max(4 * block, 16), dim=4, m=64,
                                      num_scenarios=2 * scenario, block_multiple=block,
                                      noise=1e-3)
    Lp = lipschitz(prob)
    for method in ("pgd", "apgd", "lbfgs", "eg", "frank_wolfe", "afw"):
        kw = dict(method=method, tol=0.0, max_iter=2, chunk=1, lipschitz=Lp)
        _check(report, sharded(prob, mesh, **kw), method, twin(prob, **kw))

    # 1a. line_search="pava": the z-space trial point and its curvature
    kw = dict(method="pgd", line_search="pava", tol=0.0, max_iter=2, chunk=1,
              lipschitz=lipschitz(prob, power_lipschitz_z))
    _check(report, sharded(prob, mesh, **kw), "pava", twin(prob, **kw))

    # 1b. three chunks (refresh at the chunk boundaries, the stop rule's
    # gathered stats), then a checkpoint written at 2 and resumed to 3
    kw3 = dict(method="pgd", tol=0.0, chunk=1, lipschitz=Lp)
    full = sharded(prob, mesh, max_iter=3, **kw3)
    _check(report, full, "3-chunk", twin(prob, max_iter=3, **kw3))
    ck = os.path.join(workdir, "state")
    sharded(prob, mesh, max_iter=2, checkpoint_path=ck, checkpoint_every=2, **kw3)
    resumed = sharded(prob, mesh, max_iter=3, checkpoint_path=ck, resume=True, **kw3)
    _check(report, resumed, "checkpoint-resume", full, rtol=1e-3)

    # 2. ragged multi-bucket partition (variable block sizes), column sharding
    rag = bt.synthetic.traffic_like(seed=1, num_blocks=8 * n, m=64, num_eq=0, noise=1e-3)
    rag = bt.Problem(A=rag.A, b=rag.b, partition=rag.partition)
    kw = dict(method="pgd", tol=0.0, max_iter=2, chunk=1, lipschitz=lipschitz(rag))
    _check(report, sharded(rag, mesh_b, **kw), "ragged", twin(rag, **kw))

    # 3-4. row sharding of dense and of ELL A
    dense = bt.synthetic.tiny_dense(seed=2, num_blocks=16, dim=4, m=8 * n + 3)
    kw = dict(method="apgd", tol=0.0, max_iter=2, chunk=1, lipschitz=lipschitz(dense))
    _check(report, sharded(dense, mesh_b, shard_rows=True, **kw), "row-sharded dense",
           twin(dense, **kw))
    sparse = bt.synthetic.medium_sparse(seed=3, num_blocks=16, m=8 * n)
    kw = dict(method="pgd", tol=0.0, max_iter=2, chunk=1, lipschitz=lipschitz(sparse))
    _check(report, sharded(sparse, mesh_b, shard_rows=True, **kw), "row-sharded ELL",
           twin(sparse, **kw))

    # 5. the 2-D (row x column) grid
    if n % 4 == 0:
        mesh_2d = make_mesh(row=2, block=2, scenario=n // 4, device=device)
        p2d = bt.synthetic.large_sharded(seed=5, num_blocks=16, dim=4, m=64,
                                         num_scenarios=2 * (n // 4), block_multiple=2,
                                         noise=1e-3)
        kw = dict(method="pgd", tol=0.0, max_iter=2, chunk=1, lipschitz=lipschitz(p2d))
        _check(report, sharded(p2d, mesh_2d, **kw), "2-D grid", twin(p2d, **kw))

    # 6. the banded layout under column sharding: band groups split over
    # 'block', the residual on the column-sharded dual-ELL
    corr = bt.synthetic.medium_banded(seed=6, num_blocks=8 * n, m=2048, spread=100)
    dpb, _ = shard_problem(corr, mesh_b, layout="banded")
    if not (isinstance(dpb.A, DeviceBanded) and dpb.A.bands[0].shape[0] * n == dpb.A.pages):
        raise AssertionError("banded layout not sharded over the block axis")
    kw = dict(method="pgd", tol=0.0, max_iter=2, chunk=1, lipschitz=lipschitz(corr))
    _check(report, sharded(corr, mesh_b, layout="banded", **kw), "sharded banded",
           twin(corr, layout="banded", **kw))

    # 7. the equality-constrained loop over sharded inner solves: the stacked
    # operator by column and by row (p = 4 rows of C padded to the row
    # shards), then a refine round after a converged loop
    eq = bt.synthetic.traffic_like(seed=4, num_blocks=8 * n, m=64, num_eq=4, noise=0.0)

    def eq_pair(name, shard_rows=False, scale=1e-30, **kw):
        got = _counted(mesh_launches, lambda: bt.solve_equality_constrained(
            eq, mesh=mesh_b, shard_rows=shard_rows, **kw))
        want = _counted(twin_launches, lambda: bt.solve_equality_constrained(
            eq, device=dev, **kw))
        _check(report, got, name, want, rtol=1e-3, scale=scale)
        return got

    kw = dict(method="apgd", tol=0.0, outer_iters=1, inner_iters=1, chunk=1)
    eq_pair("eq-constrained", **kw)
    eq_pair("eq-constrained rows", shard_rows=True, **kw)
    # both loops end at the planted flow, objective ~1e-25: their difference
    # is reported relative to the objective at x = 0
    f_zero = 0.5 * float(np.sum(np.square(np.asarray(eq.b, np.float64))))
    refined = eq_pair("eq-constrained+refine", method="apgd", tol=1e-7, outer_iters=6,
                      inner_iters=300, chunk=100, refine=1, scale=f_zero)
    if not refined.eq_violation <= 1e-6:
        raise AssertionError(f"mesh eq+refine violation {refined.eq_violation}")
    return report, mesh_launches, twin_launches


def _rank_main(rank, n, init_file, device, backend, workdir, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=n)
        out.put((rank, "ok", _cases(n, device, workdir)))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
        raise


def dryrun_multichip(n_ranks: int, device: str = "cuda", backend=None,
                     timeout: float = 600.0) -> dict:
    """Run the dry run on ``n_ranks`` spawned ranks.  Returns ``cases``, rank
    0's report (case -> relative objective difference from the unsharded
    twin); ``launches``, the kernel launches of all ranks' sharded solves and
    of nothing else (each count is reset just before such a solve); and
    ``twin_launches``, those of the ranks' unsharded twins.  Raises if a rank
    fails or the world outlives ``timeout`` seconds."""
    if backend is None:
        if device == "cpu":
            backend = "gloo"
        else:
            import torch

            from .mesh import default_backend

            backend = default_backend() if torch.cuda.device_count() >= n_ranks else "gloo"
    ctx = mp.get_context("spawn")
    workdir = tempfile.mkdtemp(prefix="bsls_dryrun_")
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, n_ranks, os.path.join(workdir, "init"),
                                                  device, backend, workdir, out))
             for r in range(n_ranks)]
    try:
        for p in procs:
            p.start()
        results, deadline = {}, time.monotonic() + timeout
        while len(results) < n_ranks:
            try:
                rank, status, payload = out.get(timeout=1.0)
            except queue.Empty:
                dead = {r: p.exitcode for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)}
                if dead:
                    raise RuntimeError(f"dry run: rank(s) exited without a result: {dead}") \
                        from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"dry run: {n_ranks - len(results)} rank(s) still "
                                       f"running after {timeout:.0f} s") from None
                continue
            if status != "ok":
                raise RuntimeError(f"dry run: rank {rank} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        launches: dict = {}
        twin_launches: dict = {}
        for _, mesh_counts, twin_counts in results.values():
            for into, counts in ((launches, mesh_counts), (twin_launches, twin_counts)):
                for name, c in counts.items():
                    into[name] = into.get(name, 0) + c
        return {"cases": results[0][0], "launches": launches, "twin_launches": twin_launches}
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m bsls_tpu_torch.parallel.dryrun")
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None)
    args = ap.parse_args(argv)
    print(json.dumps(dryrun_multichip(args.n, device=args.device, backend=args.backend)))


if __name__ == "__main__":
    main()
