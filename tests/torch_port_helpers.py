"""Shared helpers of the tests/test_torch_*.py files: flatten the device
objects of both packages to dictionaries of numpy arrays (the only thing that
crosses between them) and build the small seeded instances the tests use.

Every test_torch_*.py module imports ``one_torch_thread``, so each runs
torch at one intra-op thread, alone or in the suite."""
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch at one intra-op thread while a module of the port's tests runs:
    the suite's workers share the machine's cores, and torch's default of one
    thread per core in each of them spins against the others.  The count
    comes back after the module, so that the reference's tests in the same
    worker run in the process state they have without the port's: a worker
    where torch's thread count was set makes the reference's CPU mesh tests
    (XLA's collectives over 8 virtual devices) hang more often."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# every hand-written kernel of the port, under the name its wrapper counts
KERNELS = ("proj_simplex_rows", "pava_rows", "band_zmv", "band_grmv", "pgd_chunk",
           "ell_gather_dot", "step_prep", "step_dir", "step_update")


def _arr(a):
    # works for jax arrays, torch CPU tensors and numpy alike
    return np.asarray(a.detach().cpu().numpy() if hasattr(a, "detach") else a)


def _flatten_ell(d, stem, A):
    d[f"{stem}.rows"], d[f"{stem}.vals"] = _arr(A.rows), _arr(A.vals)
    if isinstance(A.mv_cols, tuple):
        for i, (c, v) in enumerate(zip(A.mv_cols, A.mv_vals)):
            d[f"{stem}.mv_cols[{i}]"], d[f"{stem}.mv_vals[{i}]"] = _arr(c), _arr(v)
    elif A.mv_cols is not None:
        d[f"{stem}.mv_cols"], d[f"{stem}.mv_vals"] = _arr(A.mv_cols), _arr(A.mv_vals)
    if A.rt_rows is not None:
        for i, (c, v) in enumerate(zip(A.rt_rows, A.rt_vals)):
            d[f"{stem}.rt_rows[{i}]"], d[f"{stem}.rt_vals[{i}]"] = _arr(c), _arr(v)
        d[f"{stem}.rt_inv"] = _arr(A.rt_inv)
    d[f"{stem}.rt_zeros"] = int(A.rt_zeros)


def _flatten_matrix(d, stem, A):
    if hasattr(A, "data"):
        d[f"{stem}.data"] = _arr(A.data)
    elif hasattr(A, "split"):  # the stacked operator of the eq path
        _flatten_matrix(d, f"{stem}.top", A.top)
        _flatten_matrix(d, f"{stem}.bottom", A.bottom)
        d[f"{stem}.bottom_scale"] = _arr(A.bottom_scale)
        d[f"{stem}.split"] = int(A.split)
    elif hasattr(A, "bands"):
        for i, band in enumerate(A.bands):
            d[f"{stem}.bands[{i}]"] = _arr(band)
        d[f"{stem}.back"], d[f"{stem}.wpages"] = int(A.back), int(A.wpages)
        d[f"{stem}.seg_lens"] = tuple(int(v) for v in A.seg_lens)
        d[f"{stem}.pages"] = int(A.pages) if A.pages else int(A.bands[0].shape[0])
        if A.resid is not None:
            _flatten_ell(d, f"{stem}.resid", A.resid)
    else:
        _flatten_ell(d, stem, A)


def flatten_device_problem(dp) -> dict:
    """A DeviceProblem of either package -> {field name: numpy array}, under
    the key names that bsls_tpu_torch.convert documents."""
    d = {}
    _flatten_matrix(d, "A", dp.A)
    d["b"] = _arr(dp.b)
    d["perm"] = _arr(dp.perm)
    d["row_perm"] = None if dp.row_perm is None else _arr(dp.row_perm)
    d["n_user"], d["num_rows"] = int(dp.n_user), int(dp.num_rows)
    for i, bk in enumerate(dp.buckets):
        d[f"buckets[{i}].mask"] = _arr(bk.mask)
        d[f"buckets[{i}].sizes"] = _arr(bk.sizes)
        d[f"buckets[{i}].radius"] = _arr(bk.radius)
        d[f"buckets[{i}].width"] = int(bk.width)
    return d


def flatten_state(st) -> dict:
    """A PGDState of either package -> {field name: numpy array}."""
    d = {f"xp[{i}]": _arr(x) for i, x in enumerate(st.xp)}
    for name in ("r", "f", "gap", "x_prev", "g_prev"):
        d[name] = _arr(getattr(st, name))
    d["k"] = np.asarray(st.k)
    return d


def small_instance(synthetic, kind: str, scenarios: int = 1):
    """The small seeded instances, from either package's ``synthetic``."""
    if kind == "dense":
        prob = synthetic.tiny_dense(seed=3, num_blocks=12, dim=5, m=64)
    elif kind == "ell":
        prob = synthetic.medium_sparse(seed=3, num_blocks=64, m=512)
    elif kind == "banded":
        prob = synthetic.medium_banded(seed=2, num_blocks=300, m=3000, spread=120)
    else:
        raise KeyError(kind)
    if scenarios > 1:
        prob = synthetic.with_scenarios(prob, scenarios, seed=4)
    return prob


# ---------------- worlds of several processes (tests/test_torch_distributed.py)

# the instances of the mesh tests, from either package's ``synthetic``
def mesh_instance(synthetic, kind: str):
    if kind == "uniform":  # one bucket, 4 scenarios
        return synthetic.large_sharded(seed=0, num_blocks=16, dim=4, m=64, num_scenarios=4,
                                       block_multiple=2, noise=1e-3)
    if kind == "uniform2":  # the 2-D grid's: 2 scenarios
        return synthetic.large_sharded(seed=5, num_blocks=16, dim=4, m=64, num_scenarios=2,
                                       block_multiple=2, noise=1e-3)
    if kind == "dense":  # rows not divisible by 4: padded
        return synthetic.tiny_dense(seed=2, num_blocks=16, dim=4, m=35)
    if kind == "ell":
        return synthetic.medium_sparse(seed=3, num_blocks=16, m=32)
    if kind == "banded":  # spills columns to the residual ELL
        return synthetic.medium_banded(seed=6, num_blocks=32, m=2048, spread=600)
    if kind == "refine":
        return synthetic.tiny_dense(seed=1, num_blocks=20, dim=6, m=150)
    raise KeyError(kind)


FAMILIES = ("pgd", "apgd", "lbfgs", "eg", "frank_wolfe", "afw")
# (name, instance, mesh shape, solve_sharded options) of the layouts world
LAYOUTS = (
    ("rows_dense", "dense", dict(block=4), dict(method="apgd", shard_rows=True)),
    ("rows_ell", "ell", dict(block=4), dict(method="pgd", shard_rows=True)),
    ("grid", "uniform2", dict(row=2, block=2), dict(method="pgd")),
    ("banded", "banded", dict(block=4), dict(method="pgd", layout="banded")),
    ("pava", "uniform", dict(block=2, scenario=2), dict(method="pgd", line_search="pava")),
)
WORLD_ITERS = dict(tol=0.0, max_iter=20, chunk=10)

_CHILD = """
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
from torch_port_helpers import world_child
world_child()
"""


DTYPES = ("float64", "float32")


def _world_families(spec):
    import torch

    import bsls_tpu_torch as bt
    import bsls_tpu_torch.models.synthetic as syn

    mesh = bt.make_mesh(block=2, scenario=2, device="cpu")
    prob = mesh_instance(syn, "uniform")
    out = {}
    for dtype in DTYPES:
        for method in FAMILIES:
            r = bt.solve(prob, mesh=mesh, method=method, lipschitz=spec["L"]["uniform"],
                         dtype=getattr(torch, dtype), **WORLD_ITERS)
            out.update({f"{dtype}.{method}.f": r.objective,
                        f"{dtype}.{method}.trace": r.trace_f, f"{dtype}.{method}.x": r.x})
    return out


def _world_layouts(spec):
    import torch

    import bsls_tpu_torch as bt
    import bsls_tpu_torch.models.synthetic as syn

    out = {}
    for name, kind, shape, kw in LAYOUTS:
        mesh = bt.make_mesh(device="cpu", **shape)
        for dtype in DTYPES:
            r = bt.solve(mesh_instance(syn, kind), mesh=mesh, lipschitz=spec["L"][name],
                         dtype=getattr(torch, dtype), **kw, **WORLD_ITERS)
            out.update({f"{dtype}.{name}.f": r.objective, f"{dtype}.{name}.trace": r.trace_f,
                        f"{dtype}.{name}.x": r.x})
    return out


def _world_checkpoint(spec):
    import glob
    import os

    import torch.distributed as dist

    import bsls_tpu_torch as bt
    import bsls_tpu_torch.models.synthetic as syn

    prob = mesh_instance(syn, "uniform")
    mesh = bt.make_mesh(block=2, device="cpu")
    ck = os.path.join(spec["dir"], "ck.npz")
    kw = dict(method="lbfgs", tol=0.0, chunk=10, lipschitz=spec["L"]["uniform"])
    full = bt.solve(prob, mesh=mesh, max_iter=30, **kw)
    bt.solve(prob, mesh=mesh, max_iter=20, checkpoint_path=ck, checkpoint_every=1,
             checkpoint_keep=2, **kw)
    dist.barrier()
    files = sorted(os.path.basename(f) for f in glob.glob(os.path.join(spec["dir"], "ck*")))
    resumed = bt.solve(prob, mesh=mesh, max_iter=30, checkpoint_path=ck, resume=True, **kw)
    other = bt.make_mesh(block=1, scenario=2, device="cpu")

    def refusal(on):
        try:
            bt.solve(prob, mesh=on, max_iter=30, checkpoint_path=ck, resume=True, **kw)
            return ""
        except ValueError as e:
            return str(e)

    refused = refusal(other)
    # rank 1 loses its newest file: every rank resumes from the newest
    # iteration all of them hold
    if dist.get_rank() == 1:
        os.remove(os.path.join(spec["dir"], "ck.it000000020.proc1.npz"))
    dist.barrier()
    older = bt.solve(prob, mesh=mesh, max_iter=30, checkpoint_path=ck, resume=True, **kw)
    # rank 1's file of that iteration is unreadable: every rank raises
    if dist.get_rank() == 1:
        with open(os.path.join(spec["dir"], "ck.it000000010.proc1.npz"), "w") as fh:
            fh.write("not a checkpoint")
    dist.barrier()
    return {"full.f": full.objective, "full.x": full.x, "resumed.f": resumed.objective,
            "resumed.x": resumed.x, "resumed.trace": resumed.trace_f,
            "resumed.iterations": resumed.iterations, "files": np.asarray(files),
            "refused": np.asarray(refused), "older.f": older.objective,
            "older.trace": older.trace_f, "unreadable": np.asarray(refusal(mesh))}


def _world_refine(spec):
    import bsls_tpu_torch as bt
    import bsls_tpu_torch.models.synthetic as syn

    prob = mesh_instance(syn, "refine")
    mesh = bt.make_mesh(block=2, device="cpu")
    kw = dict(method="lbfgs", tol=0.0, max_iter=150)
    r0 = bt.solve(prob, mesh=mesh, **kw)
    r1 = bt.solve(prob, mesh=mesh, refine=6, **kw)
    return {"f0": prob.objective_np(np.asarray(r0.x, np.float64)), "f1": r1.objective,
            "x1": r1.x, "refine_secs": r1.refine_secs}


def _world_cli(spec):
    from bsls_tpu_torch.cli import main

    main(spec["argv"])
    return {}


# ---------------- the equality-constrained mesh (tests/test_torch_eq_mesh.py)

# (name, shard_rows, scenarios, num_eq) of the two-rank AL loop held against
# the reference: by column with one right-hand side; by row with two and
# p = 1 < 2 rows of C (rank 1's bottom part is one padded zero row)
EQ_MESH_CASES = (("col", False, 1, 4), ("rows", True, 2, 1))
EQ_MESH_ITERS = dict(method="pgd", line_search="exact", tol=1e-9, eq_tol=1e-7, max_iter=600,
                     inner_iters=150, chunk=50)


def eq_mesh_instance(syn, scenarios: int, num_eq: int):
    prob = syn.traffic_like(seed=0, num_blocks=12, m=60, num_eq=num_eq)
    return prob if scenarios == 1 else syn.with_scenarios(prob, scenarios, seed=4)


def _even(a, k, n, axis=0):
    size = a.shape[axis] // n
    return np.take(a, range(k * size, (k + 1) * size), axis=axis)


def stacked_tile(flat: dict, rows: bool, k: int, n: int) -> dict:
    """Rank ``k``'s tile (of ``n`` block shards, one scenario shard) of a
    flattened stacked ``DeviceVStack`` problem whose arrays are global, as
    the reference's ``shard_problem``/``shard_problem_rows`` leave them:
    in the port's local shapes, with ``num_rows`` and ``A.split`` global."""
    out = {}
    for key, a in flat.items():
        if not isinstance(a, np.ndarray) or key in ("A.bottom_scale", "row_perm"):
            out[key] = a
        elif key.startswith("A.top.mv_"):
            out[key] = a[k:k + 1]
        elif key.startswith("A.top."):  # rows/vals: (n_pf, k), or (nr, n_pf, ks) by row
            out[key] = a[k] if rows else _even(a, k, n)
        elif key == "A.bottom.data":
            out[key] = _even(a, k, n, axis=0 if rows else 1)
        elif key == "b":
            out[key] = _even(np.atleast_2d(a), k, n, axis=1) if rows else a
        else:  # perm and the buckets follow the column shard
            out[key] = a if rows else _even(a, k, n)
    return out


def _world_eq_mesh(spec):
    """Rank k of the two-rank eq world: the AL loop on a block-2 mesh,
    column- and row-sharded, with the reference's tile and Lipschitz pair
    carried into the port's op_cache (float64); then checkpoint and resume at
    outer granularity.  Every rank checks that all ranks returned the same
    bits."""
    import os

    import torch
    import torch.distributed as dist

    import bsls_tpu_torch as bt
    import bsls_tpu_torch.models.synthetic as syn
    from bsls_tpu_torch.convert import device_problem_from_numpy
    from bsls_tpu_torch.parallel import sharding as TS
    from bsls_tpu_torch.solvers import eq_constrained as TEQ

    rank = dist.get_rank()
    mesh = bt.make_mesh(block=2, device="cpu")
    f64 = torch.float64
    out = {}

    def same_on_every_rank(*arrays):
        mine = [np.asarray(a) for a in arrays]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        return all(len(o) == len(mine) and all(np.array_equal(a, b) for a, b in zip(o, mine))
                   for o in every)

    class Outers:
        def __init__(self):
            self.outer = []

        def log(self, kind, **fields):
            if kind == "outer":
                self.outer.append(fields)

    for name, rows, scenarios, num_eq in EQ_MESH_CASES:
        prob = eq_mesh_instance(syn, scenarios, num_eq)
        ref = spec["ref"][name]
        tile = dict(np.load(os.path.join(spec["dir"], f"tile_{name}_{rank}.npz"),
                            allow_pickle=True))
        tile = {k: (v.item() if v.dtype == object else v) for k, v in tile.items()}
        group = mesh.groups["block"]
        dp = device_problem_from_numpy(tile, device="cpu", dtype=f64,
                                       row_shards=2 if rows else 1,
                                       col_group=None if rows else group,
                                       row_group=group if rows else None)
        part = prob.partition if rows else TS._block_partition(prob, 2).partition
        key = TEQ.op_cache_key(prob, f64, "pgd", "exact", mesh.device, mesh, rows)
        cache = {key: TEQ.EqInstance.of(
            prob, mesh.device, place=TS.MeshPlacement(dp, part, mesh, np.ndim(prob.b) == 1),
            rho_base=ref["rho_base"], L_base=ref["L_base"], LC=ref["LC"])}
        rec = Outers()
        res = bt.solve_equality_constrained(prob, mesh=mesh, shard_rows=rows, dtype=f64,
                                            op_cache=cache, metrics=rec, **EQ_MESH_ITERS)
        out.update({f"{name}.f": res.objective, f"{name}.x": res.x, f"{name}.lam": res.eq_lam,
                    f"{name}.rho": res.eq_rho, f"{name}.viol": res.eq_violation,
                    f"{name}.iterations": res.iterations,
                    f"{name}.stop": np.asarray(res.stop_reason),
                    f"{name}.outer_rho": [o["rho"] for o in rec.outer],
                    f"{name}.outer_viol": [o["viol"] for o in rec.outer],
                    f"{name}.outer_f": [np.max(o["f"]) for o in rec.outer],
                    f"{name}.same": same_on_every_rank(res.x, res.objective, res.eq_lam,
                                                       res.eq_rho, res.iterations)})

    # checkpoint at outer granularity (per-rank files, two kept) and resume;
    # one op_cache, so that the resumed outers run on the operator (and its
    # equilibration, made at the first outer's rho) of the uninterrupted run
    prob = eq_mesh_instance(syn, 2, 4)
    ck = os.path.join(spec["dir"], "eq.npz")
    kw = dict(EQ_MESH_ITERS, dtype=f64, shard_rows=True, max_iter=2000, outer_iters=4,
              op_cache={})
    full = bt.solve_equality_constrained(prob, mesh=mesh, **kw)
    bt.solve_equality_constrained(prob, mesh=mesh, checkpoint_path=ck, checkpoint_every=1,
                                  checkpoint_keep=2, **dict(kw, outer_iters=2))
    dist.barrier()
    files = sorted(f for f in os.listdir(spec["dir"]) if f.startswith("eq."))
    resumed = bt.solve_equality_constrained(prob, mesh=mesh, checkpoint_path=ck, resume=True,
                                            **kw)
    out.update({"ck.files": np.asarray(files), "full.x": full.x, "full.f": full.objective,
                "full.lam": full.eq_lam, "resumed.x": resumed.x,
                "resumed.f": resumed.objective, "resumed.lam": resumed.eq_lam,
                "full.iterations": full.iterations, "resumed.iterations": resumed.iterations,
                "resumed.same": same_on_every_rank(resumed.x, resumed.eq_lam)})
    return out


# ---------------- serving on a mesh (tests/test_torch_serving_mesh.py)

def serve_mesh_instance(syn):
    return syn.tiny_dense(seed=0, num_blocks=32, dim=4, m=128)


def queue_requests(prob, count: int = 6):
    """Single right-hand sides, in float32 as ``BatchQueue.submit`` takes them."""
    rng = np.random.default_rng(0)
    return [(np.asarray(prob.b) + 0.01 * rng.standard_normal(prob.A.shape[0])).astype(np.float32)
            for _ in range(count)]


QUEUE_ITERS = dict(tol=0.0, max_iter=100)


def _world_serve_mesh(spec):
    """Rank k of the two-rank serving world: a mesh endpoint behind a
    BatchQueue (rank 0 submits from three client threads; rank 1's queue
    follows), then the same requests as one batch on every rank, and an
    eq endpoint's two requests."""
    import threading

    import torch

    import bsls_tpu_torch as bt
    import bsls_tpu_torch.models.synthetic as syn

    mesh = bt.make_mesh(block=2, device="cpu")
    prob = serve_mesh_instance(syn)
    ep = bt.Endpoint(prob, method="pgd", chunk=50, mesh=mesh, dtype=torch.float64)
    q = bt.BatchQueue(ep, max_batch=4, max_wait_ms=50, **QUEUE_ITERS)
    bs = queue_requests(prob)
    out = {}
    if mesh.rank == 0:
        got = [None] * len(bs)

        def client(k):
            for i in range(k, len(bs), 3):
                got[i] = q.submit(bs[i]).result(timeout=120)

        threads = [threading.Thread(target=client, args=(k,)) for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        q.close(timeout=60)
        out.update({"queue.f": [r.objective for r in got], "queue.x": [r.x for r in got],
                    "queue.batches": q.batches_run, "lipschitz": ep._lip})
    else:
        try:
            q.submit(bs[0])
            refused = ""
        except RuntimeError as e:
            refused = str(e)
        q.close(timeout=120)
        assert not q._worker.is_alive() and q.requests_served == len(bs), q.requests_served
        out["refused"] = refused
    batch = ep.solve(np.stack(bs), **QUEUE_ITERS)
    out.update({"batch.f": batch.objective, "batch.x": batch.x})
    # the eq endpoint: one stacked operator for the stream; the second
    # request warm-starts from the first, the third takes the sensitivity
    # fast path (rank 0 walks, every rank returns its answer)
    eq = eq_serving_instance(syn)
    ep_eq = bt.Endpoint(eq, method="apgd", chunk=100, mesh=mesh)
    for k, (b, sens) in enumerate(eq_requests(eq)):
        r = ep_eq.solve(b, tol=1e-7, max_iter=10_000, sensitivity=sens)
        out.update({f"eq{k}.f": r.objective, f"eq{k}.viol": r.eq_violation,
                    f"eq{k}.stop": r.stop_reason, f"eq{k}.x": r.x,
                    f"eq{k}.cert": np.nan if r.refine_fw_gap is None else r.refine_fw_gap})
    out["eq.ops"] = len(ep_eq._eq_ops)
    return out


def eq_serving_instance(syn):
    return syn.traffic_like(seed=3, num_blocks=48, m=200, num_eq=8, noise=1e-3)


def eq_requests(eq):
    """(b, sensitivity) of the eq endpoint's three requests: the instance's
    b; a 0.1% perturbation with the fast path off (the AL loop, warm); a
    2% perturbation (the fast path)."""
    b0 = np.asarray(eq.b)
    b1 = b0 * (1.0 + 1e-3 * np.random.default_rng(5).standard_normal(b0.shape))
    b2 = b0 * (1.0 + 2e-2 * np.random.default_rng(2).standard_normal(b0.shape))
    return ((b0, True), (b1, False), (b2, True))


def world_child():
    """One rank of a test world: ``python -c _CHILD rank n init spec out``."""
    import json
    import sys

    import torch
    import torch.distributed as dist

    rank, n, init, spec_path, out = sys.argv[1:6]
    rank, n = int(rank), int(n)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=n)
    with open(spec_path) as fh:
        spec = json.load(fh)
    results = globals()[f"_world_{spec['case']}"](spec)
    if rank == 0 and results:
        np.savez(out, **{k: np.asarray(v) for k, v in results.items()})
    elif results and spec.get("every_rank"):
        np.savez(f"{out[:-4]}.rank{rank}.npz", **{k: np.asarray(v) for k, v in results.items()})
    dist.barrier()
    dist.destroy_process_group()


class World:
    """``n`` ranks (one process each, gloo on a ``file://`` store under
    ``tmp_path``, so test workers never share a port) running one case of
    this module.  Start it, do the reference's half meanwhile, then
    ``result()``: it waits at most ``timeout`` seconds, kills every rank on
    expiry or failure, and returns rank 0's arrays and every rank's output
    (the same, without waiting again, on a later call)."""

    def __init__(self, n, case, tmp_path, timeout=180, **spec):
        import json
        import os
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = {"case": case, "dir": str(tmp_path), **spec}
        spec_path, self.out = tmp_path / f"{case}.json", tmp_path / f"{case}.npz"
        spec_path.write_text(json.dumps(spec))
        init = tmp_path / f"{case}.init"
        code = _CHILD.format(repo=repo, tests=os.path.dirname(os.path.abspath(__file__)))
        env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE",
                                                                 "LOCAL_RANK", "MASTER_ADDR",
                                                                 "MASTER_PORT")}
        env["OMP_NUM_THREADS"] = "1"
        self.timeout = timeout
        self.procs = [
            subprocess.Popen([sys.executable, "-c", code, str(r), str(n), str(init),
                              str(spec_path), str(self.out)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=str(tmp_path), env=env)
            for r in range(n)]

    def result(self):
        if not hasattr(self, "_result"):
            self._result = self._wait()
        return self._result

    def _wait(self):
        import time

        deadline, outs = time.monotonic() + self.timeout, []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
        finally:
            self.stop()
        for r, (p, out) in enumerate(zip(self.procs, outs)):
            assert p.returncode == 0, f"rank {r} failed:\n{out[-3000:]}"
        data = dict(np.load(self.out)) if self.out.exists() else {}
        for r in range(1, len(self.procs)):  # the other ranks' arrays (spec every_rank)
            other = self.out.with_name(f"{self.out.stem}.rank{r}.npz")
            if other.exists():
                data.update({f"rank{r}.{k}": v for k, v in np.load(other).items()})
        return data, outs

    def stop(self):
        """Kill every rank still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
