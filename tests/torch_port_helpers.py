"""Shared helpers of the tests/test_torch_*.py files: flatten the device
objects of both packages to dictionaries of numpy arrays (the only thing that
crosses between them) and build the small seeded instances the tests use."""
import numpy as np

# every hand-written kernel of the port, under the name its wrapper counts
KERNELS = ("proj_simplex_rows", "pava_rows", "band_zmv", "band_grmv", "pgd_chunk")


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
        return data, outs

    def stop(self):
        """Kill every rank still running."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
