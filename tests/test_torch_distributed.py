"""The port on meshes of several processes: gloo worlds of 2 and 4 ranks.

Each world is spawned processes on a ``file://`` store (``World`` in
``torch_port_helpers.py``: one thread per rank, a wall-clock limit, every
rank killed on expiry or failure).  While the ranks run, the test runs the
reference's ``solve_sharded`` on a mesh of 4 of the 8 virtual CPU devices of
``tests/conftest.py`` with the same Lipschitz constant, then holds the two:
float64 to 1e-9 relative, float32 at the tolerances the reference's own
``tests/test_sharding.py`` uses (5e-4 for pgd, apgd and lbfgs; 2e-2 for eg,
the Frank-Wolfe pair and the BB-stepped pava, whose fp32 trajectories
depend on the order of the sums).  The families' and the layouts' worlds
solve in both dtypes once per module and worker.
"""
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu_torch as bt
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu.parallel import make_mesh as jmesh
from bsls_tpu.parallel import solve_sharded as jsolve_sharded
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.solvers import base as TB
from torch_port_helpers import DTYPES, FAMILIES, LAYOUTS, WORLD_ITERS, World, mesh_instance
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

F32_RTOL = {"pgd": 5e-4, "apgd": 5e-4, "lbfgs": 5e-4, "eg": 2e-2, "frank_wolfe": 2e-2,
            "afw": 2e-2, "rows_dense": 5e-4, "rows_ell": 5e-4, "grid": 5e-4, "banded": 5e-4,
            "pava": 2e-2}


def lipschitz(kind, z=False):
    """One estimate for both packages (the port's, unsharded, in float64)."""
    dp = bt.prepare(mesh_instance(tsyn, kind), device="cpu", dtype=torch.float64,
                    layout="gather")
    return (TB.power_lipschitz_z if z else TB.power_lipschitz)(dp)


def _ref(prob, shape, f64, **kw):
    size = int(np.prod(list(shape.values())))
    mesh = jmesh(devices=jax.devices()[:size], **shape)
    with jax.enable_x64(f64):
        return jsolve_sharded(prob, mesh, dtype=jnp.float64 if f64 else jnp.float32, **kw)


def _hold(got, name, ref, f64):
    rtol = 1e-9 if f64 else F32_RTOL[name]
    key = f"{'float64' if f64 else 'float32'}.{name}"
    f, want = got[f"{key}.f"], np.asarray(ref.objective)
    assert f.shape == want.shape and np.all(np.isfinite(f)), key
    np.testing.assert_allclose(f, want, rtol=rtol, atol=1e-12, err_msg=key)
    np.testing.assert_allclose(got[f"{key}.trace"], ref.trace_f, rtol=rtol, atol=1e-12,
                               err_msg=key)
    if f64:
        np.testing.assert_allclose(got[f"{key}.x"], ref.x, atol=1e-8, err_msg=key)


# one world per module and worker solves in both dtypes; each dtype's case
# holds its half against the reference run meanwhile
@pytest.fixture(scope="module")
def families_world(tmp_path_factory):
    L = lipschitz("uniform")
    world = World(4, "families", tmp_path_factory.mktemp("families"), L={"uniform": L})
    yield world, L
    world.stop()


@pytest.fixture(scope="module")
def layouts_world(tmp_path_factory):
    L = {name: lipschitz(kind, z=kw.get("line_search") == "pava")
         for name, kind, _, kw in LAYOUTS}
    world = World(4, "layouts", tmp_path_factory.mktemp("layouts"), L=L)
    yield world, L
    world.stop()


@pytest.mark.parametrize("dtype", DTYPES)
def test_families_block2_scenario2_match_reference(dtype, families_world):
    f64 = dtype == "float64"
    world, L = families_world
    pj = mesh_instance(jsyn, "uniform")
    refs = {m: _ref(pj, dict(block=2, scenario=2), f64, method=m, lipschitz=L, **WORLD_ITERS)
            for m in FAMILIES}
    got, _ = world.result()
    for method in FAMILIES:
        _hold(got, method, refs[method], f64)
        assert got[f"{dtype}.{method}.x"].shape == (4, pj.partition.n_flat)


def _unsharded_f32(name, kind, kw, L, got):
    """The port's unsharded float32 solve, its objective and trace shaped as
    the mesh keeps them (a scenario axis for one right-hand side too)."""
    kw = {k: v for k, v in kw.items() if k != "shard_rows"}
    r = bt.solve(mesh_instance(tsyn, kind), device="cpu", dtype=torch.float32, lipschitz=L,
                 **kw, **WORLD_ITERS)
    key = f"float32.{name}"
    return SimpleNamespace(objective=np.reshape(r.objective, got[f"{key}.f"].shape),
                           trace_f=np.reshape(r.trace_f, got[f"{key}.trace"].shape))


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_grid_banded_and_pava_layouts_match_reference(dtype, layouts_world):
    """Row sharding of dense (rows padded) and ELL A, the 2-D grid, the
    group-sharded band with a residual, and line_search="pava" (z-space
    curvature).  float64 against the reference's solve_sharded; float32
    against the port's unsharded float32 solve, at the tolerances the
    reference's own tests/test_sharding.py holds its sharded fp32 solve to
    its single-device one (the port's unsharded fp32 solve is held against
    the reference's in the single-device tests; the reference's fp32
    compiles of five layouts cost about 20 s)."""
    f64 = dtype == "float64"
    world, L = layouts_world
    if f64:
        refs = {name: _ref(mesh_instance(jsyn, kind), shape, True, lipschitz=L[name], **kw,
                           **WORLD_ITERS)
                for name, kind, shape, kw in LAYOUTS}
    got, _ = world.result()
    for name, kind, _, kw in LAYOUTS:
        ref = refs[name] if f64 else _unsharded_f32(name, kind, kw, L[name], got)
        _hold(got, name, ref, f64)


def test_checkpoint_resume_across_two_ranks(tmp_path):
    """Per-rank files (rotated, keep=2), the resume point agreed by all
    ranks: the resumed run equals the uninterrupted one; another mesh shape
    refuses the checkpoint on every rank; a rank without its newest file
    sends every rank back to the newest iteration all hold; a rank that
    cannot read its file makes every rank raise."""
    world = World(2, "checkpoint", tmp_path, L={"uniform": lipschitz("uniform")})
    got, _ = world.result()
    assert list(got["files"]) == [f"ck.it{it:09d}.proc{r}.npz" for it in (10, 20)
                                  for r in (0, 1)]
    assert int(got["resumed.iterations"]) == 30 and got["resumed.trace"].shape == (4, 10)
    np.testing.assert_array_equal(got["resumed.f"], got["full.f"])
    np.testing.assert_array_equal(got["resumed.x"], got["full.x"])
    assert "mesh" in str(got["refused"]), got["refused"]
    assert got["older.trace"].shape == (4, 20)
    np.testing.assert_array_equal(got["older.f"], got["full.f"])
    assert "rank 1" in str(got["unreadable"]), got["unreadable"]


def test_mesh_refine_reaches_the_oracle(tmp_path):
    """The gathered result polished on the host: never worse than the
    unrefined point, and at the float64 oracle within the single-device
    refine test's tolerance."""
    world = World(2, "refine", tmp_path)
    prob = mesh_instance(tsyn, "refine")
    fs = bt.oracle_solve(prob, tol_gap=1e-11, max_iter=30000).objective
    got, _ = world.result()
    f0, f1 = float(got["f0"]), float(got["f1"])
    assert f1 <= f0 + 1e-12
    assert (f1 - fs) / max(fs, 1e-30) < 1e-6, (f1, f0, fs)
    x = got["x1"]
    off = np.concatenate([[0], np.cumsum(prob.partition.sizes)])[:-1]
    assert x.min() >= 0
    np.testing.assert_allclose(np.add.reduceat(x, off), 1.0, atol=1e-9)


def test_dryrun_multichip_four_cpu_ranks():
    from bsls_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, device="cpu", timeout=240)
    report = out["cases"]
    assert set(out["launches"]) >= {"proj_simplex_rows", "pava_rows", "band_zmv"}
    assert not any(out["launches"].values())  # CPU tensors take the plain versions
    assert set(report) == {*FAMILIES, "pava", "3-chunk", "checkpoint-resume", "ragged",
                           "row-sharded dense", "row-sharded ELL", "2-D grid",
                           "sharded banded", "eq-constrained", "eq-constrained rows",
                           "eq-constrained+refine"}
    assert max(report.values()) <= 1e-4


def test_cli_under_two_ranks(tmp_path):
    """--mesh-block 2 over a world of two: rank 0 prints the one result
    line, with the mesh, and the answer of the unsharded CLI."""
    argv = ["--config", "tiny", "--mesh-block", "2", "--device", "cpu", "--max-iter", "200"]
    world = World(2, "cli", tmp_path, argv=argv)
    from bsls_tpu_torch.cli import main

    want = main(["--config", "tiny", "--device", "cpu", "--max-iter", "200"])
    _, outs = world.result()
    lines = [[ln for ln in out.splitlines() if ln.startswith("{")] for out in outs]
    assert len(lines[0]) == 1 and not lines[1], outs
    got = json.loads(lines[0][0])
    assert got["mesh"] == {"row": 1, "block": 2, "scenario": 1} and got["n_devices"] == 2
    assert got["iterations"] == 200 and got["layout"] == "gather"
    np.testing.assert_allclose(got["objective"], want["objective"], rtol=1e-5)
