"""The equality-constrained path of the port on a mesh against ``bsls_tpu``.

The stacked operator [A; s C] sharded by column and by row: the stacked
right-hand side's row interleaving, each rank's tile against the reference's
global arrays sliced at that rank (``torch_port_helpers.stacked_tile``), and
the per-rank partial products against the host product; a world of one
(gloo on an in-process store) against the unsharded AL loop; and two gloo
ranks (``World``) in float64 against the reference's
``solve_equality_constrained(mesh=)`` on a mesh of two of the 8 virtual CPU
devices of ``tests/conftest.py``, with the reference's tile and Lipschitz
pair carried into the port's ``op_cache`` (the two packages' power
iterations start from other vectors), then a checkpoint and a resume at
outer granularity across the two ranks.

The reference's ``inject_sharded`` casts a warm start to float32, which its
float64 mesh loop cannot take at its second outer (a scan carry of another
dtype): the float64 reference run here takes the warm start at the
problem's dtype (a patch of this test process only; float32 runs are
unchanged by it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsls_tpu.parallel.sharding as JS
import bsls_tpu.solvers.eq_constrained as JEQ
import bsls_tpu_torch as bt
from bsls_tpu.models import synthetic as jsyn
from bsls_tpu.models.problem import Problem as JProblem
from bsls_tpu.models.problem import ScaledMatrix as JScaled
from bsls_tpu.models.problem import VStackMatrix as JVStack
from bsls_tpu.parallel import make_mesh as jmesh
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.models.problem import ScaledMatrix, VStackMatrix
from bsls_tpu_torch.ops import layout as TL
from bsls_tpu_torch.parallel import mesh as TM
from bsls_tpu_torch.parallel import sharding as TS
from torch_port_helpers import (EQ_MESH_CASES, EQ_MESH_ITERS, World, eq_mesh_instance,
                                flatten_device_problem, stacked_tile)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# float64 on both sides, the same stacked tiles and Lipschitz pair: the AL
# traces agree to the rounding of sums taken in another order
F64_RTOL = 1e-9
X_ATOL = 1e-8


def rank_view(block: int, k: int) -> TM.Mesh:
    """Rank k of a block-``block`` mesh, without process groups."""
    return TM.Mesh(shape={"row": 1, "block": block, "scenario": 1},
                   coords={"row": 0, "block": k, "scenario": 0},
                   groups=dict.fromkeys(TM.AXES), device=torch.device("cpu"), device_mesh=None)


def _stacked(pkg_matrix, prob, scale=1.7):
    """The stacked problem [A; scale C] with the right-hand side [b; d]."""
    VS, SC, P = pkg_matrix
    b = np.atleast_2d(np.asarray(prob.b, np.float64))
    d = np.broadcast_to(np.asarray(prob.d, np.float64), (b.shape[0], prob.C.shape[0]))
    return P(A=VS(top=prob.A, bottom=SC(prob.C, scale)), b=np.concatenate([b, d], axis=1),
             partition=prob.partition)


PORT = (VStackMatrix, ScaledMatrix, bt.Problem)
REF = (JVStack, JScaled, JProblem)


@pytest.mark.parametrize("nr,m,p,S", [(8, 60, 4, 1), (4, 64, 10, 3), (2, 7, 1, 2)])
def test_interleave_stacked_rows_matches_reference(nr, m, p, S):
    rng = np.random.default_rng(0)
    b_top, b_bot = rng.standard_normal((S, m)), rng.standard_normal((S, p))
    got = TS.interleave_stacked_rows(b_top, b_bot, nr)
    np.testing.assert_array_equal(got, JS.interleave_stacked_rows(b_top, b_bot, nr))
    ml, pl = -(-m // nr), -(-p // nr)
    seg = got.reshape(S, nr, ml + pl)
    np.testing.assert_array_equal(seg[:, :, :ml].reshape(S, -1)[:, :m], b_top)
    np.testing.assert_array_equal(seg[:, :, ml:].reshape(S, -1)[:, :p], b_bot)


def _reference_tiles(prob_j, rows: bool, nr: int) -> dict:
    mesh = jmesh(block=nr, scenario=1, devices=jax.devices()[:nr])
    with jax.enable_x64(True):
        stacked = _stacked(REF, prob_j)
        if rows:
            dp, _ = JS.shard_problem_rows(stacked, mesh, dtype=jnp.float64)
        else:
            dp, _ = JS.shard_problem(stacked, mesh, dtype=jnp.float64)
        return flatten_device_problem(jax.tree_util.tree_map(np.asarray, dp))


# (name, shard_rows, block shards, rows of C): p < nr pads C's rows
TILES = [("col", False, 4, 3), ("rows_p_below_nr", True, 4, 3), ("rows", True, 2, 5)]


@pytest.mark.parametrize("name,rows,nr,p", TILES, ids=[t[0] for t in TILES])
def test_stacked_tiles_match_reference_and_sum_to_the_product(name, rows, nr, p):
    """Each rank's tile equals the reference's global arrays sliced at that
    rank (float64, to the bit but for the rounding of the equilibration);
    the ranks' partial products of the stacked operator sum (by column) or
    stack (by row, in the interleaved row order) to the host product."""
    pt = tsyn.traffic_like(seed=0, num_blocks=12, m=58, num_eq=p)
    pj = jsyn.traffic_like(seed=0, num_blocks=12, m=58, num_eq=p)
    ref = _reference_tiles(pj, rows, nr)
    stacked = _stacked(PORT, pt)
    host = stacked.A
    rng = np.random.default_rng(1)
    x = rng.random(pt.partition.n_flat)
    r = rng.standard_normal(host.shape[0])
    y_want, g_want = host.matvec(x), host.rmatvec(r)
    m_top = pt.A.shape[0]
    r_dev = TS.interleave_stacked_rows(r[None, :m_top], r[None, m_top:], nr)[0] if rows else r
    ys, g = [], 0.0
    for k in range(nr):
        view = rank_view(nr, k)
        if rows:
            dp, _ = TS.shard_problem_rows(stacked, view, dtype=torch.float64)
        else:
            dp, _ = TS.shard_problem(stacked, view, dtype=torch.float64)
        assert isinstance(dp.A, TL.DeviceVStack) and isinstance(dp.A.bottom, TL.DeviceDense)
        got, want = flatten_device_problem(dp), stacked_tile(ref, rows, k, nr)
        assert sorted(got) == sorted(want)
        assert got["A.split"] == want["A.split"] // (nr if rows else 1)
        for key, a in want.items():
            if key == "A.split":
                continue
            if isinstance(a, np.ndarray):
                assert got[key].shape == a.shape, (key, got[key].shape, a.shape)
                np.testing.assert_allclose(got[key], a, rtol=1e-15, atol=0, err_msg=key)
            else:
                assert got[key] == a, key
        u = TL.padded_to_flat(dp, TL.inject_user_flat(dp, torch.as_tensor(x)[None]))
        ys.append(TL.matvec(dp.A, u)[0].numpy())
        want_g = TL.inject_user_grad(dp, torch.as_tensor(g_want)[None])[0].numpy()
        if rows:  # A^T r: the rank's partial from its own segment of r
            seg = len(r_dev) // nr
            g = g + TL.rmatvec(dp.A, torch.as_tensor(r_dev[k * seg:(k + 1) * seg])[None])[0]
        else:  # A^T r is block-local: the rank's columns of it
            gk = TL.rmatvec(dp.A, torch.as_tensor(r)[None])[0].numpy()
            np.testing.assert_allclose(gk, want_g, rtol=1e-12, atol=1e-12 * np.abs(g_want).max())
    if rows:
        # each rank's local [top_k; bottom_k] rows, back to [top; bottom]
        mt = -(-m_top // nr)
        seg = np.stack(ys)
        y = np.concatenate([seg[:, :mt].ravel()[:m_top], seg[:, mt:].ravel()[:p]])
        assert not seg[:, :mt].ravel()[m_top:].any() and not seg[:, mt:].ravel()[p:].any()
        np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-12,
                                   atol=1e-12 * np.abs(g_want).max())
    else:  # the full-height partials sum over the column shards
        y = np.sum(ys, axis=0)
    np.testing.assert_allclose(y, y_want, rtol=1e-12, atol=1e-12 * np.abs(y_want).max())


@pytest.fixture(scope="module")
def world_of_one():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bt.init_distributed("gloo")
    yield bt.make_mesh(block=1, device="cpu")
    torch.set_num_threads(threads)


def _with_constants(cache, entry):
    """``cache``'s one entry with the Lipschitz pair of ``entry``."""
    (key, mine), = cache.items()
    cache[key] = dataclasses.replace(mine, rho_base=entry.rho_base, L_base=entry.L_base,
                                     LC=entry.LC)
    return cache


@pytest.mark.parametrize("rows", [False, True], ids=["col", "rows"])
def test_world_of_one_equals_the_unsharded_eq_solve(world_of_one, rows):
    """float64, S = 3, the unsharded loop's Lipschitz pair in the mesh's
    op_cache: the same outers, rho, multipliers and x."""
    prob = eq_mesh_instance(tsyn, 3, 4)
    kw = dict(EQ_MESH_ITERS, dtype=torch.float64)
    plain = {}
    want = bt.solve_equality_constrained(prob, device="cpu", op_cache=plain, **kw)
    cache = {}
    bt.solve_equality_constrained(prob, mesh=world_of_one, shard_rows=rows, op_cache=cache,
                                  **dict(kw, max_iter=1))
    (entry,) = plain.values()
    got = bt.solve_equality_constrained(prob, mesh=world_of_one, shard_rows=rows,
                                        op_cache=_with_constants(cache, entry), **kw)
    assert got.iterations == want.iterations and got.stop_reason == want.stop_reason
    np.testing.assert_allclose(got.objective, want.objective, rtol=F64_RTOL)
    np.testing.assert_allclose(got.x, want.x, atol=X_ATOL)
    np.testing.assert_allclose(got.eq_lam, want.eq_lam, rtol=1e-7, atol=1e-9)
    assert got.eq_rho == want.eq_rho
    assert got.eq_violation == pytest.approx(want.eq_violation, rel=1e-6)


def test_mesh_eq_rejections(world_of_one):
    """As the reference: shard_rows needs a mesh, and the loop does not run
    on a 2-D grid; a stacked problem refuses the band."""
    prob = eq_mesh_instance(tsyn, 1, 4)
    with pytest.raises(ValueError, match="mesh"):
        bt.solve_equality_constrained(prob, device="cpu", shard_rows=True)
    grid = TM.Mesh(shape={"row": 2, "block": 1, "scenario": 1},
                   coords=dict.fromkeys(TM.AXES, 0), groups=dict.fromkeys(TM.AXES),
                   device=torch.device("cpu"), device_mesh=None)
    with pytest.raises(ValueError, match="2-D grid"):
        bt.solve_equality_constrained(prob, mesh=grid)
    with pytest.raises(ValueError, match="banded"):
        TS.shard_problem(_stacked(PORT, prob), world_of_one, layout="banded")
    with pytest.raises(ValueError, match="lipschitz"):
        TS.solve_sharded(prob, world_of_one, lipschitz=1.0)


_REF_INJECT = JS.inject_sharded


def _inject_at_dtype(dp, part, x_user, mesh):
    """The reference's inject_sharded with the warm start at the problem's
    dtype (it casts to float32)."""
    out = _REF_INJECT(dp, part, np.zeros_like(np.asarray(x_user)), mesh)
    x = np.atleast_2d(np.asarray(x_user, np.float64))
    got = []
    for b, bk, o in zip(part.buckets, dp.buckets, out):
        arr = np.zeros(o.shape)
        m = b.mask.astype(bool)
        vals = x[:, b.pad_to_flat] * JS._radius_host(bk)[None, :, None]
        arr[:, m] = vals[:, m]
        got.append(jax.device_put(jnp.asarray(arr, dp.b.dtype), o.sharding))
    return tuple(got)


class Outers:
    def __init__(self):
        self.outer = []

    def log(self, kind, **fields):
        if kind == "outer":
            self.outer.append(fields)


@pytest.fixture(scope="module")
def eq_world(tmp_path_factory):
    """The reference's float64 mesh loops first (their stacked tiles and
    Lipschitz pairs are what the ranks carry), then the two-rank world."""
    tmp = tmp_path_factory.mktemp("eq_mesh")
    refs, spec = {}, {}
    mesh = jmesh(block=2, scenario=1, devices=jax.devices()[:2])
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JS, "inject_sharded", _inject_at_dtype)
        for name, rows, scenarios, num_eq in EQ_MESH_CASES:
            cache, rec = {}, Outers()
            res = JEQ.solve_equality_constrained(
                eq_mesh_instance(jsyn, scenarios, num_eq), mesh=mesh, shard_rows=rows,
                dtype=jnp.float64, op_cache=cache, metrics=rec, **EQ_MESH_ITERS)
            ((dp_sh, _, _), rho_base, L_base, LC), = cache.values()
            flat = flatten_device_problem(jax.tree_util.tree_map(np.asarray, dp_sh))
            for k in range(2):
                np.savez(tmp / f"tile_{name}_{k}.npz", **{
                    key: np.asarray(v, dtype=object if v is None else None)
                    for key, v in stacked_tile(flat, rows, k, 2).items()})
            spec[name] = {"rho_base": float(rho_base), "L_base": float(L_base),
                          "LC": float(LC)}
            refs[name] = (res, rec.outer)
    world = World(2, "eq_mesh", tmp, timeout=240, ref=spec)
    yield world, refs
    world.stop()


@pytest.mark.parametrize("name", [c[0] for c in EQ_MESH_CASES])
def test_two_ranks_match_the_reference_in_float64(eq_world, name):
    """By column (S = 1, p = 4) and by row (S = 2, p = 1 < 2 ranks): every
    outer's rho, violation and objective, and the final x, multipliers,
    objective and stop as the reference's; both ranks return the same
    bits."""
    world, refs = eq_world
    got, _ = world.result()
    ref, outers = refs[name]
    assert bool(got[f"{name}.same"])
    assert int(got[f"{name}.iterations"]) == int(ref.iterations)
    assert str(got[f"{name}.stop"]) == ref.stop_reason
    assert len(got[f"{name}.outer_rho"]) == len(outers) >= 2
    np.testing.assert_allclose(got[f"{name}.outer_rho"], [o["rho"] for o in outers],
                               rtol=1e-12)
    np.testing.assert_allclose(got[f"{name}.outer_viol"], [o["viol"] for o in outers],
                               rtol=1e-5)
    np.testing.assert_allclose(got[f"{name}.outer_f"], [np.max(o["f"]) for o in outers],
                               rtol=F64_RTOL)
    np.testing.assert_allclose(got[f"{name}.f"], np.asarray(ref.objective), rtol=F64_RTOL)
    np.testing.assert_allclose(got[f"{name}.x"], np.asarray(ref.x), rtol=F64_RTOL,
                               atol=X_ATOL)
    lam = np.asarray(ref.eq_lam)
    np.testing.assert_allclose(got[f"{name}.lam"], lam, rtol=1e-6,
                               atol=1e-6 * np.abs(lam).max())
    assert float(got[f"{name}.rho"]) == pytest.approx(ref.eq_rho, rel=1e-12)
    assert float(got[f"{name}.viol"]) == pytest.approx(ref.eq_violation, rel=1e-5, abs=1e-14)


def test_two_rank_checkpoint_and_resume(eq_world):
    """Outer-granularity checkpoints on a row-sharded mesh: one file per
    rank and outer (two kept), and a run resumed from the second outer
    equals the uninterrupted one to the bit, on both ranks."""
    world, _ = eq_world
    got, _ = world.result()
    assert list(got["ck.files"]) == [f"eq.it{it:09d}.proc{r}.npz" for it in (1, 2)
                                     for r in (0, 1)]
    assert bool(got["resumed.same"])
    assert int(got["resumed.iterations"]) == int(got["full.iterations"])
    np.testing.assert_array_equal(got["resumed.x"], got["full.x"])
    np.testing.assert_array_equal(got["resumed.f"], got["full.f"])
    np.testing.assert_array_equal(got["resumed.lam"], got["full.lam"])
