"""The plain reference and the input generator against numpy at tiny sizes."""
import ast
import os

import numpy as np
import pytest
import torch

from harness import instances as I
from reference import al as RA
from reference import pgd as RP

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = dict(num_blocks=40, m=120, dim_lo=2, dim_hi=6, demand_lo=1.0, demand_hi=100.0,
              route_len_lo=2, route_len_hi=5)


def _dense(inst):
    A = np.zeros((inst.m, inst.n))
    for j in range(inst.n):
        for r, v in zip(inst.rows[j], inst.vals[j]):
            if v:
                A[r, j] += v
    return A


def test_instance_is_seeded_and_work_does_not_depend_on_the_seed():
    a, b, c = (I.make_instance(PARAMS, s) for s in (5, 5, 2**31 + 9))
    assert np.array_equal(a.rows, b.rows) and np.array_equal(a.vals, b.vals)
    assert not np.array_equal(a.rows, c.rows)
    assert sorted(a.sizes) == sorted(c.sizes) and a.nnz == c.nnz
    for inst in (a, c):
        for j in range(inst.n):  # distinct links, the active slots first
            live = inst.rows[j][inst.vals[j] != 0]
            assert len(set(live.tolist())) == live.size
            assert np.all(inst.vals[j][:live.size] != 0)


def test_planted_flows_lie_on_the_simplices_and_rowsum_is_A_x():
    inst = I.make_instance(PARAMS, 3)
    gen = torch.Generator().manual_seed(4)
    X = I.planted_flows(inst, 3, gen)
    # block sums from a running sum: float64 rounding of the running total
    assert RP.simplex_error(X.numpy(), inst.sizes) < 1e-9
    want = X.numpy() @ _dense(inst).T
    np.testing.assert_allclose(I.apply_A(inst, X).numpy(), want, rtol=0, atol=1e-12 * want.sum(1).max())


@pytest.mark.parametrize("traffic", [{"rhs": "planted", "scenarios": 1, "noise": 0.01},
                                     {"rhs": "planted", "scenarios": 3, "noise": 0.01},
                                     {"rhs": "drift", "scenarios": 4, "drift": 0.02}])
def test_requests_never_repeat_and_are_the_same_made_early_or_late(traffic):
    inst = I.make_instance(PARAMS, 2**31 + 5)
    I.plant_base(inst, {"scenarios": 4, "noise": 0.01}, 2**31 + 5, torch.device("cpu"))
    cpu, count = torch.device("cpu"), 90  # 3 rows a request cross the draws of 128
    early = I.Requests(inst, traffic, 2**31 + 5, cpu, count)
    late = I.Requests(inst, traffic, 2**31 + 5, cpu, 0)
    for i in reversed(range(count)):  # made on demand, in another order
        assert np.array_equal(late[i], early[i])
    S = traffic["scenarios"]
    assert early[0].shape == ((inst.m,) if S == 1 else (S, inst.m))
    warm = I.Requests(inst, traffic, 2**31 + 5, cpu, 4, stream=1)
    sent = [early[i] for i in range(count)] + [warm[i] for i in range(4)]
    rows = np.stack([np.ravel(r) for r in sent])
    assert len(np.unique(rows, axis=0)) == count + 4
    other = I.Requests(inst, traffic, 2**31 + 6, cpu, 1)
    assert not np.array_equal(other[0], early[0])


def test_projection_against_a_numpy_loop():
    rng = np.random.default_rng(0)
    sizes = np.array([1, 3, 2, 3, 5])
    radius = rng.uniform(0.5, 2.0, size=sizes.size)
    V = rng.standard_normal((4, sizes.sum())) * 2
    got = RP.project(torch.as_tensor(V), RP.Blocks(sizes, radius, "cpu", torch.float64)).numpy()
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    for s in range(V.shape[0]):
        for b, (o, w) in enumerate(zip(offs, sizes)):
            v = V[s, o:o + w]
            u = np.sort(v)[::-1]
            css = np.cumsum(u) - radius[b]
            k = np.nonzero(u - css / np.arange(1, w + 1) > 0)[0][-1]
            want = np.maximum(v - css[k] / (k + 1), 0)
            np.testing.assert_allclose(got[s, o:o + w], want, atol=1e-12)
            assert got[s, o:o + w].sum() == pytest.approx(radius[b])


def test_operator_products_and_power_norm_against_dense():
    inst = I.make_instance({**PARAMS, "num_eq": 4, "eq_nnz_lo": 2, "eq_nnz_hi": 5,
                            "eq_val_lo": 0.5, "eq_val_hi": 2.0}, 6)
    A = _dense(inst)
    scale = np.random.default_rng(1).uniform(0.5, 2, inst.n)
    op = RP.Operator(inst.rows, inst.vals, inst.m, scale, torch.float64, "cpu", C=inst.C)
    op.scale = 3.0
    M = np.vstack([A, 3.0 * inst.C]) / scale[None, :]
    U = np.random.default_rng(2).standard_normal((2, inst.n))
    R = np.random.default_rng(3).standard_normal((2, inst.m + 4))
    np.testing.assert_allclose(op.matvec(torch.as_tensor(U)).numpy(), U @ M.T, rtol=1e-12)
    np.testing.assert_allclose(op.rmatvec(torch.as_tensor(R)).numpy(), R @ M, rtol=1e-12)
    assert RP.power_norm(op, inst.n, 500) == pytest.approx(np.linalg.norm(M, 2) ** 2, rel=1e-6)


def test_objective_and_simplex_error():
    inst = I.make_instance(PARAMS, 7)
    X = np.full((1, inst.n), 0.0)
    X[0, inst.offsets] = 1.0
    B = np.random.default_rng(0).standard_normal((1, inst.m))
    obj = RP.Objective(inst.rows, inst.vals, inst.m, "cpu")
    r = X @ _dense(inst).T - B
    assert obj(X, B)[0] == pytest.approx(0.5 * (r * r).sum())
    assert RP.simplex_error(X, inst.sizes) == 0.0
    X[0, 0] = 1.5
    assert RP.simplex_error(X, inst.sizes) == pytest.approx(0.5)
    X[0, 0] = np.nan
    assert RP.simplex_error(X, inst.sizes) == np.inf


def test_pgd_descends_to_the_planted_flow_and_al_holds_the_constraints():
    params = {**PARAMS, "num_eq": 3, "eq_nnz_lo": 2, "eq_nnz_hi": 4, "eq_val_lo": 0.5,
              "eq_val_hi": 2.0, "scenarios": 2, "noise": 0.0}
    inst = I.make_instance(params, 8)
    I.plant_base(inst, params, 8, "cpu")
    obj = RP.Objective(inst.rows, inst.vals, inst.m, "cpu")
    X, f = RP.solve(inst.rows, inst.vals, inst.m, inst.sizes, inst.b, 400, 100, "cpu")
    assert RP.simplex_error(X, inst.sizes) < 1e-12
    np.testing.assert_allclose(f, obj(X, inst.b), rtol=1e-9)
    uniform = np.repeat(1.0 / inst.sizes, inst.sizes)[None].repeat(2, 0)
    assert np.all(obj(X, inst.b) < 1e-3 * obj(uniform, inst.b))
    x, f, viol = RA.solve_eq(inst.rows, inst.vals, inst.m, inst.sizes, inst.C, inst.b, inst.d,
                             max_iter=1200, inner_iters=400, chunk=100, eq_tol=1e-6, device="cpu")
    assert RP.simplex_error(x, inst.sizes) < 1e-12
    want = np.abs(x @ inst.C.T - inst.d).max() / max(1.0, np.abs(inst.d).max())
    assert viol == pytest.approx(want) and viol < 1e-3


@pytest.mark.parametrize("name", ["pgd.py", "al.py"])
def test_reference_imports_nothing_of_the_program(name):
    tree = ast.parse(open(os.path.join(BENCH, "reference", name)).read())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    tops = {m.split(".")[0] for m in mods}
    assert tops <= {"__future__", "math", "numpy", "torch", "pgd"}, tops
