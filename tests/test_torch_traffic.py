"""The grid-network route-flow generator of the PyTorch port (config
"traffic", ``models/traffic.py``) against ``bsls_tpu``'s: the same seed gives
the same arrays, bit for bit; and the preset ``traffic`` through the port's
CLI on the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bsls_tpu.models import synthetic as jsyn
from bsls_tpu.models import traffic as jtr
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.models import traffic as ttr
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the CLI child's float64 host work in one BLAS thread (see test_torch_package.py)
ONE_BLAS_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _same_problem(pt, pj):
    """Every array of two instances equal, bit for bit."""
    assert pt.name == pj.name
    np.testing.assert_array_equal(pt.partition.sizes, pj.partition.sizes)
    np.testing.assert_array_equal(pt.A.rows, pj.A.rows)
    np.testing.assert_array_equal(pt.A.vals, pj.A.vals)
    assert pt.A.num_rows == pj.A.num_rows
    np.testing.assert_array_equal(pt.b, pj.b)
    np.testing.assert_array_equal(pt.x_true, pj.x_true)
    if pj.C is None:
        assert pt.C is None and pt.d is None
    else:
        np.testing.assert_array_equal(pt.C.data, pj.C.data)
        np.testing.assert_array_equal(pt.d, pj.d)


@pytest.mark.parametrize("kw", [dict(nx=8, ny=8, num_od=40), {},
                                dict(nx=6, ny=5, num_od=25, num_eq=0, sensor_frac=0.6)],
                         ids=["8x8", "defaults", "sensors"])
def test_grid_traffic_arrays_equal_the_reference(kw):
    _same_problem(ttr.grid_traffic(seed=1, **kw), jtr.grid_traffic(seed=1, **kw))


def test_make_config_traffic_is_the_grid_instance():
    pt = tsyn.make_config("traffic", seed=0, nx=8, ny=8, num_od=40)
    _same_problem(pt, jsyn.make_config("traffic", seed=0, nx=8, ny=8, num_od=40))
    assert pt.C.shape == (40, pt.partition.n_flat)
    # the planted flow is feasible: on the simplices and on C x = d
    offs = np.concatenate([[0], np.cumsum(pt.partition.sizes)[:-1]])
    np.testing.assert_allclose(np.add.reduceat(pt.x_true, offs), 1.0, atol=1e-12)
    np.testing.assert_allclose(pt.C.matvec(pt.x_true), pt.d, rtol=1e-12)


def test_grid_network_and_routes_equal_the_reference():
    nt, et, adj_t = ttr.grid_network(6, 7)
    nj, ej, adj_j = jtr.grid_network(6, 7)
    assert nt == nj and adj_t == adj_j
    np.testing.assert_array_equal(et, ej)
    rt = ttr.k_routes(adj_t, len(et), 0, 41, 5, np.random.default_rng(3))
    rj = jtr.k_routes(adj_j, len(ej), 0, 41, 5, np.random.default_rng(3))
    assert rt == rj and len(rt) >= 1
    w = np.random.default_rng(4).uniform(1.0, 2.0, size=len(et))
    assert ttr._dijkstra_path(adj_t, w, 3, 38) == jtr._dijkstra_path(adj_j, w, 3, 38)


def test_cli_traffic_prints_eq_violation(tmp_path):
    """The preset's instance through the CLI on the CPU: the augmented-
    Lagrangian loop on the gather layout, with the violation on the line."""
    proc = subprocess.run(
        [sys.executable, "-m", "bsls_tpu_torch", "--preset", "traffic", "--device", "cpu",
         "--max-iter", "300"],
        cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "BSLS_CACHE_DIR": str(tmp_path), **ONE_BLAS_THREAD})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["config"] == "traffic" and out["method"] == "lbfgs"
    assert out["layout"] == "gather" and out["device"] == "cpu"
    # the total inner budget binds: 300 iterations, no more
    assert out["iterations"] == 300 and not out["converged"]
    assert 0.0 < out["eq_violation"] < 1.0 and np.isfinite(out["objective"])
