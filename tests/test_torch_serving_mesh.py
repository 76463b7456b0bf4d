"""Serving on a mesh: ``Endpoint(mesh=)`` of both kinds and ``BatchQueue``
over it, held against the port's unsharded endpoints (which
tests/test_torch_serving.py holds against ``bsls_tpu.serving``), after the
reference's own mesh serving tests (tests/test_serving.py).

A world of one (gloo on an in-process store) serves a queue in this process;
two gloo ranks (``World``) serve a queue whose batches rank 0 alone
composes, a mesh endpoint's batch, and an eq endpoint's stream of three
requests, while this process answers the same requests unsharded.  The
command line runs an eq instance on two ranks.
"""
import json

import numpy as np
import pytest
import torch

import bsls_tpu_torch as bt
from bsls_tpu_torch.models import synthetic as tsyn
from bsls_tpu_torch.parallel import mesh as TM
from torch_port_helpers import (QUEUE_ITERS, World, eq_requests, eq_serving_instance,
                                queue_requests, serve_mesh_instance)
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

# float64, one Lipschitz constant: a request and the same scenario in
# another batch, or on the unsharded endpoint, part by rounding only
F64_RTOL = 1e-9


@pytest.fixture(scope="module")
def world_of_one():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    bt.init_distributed("gloo")
    yield bt.make_mesh(block=1, device="cpu")
    torch.set_num_threads(threads)


def test_batch_queue_over_a_mesh_endpoint_world_of_one(world_of_one):
    """Requests coalesce onto the scenario axis of a mesh endpoint; each
    answer is that request's solve on the same endpoint."""
    prob = serve_mesh_instance(tsyn)
    ep = bt.Endpoint(prob, method="pgd", chunk=50, mesh=world_of_one, dtype=torch.float64)
    q = bt.BatchQueue(ep, max_batch=8, max_wait_ms=200, **QUEUE_ITERS)
    bs = queue_requests(prob, 3)
    results = [f.result(timeout=120) for f in [q.submit(b) for b in bs]]
    q.close()
    assert not q._worker.is_alive() and q.requests_served == 3
    for b, r in zip(bs, results):
        solo = ep.solve(b, **QUEUE_ITERS)
        assert r.x.shape == (prob.partition.n_flat,)
        np.testing.assert_allclose(r.objective, solo.objective, rtol=F64_RTOL)


def test_mesh_endpoint_rejects_a_width_the_scenario_axis_does_not_divide():
    """A rank of a scenario-2 mesh (its view, no process group)."""
    view = TM.Mesh(shape={"row": 1, "block": 1, "scenario": 2},
                   coords=dict.fromkeys(TM.AXES, 0), groups=dict.fromkeys(TM.AXES),
                   device=torch.device("cpu"), device_mesh=None)
    prob = tsyn.with_scenarios(serve_mesh_instance(tsyn), 2, seed=1)
    ep = bt.Endpoint(prob, method="pgd", mesh=view)
    assert ep._lip > 0 and ep._dp.b.shape[0] == 1  # this rank's half of S = 2
    for b in (np.asarray(prob.b)[0], np.concatenate([prob.b, prob.b[:1]])):
        with pytest.raises(ValueError, match="scenario axis"):
            ep.solve(b)


@pytest.fixture(scope="module")
def serve_world(tmp_path_factory):
    world = World(2, "serve_mesh", tmp_path_factory.mktemp("serve_mesh"), timeout=240,
                  every_rank=True)
    yield world
    world.stop()


def test_batch_queue_and_mesh_endpoint_across_two_ranks(serve_world):
    """Rank 0 composes the batches (rank 1's submit raises, its queue stops
    when rank 0 closes): every queued answer is that scenario of one batched
    solve of all requests, which both ranks return to the bit and which the
    unsharded endpoint gives with the mesh endpoint's Lipschitz constant."""
    prob = serve_mesh_instance(tsyn)
    bs = queue_requests(prob)
    got, _ = serve_world.result()
    assert "rank 0" in str(got["rank1.refused"])
    assert 1 <= int(got["queue.batches"]) <= len(bs)
    np.testing.assert_array_equal(got["rank1.batch.f"], got["batch.f"])
    np.testing.assert_allclose(got["queue.f"], got["batch.f"], rtol=F64_RTOL)
    np.testing.assert_allclose(got["queue.x"], got["batch.x"], atol=1e-9)
    ep = bt.Endpoint(prob, method="pgd", chunk=50, device="cpu", dtype=torch.float64)
    want = ep.solve(np.stack(bs), lipschitz=float(got["lipschitz"]), **QUEUE_ITERS)
    np.testing.assert_allclose(got["batch.f"], want.objective, rtol=F64_RTOL)
    np.testing.assert_allclose(got["batch.x"], want.x, atol=1e-9)


def test_eq_mesh_endpoint_across_two_ranks(serve_world):
    """One sharded stacked operator for the stream; the answers are those
    of the unsharded eq endpoint at the reference's tolerance (its own mesh
    test: rtol 1e-4, 1e-7 absolute at the fp32 floor); the third request
    takes the sensitivity fast path on both ranks."""
    eq = eq_serving_instance(tsyn)
    ep = bt.Endpoint(eq, method="apgd", chunk=100, device="cpu")
    want = [ep.solve(b, tol=1e-7, max_iter=10_000, sensitivity=s) for b, s in eq_requests(eq)]
    got, _ = serve_world.result()
    assert int(got["eq.ops"]) == 1
    for k, w in enumerate(want):
        for rank in ("", "rank1."):
            assert str(got[f"{rank}eq{k}.stop"]) == w.stop_reason
            np.testing.assert_array_equal(got[f"{rank}eq{k}.x"], got[f"eq{k}.x"])
        np.testing.assert_allclose(float(got[f"eq{k}.f"]), float(w.objective), rtol=1e-4,
                                   atol=1e-7)
        # the reference's mesh-against-single bound (tests/test_sharding.py)
        assert float(got[f"eq{k}.viol"]) <= max(1e-6, 3 * w.eq_violation)
    assert str(got["eq2.stop"]) == "sensitivity"
    assert float(got["eq2.viol"]) <= 1e-7 and float(got["eq2.cert"]) <= 1e-6


def test_cli_eq_instance_on_two_ranks(tmp_path):
    """--mesh-block 2 of an equality-constrained instance (the preset
    ``traffic`` on an 8 x 8 grid): rank 0 prints the one line, with the mesh
    and ``eq_violation``, converged as the unsharded command is.  Their
    objectives are held at 1e-2 relative: the fp32 L-BFGS traces part where
    sums run in another order and each AL loop stops where its violation
    first holds (2.3e-3 apart here); the mesh loop is held to the bit-level
    elsewhere (tests/test_torch_eq_mesh.py, float64)."""
    preset = tmp_path / "traffic8.json"
    preset.write_text(json.dumps({"config": "traffic", "method": "lbfgs", "instance_kwargs": {
        "nx": 8, "ny": 8, "num_od": 40, "num_eq": 8}}))
    argv = ["--preset", str(preset), "--device", "cpu"]
    world = World(2, "cli", tmp_path, argv=argv + ["--mesh-block", "2"])
    from bsls_tpu_torch.cli import main

    want = main(argv)
    _, outs = world.result()
    lines = [[ln for ln in out.splitlines() if ln.startswith("{")] for out in outs]
    assert len(lines[0]) == 1 and not lines[1], outs
    got = json.loads(lines[0][0])
    assert got["mesh"] == {"row": 1, "block": 2, "scenario": 1} and got["n_devices"] == 2
    assert got["converged"] and want["converged"]
    assert got["eq_violation"] <= 1e-6 and want["eq_violation"] <= 1e-6
    np.testing.assert_allclose(got["objective"], want["objective"], rtol=1e-2)
