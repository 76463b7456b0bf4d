"""The PyTorch port stands alone: it imports nothing of JAX or of the JAX
package, runs on the CPU only when asked to, refuses what is not ported, and
its CLI prints the result line."""
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from torch_port_helpers import KERNELS
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the float64 host work of a CLI child (oracles, the AL multiplier update) in
# one BLAS thread: beside the other test workers a multi-threaded BLAS spins
# against them and runs many times slower
ONE_BLAS_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
PKG = os.path.join(REPO, "bsls_tpu_torch")


def _python_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def _modules():
    mods = []
    for path in _python_sources():
        if not path.startswith(PKG):
            continue
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(m for m in mods if not m.endswith("__main__"))


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'jaxlib' or m == 'bsls_tpu' or m.startswith('bsls_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert len(_modules()) >= 27
    for new in ("ops.banded", "ops.pagekernels", "ops.chunkkernel", "ops.cudalib",
                "solvers.mega", "models.reorder"):
        assert f"bsls_tpu_torch.{new}" in _modules()


def test_importing_every_module_touches_no_cuda_and_builds_nothing():
    code = (
        "import importlib, os, sys, torch\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from bsls_tpu_torch.ops import cudalib\n"
        "assert cudalib._lib is None, 'the kernel library was loaded at import'\n"
        "assert not torch.cuda.is_initialized(), 'CUDA was initialised at import'\n"
        "assert 'triton' not in sys.modules\n"
        "assert cudalib.launch_counts() == dict.fromkeys(cudalib.launch_counts(), 0)\n"
        "print(sorted(cudalib.launch_counts()))\n"
    )
    build = os.path.join(PKG, "csrc", "_build")
    before = set(os.listdir(build)) if os.path.isdir(build) else None
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(sorted(KERNELS))
    assert (set(os.listdir(build)) if os.path.isdir(build) else None) == before
    # every kernel the library is built from has its source in the package
    from bsls_tpu_torch.ops import cudalib

    for src in cudalib._SOURCES + cudalib._HEADERS:
        assert os.path.exists(os.path.join(PKG, "csrc", src)), src


def test_every_c_entry_point_a_wrapper_names_exists_in_csrc():
    """The wrappers bind by name through ctypes: a name that no source defines
    would only fail on the card.  And the build lists every file of csrc/, so
    that no stale library is loaded after an edit."""
    from bsls_tpu_torch.ops import cudalib

    csrc = os.path.join(PKG, "csrc")
    on_disk = sorted(f for f in os.listdir(csrc) if os.path.isfile(os.path.join(csrc, f)))
    assert on_disk == sorted(cudalib._SOURCES + cudalib._HEADERS)
    defined = set()
    for src in cudalib._SOURCES:
        with open(os.path.join(csrc, src)) as fh:
            defined |= set(re.findall(r'extern "C" \w+ (bsls_\w+)\(', fh.read()))
    named = set()
    for mod in ("rowkernels", "pagekernels", "chunkkernel", "ellkernels", "stepkernels"):
        with open(os.path.join(PKG, "ops", mod + ".py")) as fh:
            named |= set(re.findall(r"\b(bsls_[a-z_0-9]+)\b", fh.read()))
    named = {n for n in named if not n.startswith("bsls_tpu")}  # the packages' names
    assert len(named) >= 10
    assert named <= defined, sorted(named - defined)
    # and nothing is exported that no wrapper reaches
    assert defined <= named, sorted(defined - named)


def test_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|bsls_tpu)(\.|\s|$)", re.M)
    assert os.path.exists(os.path.join(REPO, "chip_smoke.py"))
    for path in _python_sources():
        with open(path) as fh:
            src = fh.read()
        assert not pat.search(src), path
        assert "torch.compile" not in src or path.endswith("chip_smoke.py"), path


def test_default_device_without_a_card_raises():
    import torch

    import bsls_tpu_torch as bt

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    prob = bt.synthetic.tiny_dense(num_blocks=4, dim=3, m=10)
    with pytest.raises(RuntimeError, match="cuda"):
        bt.solve(prob)
    with pytest.raises(RuntimeError, match="cuda"):
        bt.prepare(prob)
    with pytest.raises(RuntimeError, match="cuda"):
        bt.solve(prob, device="cuda")
    from bsls_tpu_torch.convert import device_problem_from_numpy

    with pytest.raises(RuntimeError, match="cuda"):
        device_problem_from_numpy({})


# options whose part was not ported: the mesh, which now runs the
# unconstrained solve and the equality-constrained loop (by column and by
# row); nothing raises "not ported" any more
UNPORTED = {
    "mesh": dict(block=1, device="cpu"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_options_raise(name):
    import bsls_tpu_torch as bt

    bt.init_distributed("gloo")
    mesh = bt.make_mesh(**UNPORTED[name])
    eq = bt.synthetic.traffic_like(num_blocks=10, m=30, num_eq=3)
    kw = dict(max_iter=30, chunk=10)
    want = bt.solve(eq, device="cpu", **kw)
    for rows in (False, True):
        got = bt.solve(eq, mesh=mesh, shard_rows=rows, **kw)
        assert got.eq_violation is not None and got.iterations == want.iterations
        np.testing.assert_allclose(got.objective, want.objective, rtol=1e-4)
    # the unconstrained solve on a mesh (a world of one) runs, as the
    # unsharded solve does
    prob = bt.synthetic.tiny_dense(num_blocks=4, dim=3, m=10)
    got = bt.solve(prob, mesh=mesh, max_iter=50, chunk=10, lipschitz=10.0)
    want = bt.solve(prob, device="cpu", max_iter=50, chunk=10, lipschitz=10.0)
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-6)
    np.testing.assert_allclose(got.x, want.x, atol=1e-6)


# options that raised "not ported" until the refine/certify and solver-family
# slice; they now run on the CPU and give what the reference gives
PORTED = {
    "refine": dict(method="lbfgs", refine=2),
    "refine_tol": dict(method="lbfgs", refine_tol=1e-6),
    "certify": dict(certify=10),
    "method_apgd": dict(method="apgd"),
    "method_lbfgs": dict(method="lbfgs"),
    "method_eg": dict(method="eg"),
    "method_fw": dict(method="frank_wolfe"),
    "method_afw": dict(method="afw"),
}


@pytest.mark.parametrize("name", sorted(PORTED))
def test_options_of_the_refine_and_family_slice_run(name):
    import bsls_tpu
    from bsls_tpu.models import synthetic as jsyn

    import bsls_tpu_torch as bt

    prob = bt.synthetic.tiny_dense(num_blocks=4, dim=3, m=10)
    kw = dict(tol=0.0, max_iter=100, lipschitz=bt.solvers.power_lipschitz(
        bt.prepare(prob, device="cpu")), **PORTED[name])
    res = bt.solve(prob, device="cpu", **kw)
    ref = bsls_tpu.solve(jsyn.tiny_dense(num_blocks=4, dim=3, m=10), **kw)
    assert res.x.shape == ref.x.shape == (prob.partition.n_flat,)
    assert res.iterations == ref.iterations
    refined = "refine" in name
    if name == "refine_tol":
        # both certified to 1e-6 (relative to max(1, |f|)), each where it stopped
        assert res.refine_fw_gap <= 1e-6 and ref.refine_fw_gap <= 1e-6
        assert abs(res.objective - ref.objective) <= 1e-6
    else:
        # refine: float64 at the optimum; the others fp32 after 100 steps
        np.testing.assert_allclose(res.objective, ref.objective, rtol=1e-9 if refined else 1e-4)
        np.testing.assert_allclose(res.x, ref.x, atol=1e-6 if refined else 1e-4)
    assert (res.refine_fw_gap is None) == (ref.refine_fw_gap is None)
    assert (res.refine_secs > 0) == refined


def test_equality_constrained_problem_raises():
    """prepare() of a Problem with C raises and points to solve(); solve()
    routes the same problem to the augmented-Lagrangian loop."""
    import bsls_tpu_torch as bt
    from bsls_tpu_torch.solvers import eq_constrained

    prob = bt.synthetic.traffic_like(num_blocks=10, m=40, num_eq=3)
    with pytest.raises(ValueError, match=r"solve\(\)"):
        bt.prepare(prob, device="cpu")
    seen = []
    real = eq_constrained.solve_equality_constrained

    def spy(problem, **kw):
        seen.append(kw)
        return real(problem, **kw)

    eq_constrained.solve_equality_constrained = spy
    try:
        res = bt.solve(prob, device="cpu", max_iter=100, chunk=50)
    finally:
        eq_constrained.solve_equality_constrained = real
    assert len(seen) == 1 and seen[0]["device"] == "cpu" and seen[0]["max_iter"] == 100
    assert res.eq_violation is not None and res.eq_lam.shape == (3,) and res.eq_rho > 0
    assert res.iterations == 100
    with pytest.raises(ValueError):
        bt.solve(bt.synthetic.tiny_dense(num_blocks=4, dim=3, m=10), device="cpu",
                 line_search="armijo")


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "bsls_tpu_torch", *args], cwd=REPO,
                          capture_output=True, text=True, env={**os.environ, **ONE_BLAS_THREAD})


def test_cli_runs_on_the_cpu_and_counts_no_launch():
    proc = _cli("--device", "cpu", "--config", "tiny", "--max-iter", "200", "--scenarios", "2")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["device"] == "cpu" and out["config"] == "tiny" and out["method"] == "pgd"
    assert out["scenarios"] == 2 and len(out["objective"]) == 2
    assert out["iterations"] == 200 and out["iters_per_sec"] > 0

    import bsls_tpu_torch as bt

    bt.reset_launch_counts()
    bt.solve(bt.synthetic.tiny_dense(num_blocks=4, dim=3, m=10), device="cpu", max_iter=10,
             chunk=10, line_search="pava")
    assert bt.launch_counts() == dict.fromkeys(KERNELS, 0)


@pytest.mark.parametrize("flag", [["--mesh-block", "1"], ["--unroll", "4"]])
def test_cli_rejects_flags_of_unported_parts(flag):
    """--unroll has no counterpart and is rejected; --mesh-block, rejected
    until the mesh was ported, now runs (a world of one here)."""
    proc = _cli("--device", "cpu", "--config", "tiny", "--max-iter", "100", *flag)
    if flag[0] == "--unroll":
        assert proc.returncode == 2
        assert "unrecognized arguments" in proc.stderr
        return
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["mesh"] == {"row": 1, "block": 1, "scenario": 1} and out["n_devices"] == 1
    assert out["iterations"] == 100


def test_cli_checkpoint_resume_and_profile_dir(tmp_path):
    """--checkpoint/--checkpoint-every save the state per chunk, --resume
    continues from it to the uninterrupted run's answer, and --profile-dir
    writes a torch.profiler trace."""
    ck, prof = str(tmp_path / "ck.npz"), str(tmp_path / "prof")
    base = ("--device", "cpu", "--config", "tiny", "--scenarios", "2")
    proc = _cli(*base, "--max-iter", "200", "--checkpoint", ck, "--checkpoint-every", "1",
                "--profile-dir", prof)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1])["iterations"] == 200
    from bsls_tpu_torch.utils.checkpoint import latest_checkpoint

    assert latest_checkpoint(ck) == ck
    (trace,) = os.listdir(prof)
    with open(os.path.join(prof, trace)) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    resumed = _cli(*base, "--max-iter", "400", "--checkpoint", ck, "--checkpoint-every", "1",
                   "--resume")
    assert resumed.returncode == 0, resumed.stderr
    r = json.loads(resumed.stdout.strip().splitlines()[-1])
    import bsls_tpu_torch as bt

    prob = bt.synthetic.with_scenarios(bt.synthetic.make_config("tiny", seed=0), 2, seed=1)
    full = bt.solve(prob, tol=1e-6, max_iter=400, device="cpu")
    assert r["iterations"] == full.iterations == 400
    np.testing.assert_allclose(r["objective"], full.objective, rtol=1e-6)


def test_cli_refine_prints_refine_secs():
    proc = _cli("--device", "cpu", "--config", "tiny", "--method", "lbfgs", "--max-iter", "200",
                "--refine", "2")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["method"] == "lbfgs" and out["refine_secs"] > 0
    assert out["iterations"] > 200 and "refine_fw_gap" not in out
    proc = _cli("--device", "cpu", "--config", "tiny", "--method", "afw", "--max-iter", "200",
                "--refine-tol", "1e-6")
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["refine_fw_gap"] <= 1e-6 and out["refine_secs"] > 0


def test_cli_default_device_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _cli("--config", "tiny")
    assert proc.returncode != 0 and "cuda" in proc.stderr
    proc = _cli("--config", "traffic")
    assert proc.returncode != 0 and "cuda" in proc.stderr
    proc = _cli("--config", "medium-banded")
    assert proc.returncode != 0 and "cuda" in proc.stderr


def test_cli_oracle_with_scenarios_gives_a_gap_per_scenario(tmp_path):
    """Repaired fault: --oracle with --scenarios > 1 crashed.  Each scenario
    now gets its own f*, and rel_gap_vs_oracle is the worst scenario's gap
    against its own f*."""
    proc = subprocess.run(
        [sys.executable, "-m", "bsls_tpu_torch", "--config", "tiny", "--scenarios", "4",
         "--oracle", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True,
        env={**os.environ, "BSLS_CACHE_DIR": str(tmp_path), **ONE_BLAS_THREAD})
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    f, fs = np.asarray(out["objective"]), np.asarray(out["oracle_objective"])
    assert f.shape == fs.shape == (4,) and np.isfinite(out["rel_gap_vs_oracle"])
    assert out["rel_gap_vs_oracle"] == pytest.approx(
        float(np.max((f - fs) / np.maximum(1.0, np.abs(fs)))), rel=1e-9, abs=1e-15)
    assert 0.0 <= out["rel_gap_vs_oracle"] <= 1e-4
    # the four scenarios are four instances: four cached f*
    assert len(os.listdir(tmp_path)) == 4


def test_kernel_library_load_and_first_launch_come_before_the_clock(monkeypatch):
    """Repaired fault: on a card the first chunk booked the kernel library's
    load (and nvcc when stale) and the first launches.  The warm-up runs
    before the chunk clock; on a CUDA device it loads the library first and
    raises when the load fails (no fallback)."""
    import time

    import torch

    import bsls_tpu_torch as bt
    from bsls_tpu_torch.ops import cudalib
    from bsls_tpu_torch.solvers import base as TB
    from bsls_tpu_torch.utils import profiling as P

    events = []

    class Clock:
        def perf_counter(self):
            events.append("clock")
            return time.perf_counter()

    real_warm, real_span = TB._warm_up, TB.span

    def warm(device, first_launch):
        events.append("warm")
        return real_warm(device, first_launch)

    def span(name, phases=None):
        events.append(name)
        return real_span(name, phases)

    # the chunk clock is the loop's span and one span a chunk
    # (utils/profiling.py), each reading the clock as it opens and closes
    monkeypatch.setattr(P, "time", Clock())
    monkeypatch.setattr(TB, "span", span)
    monkeypatch.setattr(TB, "_warm_up", warm)
    prob = bt.synthetic.tiny_dense(num_blocks=4, dim=3, m=10)
    res = bt.solve(prob, device="cpu", tol=0.0, max_iter=20, chunk=10)
    assert events.count("warm") == 1 and events.index("warm") < events.index("chunks")
    loop = events[events.index("chunks"):events.index("result")]
    assert loop.count("chunk") == len(res.chunk_times)
    assert loop.count("clock") == 2 * (1 + len(res.chunk_times))
    monkeypatch.setattr(P, "time", time)

    # the CUDA branch: load, then the first launch, then a synchronize
    calls = []
    monkeypatch.setattr(cudalib, "load", lambda: calls.append("load"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append("sync"))
    real_warm(torch.device("cuda"), lambda: calls.append("launch"))
    assert calls == ["load", "launch", "sync"]

    def broken():
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(cudalib, "load", broken)
    with pytest.raises(RuntimeError, match="nvcc"):
        real_warm(torch.device("cuda"), lambda: calls.append("launch"))
    assert calls.count("launch") == 1
