"""The exact PGD step's kernels (``csrc/pgd_step.cu``, wrapper
``ops/stepkernels.py``) and the step that takes them (``solvers/pgd.py``).

Without a card: each plain version against the chain of passes that step
made before the kernels, bit for bit, at S = 1, 4 and 128, at the bucket
counts of the cells (1, 2 and 4) and with dummy rows; the rule that picks the
kernels (exact, x-space, float32 on the card, no process group) and the
wrappers' refusals; the result's ``counts["fused_steps"]``; the plans'
constants against the source; and a restatement of the kernels' order of
summation in float32 (numpy), held against float64 sums within float32
rounding and against the plain versions.

Tests marked ``chip`` need an NVIDIA GPU and skip without one: one step
through the kernels against the chain on the same inputs, every output of
each kernel against the restatement bit for bit, a 500-step solve against
the chain's, a graphed chunk against its eager twin and two runs of one
solve, bit for bit.  This file imports nothing of JAX, so that they run on
the card with ``python -m pytest tests/test_torch_stepkernels.py -m chip
--noconftest -q``.
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import bsls_tpu_torch as bt
import bsls_tpu_torch.ops.layout as TL
from bsls_tpu_torch.models.partition import BlockPartition
from bsls_tpu_torch.models.problem import ScaledMatrix, VStackMatrix
from bsls_tpu_torch.ops import cudalib, projection, stepkernels as SK
from bsls_tpu_torch.ops import quadratic as Q
from bsls_tpu_torch.ops.simplex import fw_gap
from bsls_tpu_torch.solvers import base, graph, pgd
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, "bsls_tpu_torch", "csrc", "pgd_step.cu")
f32 = np.float32

# ------------------------------------------------------------ instances


def _with_dummies(prob, multiple):
    """The problem over a partition whose buckets end in dummy rows."""
    part = BlockPartition.from_sizes(prob.partition.sizes, block_multiple=multiple)
    return dataclasses.replace(prob, partition=part)


def _instance(kind, S, device="cpu", dtype=torch.float32):
    """(DeviceProblem, PGDState after 3 steps) of a small seeded instance:
    ``one`` one bucket (width 8, as config 4), ``two`` two buckets (3-8, as
    medium) with dummy rows, ``four`` four buckets (2-12, traffic_like) under
    its stacked operator [A; 2 C], ``dense`` and ``banded``."""
    syn = bt.synthetic
    if kind == "one":
        prob = syn.large_sharded(seed=1, num_blocks=600, m=2400, num_scenarios=1)
    elif kind == "two":
        prob = _with_dummies(syn.medium_sparse(seed=3, num_blocks=700, m=5000), 64)
    elif kind == "four":
        prob = syn.traffic_like(seed=2, num_blocks=400, m=1600)
    elif kind == "dense":
        prob = syn.tiny_dense(seed=3, num_blocks=12, dim=5, m=64)
    else:
        prob = syn.medium_banded(seed=2, num_blocks=300, m=3000, spread=120)
    C = prob.C
    if C is not None:
        prob = dataclasses.replace(prob, C=None, d=None)
    if S > 1:
        prob = syn.with_scenarios(prob, S, seed=4)
    layout = "banded" if kind == "banded" else "gather"
    dp = bt.prepare(prob, device=device, dtype=dtype, layout=layout)
    if C is not None:
        perm = TL.build_pf_perm(prob.partition)
        V = TL.to_device_matrix(VStackMatrix(top=prob.A, bottom=ScaledMatrix(C, 2.0)), perm,
                                device=device, dtype=dtype)
        gen = torch.Generator().manual_seed(7)
        bottom = torch.randn(dp.b.shape[:-1] + (C.shape[0],), generator=gen, dtype=dtype)
        dp = dataclasses.replace(dp, A=V, b=torch.cat([dp.b, bottom.to(device)], dim=-1))
    opts = base.SolveOptions()
    L_est = base.power_lipschitz(dp)
    st = pgd.init(dp, L_est, opts)
    for _ in range(3):
        st = pgd.step(dp, st, L_est, opts)
    return dp, st, L_est


def _chain_step(dp, st, L_est, step_size=0.0):
    """The step through the plain versions, on any device."""
    return pgd._exact_step(dp, st, L_est, base.SolveOptions(step_size=step_size), False)


def _before_step(dp, st, L_est, opts):
    """The exact branch of ``pgd.step`` as it was written before the step
    kernels, line for line: the yardstick that holds the plain versions to
    the answers the CPU gave before."""
    x_flat = TL.padded_to_flat(dp, st.xp)
    g_flat = Q.grad_flat(dp, st.r)
    gp = TL.flat_to_padded(dp, g_flat)
    gap = fw_gap(dp, g_flat, x_flat, gp)
    t0 = (torch.full_like(st.f, opts.step_size) if opts.step_size > 0
          else Q.inv_lipschitz(L_est, st.f))
    t0b = t0[:, None, None]
    cand = tuple(x - t0b * g for x, g in zip(st.xp, gp))
    xhat = projection.proj_blocks(cand, dp.buckets)
    dxp = tuple(xh.sub_(x) for xh, x in zip(xhat, st.xp))
    d_flat = TL.padded_to_flat(dp, dxp)
    Ad = TL.matvec_ps(dp, d_flat)
    t = Q.exact_step(dp, TL.xdot(dp, g_flat, d_flat), Ad, 0.0, 1.0)
    tb = t[:, None, None]
    xp_new = tuple(d.mul_(tb).add_(x) for x, d in zip(st.xp, dxp))
    r_new = Ad.mul_(t[:, None]).add_(st.r)
    f_new = Q.objective_from_residual(dp, r_new)
    return pgd.PGDState(xp=xp_new, r=r_new, f=f_new, gap=gap, k=st.k + 1,
                        x_prev=x_flat, g_prev=g_flat)


def _fields(st):
    return {"xp": st.xp, "r": st.r, "f": st.f, "gap": st.gap, "k": st.k,
            "x_prev": st.x_prev, "g_prev": st.g_prev}


def _assert_bits(a, b):
    for name, va in _fields(a).items():
        vb = _fields(b)[name]
        for ta, tb in zip(va if isinstance(va, tuple) else (va,),
                          vb if isinstance(vb, tuple) else (vb,)):
            assert torch.equal(ta, tb), name


# ------------------------------------------------------------ the plain versions


@pytest.mark.parametrize("kind", ["one", "two", "four"])
@pytest.mark.parametrize("S", [1, 4, 128])
def test_plain_versions_are_the_chain_bit_for_bit(kind, S):
    dp, st, L_est = _instance(kind, S)
    opts = base.SolveOptions()
    want = _before_step(dp, st, L_est, opts)
    _assert_bits(pgd.step(dp, st, L_est, opts), want)
    # each stretch on its own
    g_flat = Q.grad_flat(dp, st.r)
    cand, x_flat, gap = SK.prep_plain(dp, st.xp, g_flat, st.f, L_est, 0.0)
    assert torch.equal(x_flat, want.x_prev) and torch.equal(gap, want.gap)
    t0 = Q.inv_lipschitz(L_est, st.f)[:, None, None]
    gp = TL.flat_to_padded(dp, g_flat)
    for c, x, g in zip(cand, st.xp, gp):
        assert torch.equal(c, x - t0 * g)
    xhat = projection.proj_blocks(cand, dp.buckets)
    d = SK.dir_plain(dp, xhat, st.xp, x_flat, g_flat)
    assert d.operand is None
    assert torch.equal(d.dot, TL.xdot(dp, g_flat, d.flat))
    assert torch.equal(d.flat, TL.padded_to_flat(dp, d.buckets))


@pytest.mark.parametrize("kind", ["dense", "banded"])
def test_plain_versions_on_the_other_layouts_and_in_float64(kind):
    for dtype in (torch.float32, torch.float64):
        dp, st, L_est = _instance(kind, 3, dtype=dtype)
        opts = base.SolveOptions(step_size=0.0)
        _assert_bits(pgd.step(dp, st, L_est, opts), _before_step(dp, st, L_est, opts))
    # a fixed step in place of 1 / L
    opts = base.SolveOptions(step_size=0.25 / L_est)
    _assert_bits(pgd.step(dp, st, L_est, opts), _before_step(dp, st, L_est, opts))


def test_cpu_steps_never_reach_the_kernels(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("the kernel library was loaded on the CPU")

    monkeypatch.setattr(cudalib, "load", refused)
    dp, st, L_est = _instance("two", 4)
    bt.reset_launch_counts()
    pgd.step(dp, st, L_est, base.SolveOptions())
    counts = bt.launch_counts()
    assert counts["step_prep"] == counts["step_dir"] == counts["step_update"] == 0


# ------------------------------------------------------------ the rule and the counter


class _Group:
    """Stands in for a process group: only its presence is read."""


class _OnCard:
    """Stands in for the state's residual on the card: ``fused_step`` reads
    its device and its dtype alone."""

    is_cuda = True

    def __init__(self, dtype):
        self.dtype = dtype


@pytest.mark.parametrize("line_search,space,dtype,group,patched,fused", [
    ("exact", "x", torch.float32, None, True, True),
    ("exact", "x", torch.float32, None, False, False),  # the CPU
    ("bbm", "x", torch.float32, None, True, False),
    ("bb", "x", torch.float32, None, True, False),
    ("fixed", "x", torch.float32, None, True, False),
    ("pava", "x", torch.float32, None, True, False),
    ("exact", "z", torch.float32, None, True, False),
    ("exact", "x", torch.float64, None, True, False),
    ("exact", "x", torch.float32, "col", True, False),
    ("exact", "x", torch.float32, "row", True, False),
])
def test_the_kernels_take_exact_xspace_float32_on_one_card(line_search, space, dtype, group,
                                                          patched, fused):
    dp, st, L_est = _instance("two", 2, dtype=dtype)
    if group:
        dp = dataclasses.replace(dp, **{f"{group}_group": _Group()})
    if patched:
        st = dataclasses.replace(st, r=_OnCard(dtype))
    opts = base.SolveOptions(line_search=line_search, space=space)
    assert pgd.fused_step(dp, opts, st) is fused


def test_the_wrappers_refuse_before_any_launch(monkeypatch):
    """More buckets than a launch takes, and tensors off the card, raise
    before the library is loaded: nothing falls back to the chain."""
    def refused(*a, **k):
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(cudalib, "load", refused)
    dp, st, L_est = _instance("four", 2)
    g = Q.grad_flat(dp, st.r)
    many = dataclasses.replace(dp, buckets=dp.buckets * 3)
    assert len(many.buckets) > SK.MAX_BUCKETS
    with pytest.raises(ValueError, match="12 buckets, the kernel takes 1 to 8"):
        SK.step_prep(many, st.xp * 3, torch.cat([g] * 3, dim=1), st.f, L_est, 0.0)
    with pytest.raises(ValueError, match="CUDA device"):
        SK.step_prep(dp, st.xp, g, st.f, L_est, 0.0)
    x_flat = TL.padded_to_flat(dp, st.xp)
    with pytest.raises(ValueError, match="CUDA device"):
        SK.step_dir(dp, st.xp, st.xp, x_flat, g)


def test_a_record_gives_the_launches_of_one_replay():
    """What a captured chunk program reports as ``run.launches``, which
    ``counts["fused_steps"]`` reads: its record's kernel launches by name,
    the counts of any other counter left out."""
    other = {"other": 0}
    with cudalib.recording() as record:
        for _ in range(3):
            cudalib.launched("step_prep", 0)
        cudalib.launched("step_update", 0)
        cudalib.count(other, "other")
    assert cudalib.record_launches(record) == {"step_prep": 3, "step_update": 1}
    assert cudalib.record_launches({}) == {}


class _Reporting:
    """A chunk runner that reports ``launches`` a replay, as a captured
    chunk program does (``graph.graph_runner``)."""

    def __init__(self, run, launches):
        self.run, self.launches = run, launches

    def __call__(self, state):
        return self.run(state)


def _reporting(monkeypatch, per_chunk):
    """Every chunk program made reports ``per_chunk(steps)`` launches."""
    made = base.chunk_program

    def program(dp, solver, opts, L_est, steps, state):
        return _Reporting(made(dp, solver, opts, L_est, steps, state), per_chunk(steps))

    monkeypatch.setattr(base, "chunk_program", program)


@pytest.mark.parametrize("line_search,patched,want", [
    ("exact", False, 0), ("exact", True, 300), ("bbm", True, 0), ("pava", True, 0)])
def test_fused_steps_counts_the_iterations_of_the_kernels_path(monkeypatch, line_search,
                                                               patched, want):
    if patched:
        # a program of the kernels' path launches step_prep once a step; the
        # chain's launches the projection (or PAVA) alone
        kernels = line_search == "exact"
        _reporting(monkeypatch, lambda steps: {"step_prep": steps, "step_dir": steps}
                   if kernels else {"proj_simplex_rows": steps})
    prob = bt.synthetic.with_scenarios(bt.synthetic.medium_sparse(seed=3, num_blocks=200,
                                                                  m=1500), 2, seed=4)
    res = bt.solve(prob, method="pgd", line_search=line_search, tol=0.0, max_iter=300,
                   chunk=100, device="cpu", layout="gather")
    assert res.iterations == 300
    assert res.counts["fused_steps"] == want


def test_fused_steps_sums_over_the_outers_of_an_eq_solve(monkeypatch):
    _reporting(monkeypatch, lambda steps: {"step_prep": steps})
    prob = bt.synthetic.traffic_like(seed=0, num_blocks=200, m=800)
    res = bt.solve(prob, method="pgd", line_search="exact", tol=0.0, max_iter=400, chunk=100,
                   device="cpu")
    assert res.counts["outers"] >= 1
    assert res.counts["fused_steps"] == res.iterations > 0


# ------------------------------------------------------------ the plans


def test_constants_agree_with_the_cuda_source():
    with open(SOURCE) as fh:
        src = fh.read()
    consts = dict(re.findall(r"constexpr int (kStep\w+) = ([0-9]+);", src))
    assert int(consts["kStepThreads"]) == SK.THREADS
    assert int(consts["kStepTile"]) == SK.TILE
    assert int(consts["kStepBlocks"]) == SK.BLOCKS
    assert int(consts["kStepMaxBuckets"]) == SK.MAX_BUCKETS
    assert int(consts["kStepMaxGroup"]) == SK.MAX_GROUP
    assert "atomicAdd(P.done, 1)" in src and src.count("atomicAdd") == 1  # one integer count
    assert "__fmaf" not in src and "fmaf(" not in src  # every product rounded on its own


@pytest.mark.parametrize("S", [1, 3, 4, 8, 32, 100, 128, 1024])
def test_plans_cover_every_element_once_with_few_parts(S):
    shapes = [(3330, 4), (6670, 8)]
    rows, tiles, C1 = SK.prep_plan(S, shapes)
    assert rows == [512, 256] and tiles == 7 + 27 and 1 <= C1 <= tiles
    assert S * C1 <= max(SK.BLOCKS + S, S)
    ts, tp, groups, t2, C2 = SK.dir_plan(S, shapes)
    assert ts * tp == SK.TILE and ts >= min(S, SK.MAX_GROUP) and ts & (ts - 1) == 0
    assert groups * ts >= S and t2 == sum(-(-(b * w) // tp) for b, w in shapes)
    r_tiles, C3, x_tiles, t4, C4, lanes = SK.update_plan(S, shapes, 100_000)
    assert r_tiles == 49 and t4 == x_tiles + r_tiles and 1 <= C3 <= r_tiles
    assert lanes & (lanes - 1) == 0 and 1 <= lanes <= 32
    assert lanes * S <= SK.THREADS or lanes == 1
    # about BLOCKS blocks a launch: the parts a consumer folds stay few
    per_s = max(1, -(-SK.BLOCKS // S))
    assert C1 <= per_s and C3 <= per_s and C4 <= per_s
    assert C2 <= max(1, -(-SK.BLOCKS // groups))


# ------------------------------------------------------------ the kernels' sums, restated


def _fold(v, width):
    """Lane 0 of a shuffle-down fold over the last axis of ``width`` lanes:
    v[l] += v[l + h], h = width / 2 .. 1."""
    while width > 1:
        h = width // 2
        v = v[..., :h] + v[..., h:2 * h]
        width = h
    return v[..., 0]


def _block_sum(v):
    """block_sum: (..., 256) thread values -> (...,)."""
    warps = _fold(v.reshape(*v.shape[:-1], SK.THREADS // 32, 32), 32)
    return _fold(warps, SK.THREADS // 32)


def _accumulate(acc, vals):
    """Thread e % 256 adds element e of ``vals`` (..., E) to ``acc`` (...,
    256), in order of e."""
    E = vals.shape[-1]
    for i in range(0, E, SK.THREADS):
        chunk = vals[..., i:i + SK.THREADS]
        if chunk.shape[-1] < SK.THREADS:
            pad = np.zeros(vals.shape[:-1] + (SK.THREADS - chunk.shape[-1],), f32)
            chunk = np.concatenate([chunk, pad], axis=-1)
        acc = acc + chunk
    return acc


def _block_sum_of(parts):
    """block_sum_of: (..., C) parts -> (...,)."""
    return _block_sum(_accumulate(np.zeros(parts.shape[:-1] + (SK.THREADS,), f32), parts))


def _lane_sum(parts, lanes):
    """apply's last block: lane l of ``lanes`` sums parts l, l + lanes, ...
    in order, then the lanes fold."""
    acc = np.zeros(parts.shape[:-1] + (lanes,), f32)
    for i in range(0, parts.shape[-1], lanes):
        chunk = parts[..., i:i + lanes]
        acc[..., :chunk.shape[-1]] = acc[..., :chunk.shape[-1]] + chunk
    return _fold(acc, lanes)


def _offsets(shapes):
    out, at = [], 0
    for Bk, w in shapes:
        out.append(at)
        at += Bk * w
    return out


def restated_prep(xp, g, sizes, radius):
    """step_prep's (2, S, C1) parts of g.x and of radius * min."""
    S = g.shape[0]
    shapes = [x.shape[1:] for x in xp]
    rows, tiles, C = SK.prep_plan(S, shapes)
    offs = _offsets(shapes)
    where, k = [], 0
    for i, ((Bk, _), rt) in enumerate(zip(shapes, rows)):
        where += [(i, b0) for b0 in range(0, Bk, rt)]
    parts = np.zeros((2, S, C), f32)
    for c in range(C):
        gx = np.zeros((S, SK.THREADS), f32)
        mn = np.zeros((S, SK.THREADS), f32)
        for j in range(c, tiles, C):
            i, b0 = where[j]
            Bk, w = shapes[i]
            nrows = min(rows[i], Bk - b0)
            xs = xp[i][:, b0:b0 + nrows, :].reshape(S, -1)
            gs = g[:, offs[i] + b0 * w: offs[i] + (b0 + nrows) * w]
            gx = _accumulate(gx, gs * xs)
            nv = np.minimum(sizes[i][b0:b0 + nrows], w)
            grow = gs.reshape(S, nrows, w)
            slot = np.arange(w)[None, None, :] < nv[None, :, None]
            gmin = np.where(slot, grow, np.inf).min(axis=-1).astype(f32)
            rowv = np.where(nv[None, :] > 0, radius[i][b0:b0 + nrows][None, :] * gmin, f32(0))
            mn = _accumulate(mn, rowv.astype(f32))
        parts[0, :, c] = _block_sum(gx)
        parts[1, :, c] = _block_sum(mn)
    return parts


def restated_dir(xhat, xflat, g):
    """step_dir's d (S, n) and (S, C2) parts of g.d."""
    S, n = g.shape
    shapes = [x.shape[1:] for x in xhat]
    ts, tp, groups, tiles, C = SK.dir_plan(S, shapes)
    offs = _offsets(shapes)
    xh_flat = np.concatenate([x.reshape(S, -1) for x in xhat], axis=1)
    d = (xh_flat - xflat).astype(f32)
    prod = (g * d).astype(f32)
    where = []
    for i, (Bk, w) in enumerate(shapes):
        where += [(i, q0) for q0 in range(0, Bk * w, tp)]
    parts = np.zeros((S, C), f32)
    for grp in range(groups):
        s0 = grp * ts
        for c in range(C):
            racc = np.zeros(ts, f32)
            for j in range(c, tiles, C):
                i, q0 = where[j]
                seg = shapes[i][0] * shapes[i][1]
                tile = np.zeros((ts, tp), f32)
                hi_s, hi_q = min(S, s0 + ts), min(seg, q0 + tp)
                tile[:hi_s - s0, :hi_q - q0] = prod[s0:hi_s, offs[i] + q0:offs[i] + hi_q]
                lanes = np.zeros((ts, 32), f32)
                for p in range(0, tp, 32):
                    lanes = lanes + tile[:, p:p + 32]
                racc = racc + _fold(lanes, 32)
            parts[s0:min(S, s0 + ts), c] = racc[:min(S, s0 + ts) - s0]
    return d, parts


def restated_update(xflat, dflat, r, Ad, gparts, dparts, shapes):
    """step_update's (x + t d flat, r + t Ad, f, gap)."""
    S, m = r.shape
    r_tiles, C3, x_tiles, tiles, C4, lanes = SK.update_plan(S, shapes, m)
    aparts = np.zeros((S, C3), f32)
    for c in range(C3):
        acc = np.zeros((S, SK.THREADS), f32)
        for j in range(c, r_tiles, C3):
            a = Ad[:, j * SK.TILE:(j + 1) * SK.TILE]
            acc = _accumulate(acc, a * a)
        aparts[:, c] = _block_sum(acc)
    gap = _block_sum_of(gparts[0]) - _block_sum_of(gparts[1])
    gd, den = _block_sum_of(dparts), _block_sum_of(aparts)
    t = -gd / np.where(den < f32(1e-30), f32(1e-30), den)
    t = np.where(t < 0, f32(0), np.where(t > 1, f32(1), t)).astype(f32)
    xnew = (dflat * t[:, None]).astype(f32) + xflat
    rnew = (Ad * t[:, None]).astype(f32) + r
    rparts = np.zeros((S, C4), f32)
    for c in range(C4):
        acc = np.zeros((S, SK.THREADS), f32)
        for j in range(c, tiles, C4):
            if j >= x_tiles:
                rr = rnew[:, (j - x_tiles) * SK.TILE:(j - x_tiles + 1) * SK.TILE]
                acc = _accumulate(acc, rr * rr)
        rparts[:, c] = _block_sum(acc)
    f = f32(0.5) * _lane_sum(rparts, lanes)
    return xnew, rnew, f.astype(f32), gap.astype(f32), t


def _restated_step(dp, st, L_est, xhat=None, Ad=None):
    """The kernels' step restated in numpy float32 from the state (``xhat``
    and ``Ad``: the projection's and the product's answers where given;
    computed here by the projection and the product otherwise)."""
    np_ = lambda t: t.detach().cpu().numpy()
    g = Q.grad_flat(dp, st.r)
    t0 = f32(1.0 / float(L_est))
    xp = [np_(x) for x in st.xp]
    sizes = [np_(bk.sizes) for bk in dp.buckets]
    radius = [np_(bk.radius) for bk in dp.buckets]
    gnp = np_(g)
    gparts = restated_prep(xp, gnp, sizes, radius)
    xflat = np.concatenate([x.reshape(x.shape[0], -1) for x in xp], axis=1)
    cand = [(x - (t0 * gnp[:, o:o + x.shape[1] * x.shape[2]].reshape(x.shape)).astype(f32))
            for x, o in zip(xp, _offsets([x.shape[1:] for x in xp]))]
    if xhat is None:
        xhat = projection.proj_blocks(tuple(torch.from_numpy(c) for c in cand), dp.buckets)
    xh = [np_(x) for x in xhat]
    d, dparts = restated_dir(xh, xflat, gnp)
    if Ad is None:
        Ad = TL.matvec_ps(dp, torch.from_numpy(d))
    xnew, rnew, f, gap, t = restated_update(xflat, d, np_(st.r), np_(Ad), gparts, dparts,
                                            [x.shape[1:] for x in xp])
    return dict(cand=cand, xflat=xflat, gparts=gparts, d=d, dparts=dparts, xnew=xnew,
                rnew=rnew, f=f, gap=gap, t=t)


@pytest.mark.parametrize("kind", ["one", "two", "four"])
@pytest.mark.parametrize("S", [1, 4, 128])
def test_restated_order_sums_within_float32_rounding(kind, S):
    dp, st, L_est = _instance(kind, S)
    got = _restated_step(dp, st, L_est)
    want = _before_step(dp, st, L_est, base.SolveOptions())
    g = Q.grad_flat(dp, st.r).double().numpy()
    x = got["xflat"].astype(np.float64)
    d = got["d"].astype(np.float64)
    # each restated sum against its float64 sum, within float32 rounding of
    # the sum of the magnitudes
    eps = np.finfo(np.float32).eps
    n_terms = x.shape[1] + 1

    def close(a, exact, mags):
        assert np.all(np.abs(a - exact) <= 2 * n_terms * eps * mags + 1e-30)

    gx = (g * x).sum(axis=1)
    gparts = got["gparts"].astype(np.float64)
    close(gparts[0].sum(axis=1), gx, (np.abs(g * x)).sum(axis=1))
    close(got["dparts"].astype(np.float64).sum(axis=1), (g * d).sum(axis=1),
          np.abs(g * d).sum(axis=1))
    r = got["rnew"].astype(np.float64)
    close(got["f"].astype(np.float64), 0.5 * (r * r).sum(axis=1), 0.5 * (r * r).sum(axis=1))
    # and the whole step against the chain's
    np.testing.assert_allclose(got["f"], want.f.numpy(), rtol=1e-5)
    # the gap is a difference of two sums: its rounding is that of g.x
    np.testing.assert_allclose(got["gap"], want.gap.numpy(), rtol=0,
                               atol=1e-5 * float(np.abs(g * x).sum(axis=1).max()))
    np.testing.assert_allclose(got["xnew"], TL.padded_to_flat(dp, want.xp).numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["rnew"], want.r.numpy(), rtol=1e-5,
                               atol=1e-6 * float(want.r.abs().max()))


def test_restated_sums_repeat_and_split_like_the_kernels():
    """Every part of the restatement repeats itself bit for bit, and a
    fold of 2^k lanes is the pairwise tree: lane 0 of (a, b, c, d) is
    (a + c) + (b + d)."""
    v = np.array([[1e8, 1.0, -1e8, 1.0]], f32)
    assert _fold(v, 4)[0] == (f32(1e8) + f32(-1e8)) + (f32(1.0) + f32(1.0))
    dp, st, L_est = _instance("two", 4)
    a, b = _restated_step(dp, st, L_est), _restated_step(dp, st, L_est)
    for key in ("gparts", "dparts", "xnew", "rnew", "f", "gap"):
        assert np.array_equal(a[key], b[key])


# ------------------------------------------------------------ the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run with -m chip on the card)")
    return torch.device("cuda", 0)


def _rel(a, b):
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _hold_fused_step(dp, st, L_est, limit=1e-5):
    """One step through the kernels against the chain on the same inputs,
    relative 1e-5 in x, r, f and the gap; the launches; and every output
    against the restatement bit for bit."""
    opts = base.SolveOptions()
    assert pgd.fused_step(dp, opts, st)
    bt.reset_launch_counts()
    got = pgd.step(dp, st, L_est, opts)
    torch.cuda.synchronize()
    counts = bt.launch_counts()
    assert (counts["step_prep"], counts["step_dir"], counts["step_update"]) == (1, 1, 2)
    want = _chain_step(dp, st, L_est)
    errs = {"x": max(_rel(a, b) for a, b in zip(got.xp, want.xp)), "r": _rel(got.r, want.r),
            "f": _rel(got.f, want.f), "gap": _rel(got.gap, want.gap)}
    assert max(errs.values()) <= limit, errs
    assert torch.equal(got.x_prev, want.x_prev) and torch.equal(got.g_prev, want.g_prev)
    # the kernels' own arithmetic: each wrapper's outputs against the
    # restatement from the same inputs (the projection's and the product's
    # answers taken from the card)
    g = Q.grad_flat(dp, st.r)
    cand, x_flat, gparts = SK.step_prep(dp, st.xp, g, st.f, L_est, 0.0)
    xhat = projection.proj_blocks(cand, dp.buckets)
    xhat_copy = tuple(x.clone() for x in xhat)
    d = SK.step_dir(dp, xhat, st.xp, x_flat, g)
    Ad = TL.matvec_ps(dp, d.flat, d.operand)
    Ad_copy = Ad.clone()
    xp, r, f, gap = SK.step_update(dp, st.xp, x_flat, st.r, d, Ad, gparts)
    ref = _restated_step(dp, st, L_est, xhat=xhat_copy, Ad=Ad_copy)
    np_ = lambda t: t.cpu().numpy()
    assert np.array_equal(np_(x_flat), ref["xflat"])
    for c, rc in zip(cand, ref["cand"]):
        assert np.array_equal(np_(c), rc)
    assert np.array_equal(np_(gparts), ref["gparts"])
    assert np.array_equal(np_(d.flat), ref["d"]) and np.array_equal(np_(d.dot), ref["dparts"])
    if d.operand is not None:
        assert torch.equal(d.operand, d.flat.t())
    assert np.array_equal(np_(TL.padded_to_flat(dp, xp)), ref["xnew"])
    assert np.array_equal(np_(r), ref["rnew"])
    assert np.array_equal(np_(f), ref["f"]) and np.array_equal(np_(gap), ref["gap"])
    return errs


@pytest.mark.chip
@pytest.mark.parametrize("S", [1, 8, 32, 128])
def test_medium_step_against_the_chain_on_the_card(card, S):
    prob = bt.synthetic.medium_sparse(seed=0)
    if S > 1:
        prob = bt.synthetic.with_scenarios(prob, S, seed=4)
    dp = bt.prepare(prob, device=card, layout="gather")
    opts = base.SolveOptions()
    L_est = base.power_lipschitz(dp)
    st = pgd.init(dp, L_est, opts)
    for _ in range(5):
        st = pgd.step(dp, st, L_est, opts)
    _hold_fused_step(dp, st, L_est)


@pytest.mark.chip
@pytest.mark.parametrize("kind,S", [("four", 128), ("banded", 4), ("dense", 4), ("one", 4),
                                    ("two", 3)])
def test_other_operators_against_the_chain_on_the_card(card, kind, S):
    dp, st, L_est = _instance(kind, S, device=card)
    _hold_fused_step(dp, st, L_est)


@pytest.mark.chip
def test_large_shapes_at_four_scenarios_on_the_card(card):
    """config 4's widths and density at a reduced block count."""
    prob = bt.synthetic.large_sharded(seed=0, num_blocks=100_000, m=26_214, num_scenarios=4)
    dp = bt.prepare(prob, device=card, layout="gather")
    opts = base.SolveOptions()
    L_est = base.power_lipschitz(dp)
    st = pgd.init(dp, L_est, opts)
    for _ in range(3):
        st = pgd.step(dp, st, L_est, opts)
    _hold_fused_step(dp, st, L_est)


def _medium32(card):
    prob = bt.synthetic.with_scenarios(bt.synthetic.medium_sparse(seed=0), 32, seed=4)
    return bt.prepare(prob, device=card, layout="gather")


@pytest.mark.chip
def test_500_steps_against_the_chain_on_the_card(card, monkeypatch):
    dp = _medium32(card)

    def run():
        return bt.solve(dp, method="pgd", line_search="exact", tol=0.0, max_iter=500,
                        chunk=100)

    fused = run()
    assert fused.counts["fused_steps"] == 500
    monkeypatch.setattr(pgd, "fused_step", lambda *a: False)
    graph._PROGRAMS.clear()  # the chain's chunk has the same key: capture it anew
    chain = run()
    assert chain.counts["fused_steps"] == 0
    rel = np.abs(fused.objective - chain.objective) / np.abs(chain.objective)
    assert float(rel.max()) <= 1e-5, float(rel.max())


@pytest.mark.chip
def test_graphed_chunk_equals_its_eager_twin_and_repeats_on_the_card(card, monkeypatch):
    dp = _medium32(card)

    def run():
        return bt.solve(dp, method="pgd", line_search="exact", tol=0.0, max_iter=200,
                        chunk=100)

    graphed = run()
    graph._PROGRAMS.clear()  # the second run captures its own graph
    again = run()
    assert np.array_equal(graphed.x, again.x)
    assert np.array_equal(graphed.trace_f, again.trace_f)
    assert np.array_equal(graphed.trace_gap, again.trace_gap)
    bt.reset_launch_counts()
    run()
    counts = bt.launch_counts()
    # from the graph cache: two chunks of 100 steps, each step one
    # step_prep, one step_dir and two step_update launches
    assert (counts["step_prep"], counts["step_dir"], counts["step_update"]) == (200, 200, 400)
    monkeypatch.setattr(base, "chunk_program", lambda dp, solver, opts, L_est, steps, state:
                        base.make_chunk_runner(dp, solver, opts, L_est, steps))
    eager = run()
    assert np.array_equal(graphed.x, eager.x)
    assert np.array_equal(graphed.trace_f, eager.trace_f)
    assert np.array_equal(graphed.trace_gap, eager.trace_gap)
