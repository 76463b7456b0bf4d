"""Seeded inputs of the benchmark: the planted-flow instance of a
configuration and the right-hand sides of its requests.

The same distributions as the program's synthetic generators (route
incidence scaled by the OD demand of the route's block, Dirichlet(0.3)
route splits, equality rows that sum a few routes' scaled flows), drawn in
bulk rather than block by block.  Every seed gets the same multiset of block
sizes, of route lengths and of links' route counts (A's column and row
lengths), in another order, so that a run's work, padded layouts included,
does not depend on its seed.  A route's links are distinct, so A needs no
coalescing.

The instance's structure is drawn on the host with numpy; the flows and the
right-hand sides of the requests are drawn on the device with a
``torch.Generator`` and computed in float64 by a deterministic segment sum,
then handed over as float32 numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

__all__ = ["Instance", "make_instance", "planted_flows", "apply_A", "Requests"]


@dataclass
class Instance:
    """A block-simplex LSQ instance as raw arrays (the benchmark's own form)."""

    sizes: np.ndarray  # (B,) block sizes
    rows: np.ndarray  # (n, k) int32 link of each route slot, 0 where padding
    vals: np.ndarray  # (n, k) float64 demand of each route slot, 0 where padding
    m: int
    C: Optional[np.ndarray] = None  # (p, n) equality rows, dense
    b: Optional[np.ndarray] = None  # (S, m) float32 right-hand sides of the base scenarios
    d: Optional[np.ndarray] = None  # (S, p) float64 equality targets of the base scenarios

    @property
    def n(self) -> int:
        return int(self.sizes.sum())

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.vals))

    @property
    def offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.sizes)[:-1]])


def _fixed_multiset(rng: np.random.Generator, lo: int, hi: int, count: int) -> np.ndarray:
    """``count`` values spread as evenly as possible over lo..hi, shuffled."""
    vals = np.arange(lo, hi + 1)
    reps = np.full(vals.size, count // vals.size)
    reps[: count % vals.size] += 1
    return rng.permutation(np.repeat(vals, reps))


def _row_degrees(m: int, nnz: int) -> np.ndarray:
    """Links' route counts: a fixed Poisson(nnz / m) sample, the same for
    every seed (drawn from a constant generator), summing to ``nnz``."""
    rng = np.random.default_rng(0)
    deg = rng.poisson(nnz / m, size=m)
    diff = nnz - int(deg.sum())
    step = 1 if diff > 0 else -1
    while diff:
        idx = rng.choice(np.flatnonzero(deg > 0) if step < 0 else np.arange(m),
                         size=min(abs(diff), m), replace=False)
        deg[idx] += step
        diff -= step * idx.size
    return deg


def _links(rng: np.random.Generator, m: int, lens: np.ndarray) -> np.ndarray:
    """Each route's links, distinct within the route, as one flat array in
    route order: a shuffle of every link repeated by its fixed count
    (``_row_degrees``), with repeated links inside a route swapped away."""
    nnz = int(lens.sum())
    slots = rng.permutation(np.repeat(np.arange(m), _row_degrees(m, nnz)))
    route = np.repeat(np.arange(lens.size), lens)
    while True:
        key = route * m + slots
        order = np.argsort(key, kind="stable")
        sk = key[order]
        dup = order[1:][sk[1:] == sk[:-1]]
        if not dup.size:
            return slots
        other = rng.integers(0, nnz, size=dup.size)
        slots[dup], slots[other] = slots[other], slots[dup].copy()


def make_instance(params: dict, seed: int) -> Instance:
    """The configuration's structure from ``params`` (its JSON's
    ``generator``) and the seed: block sizes, the route incidence A and, with
    ``num_eq``, dense equality rows C."""
    rng = np.random.default_rng([seed, 0])
    B, m = int(params["num_blocks"]), int(params["m"])
    sizes = _fixed_multiset(rng, params["dim_lo"], params["dim_hi"], B).astype(np.int64)
    n = int(sizes.sum())
    demands = rng.uniform(params["demand_lo"], params["demand_hi"], size=B)
    k = int(params["route_len_hi"])
    lens = _fixed_multiset(rng, params["route_len_lo"], k, n)
    active = np.arange(k)[None, :] < lens[:, None]
    rows = np.zeros((n, k), np.int32)
    rows[active] = _links(rng, m, lens)
    vals = np.where(active, np.repeat(demands, sizes)[:, None], 0.0)
    C = None
    p = int(params.get("num_eq", 0))
    if p:
        C = np.zeros((p, n))
        for i, cnt in enumerate(rng.integers(params["eq_nnz_lo"], params["eq_nnz_hi"] + 1, size=p)):
            sel = rng.choice(n, size=cnt, replace=False)
            C[i, sel] = rng.uniform(params["eq_val_lo"], params["eq_val_hi"], size=cnt)
    return Instance(sizes=sizes, rows=rows, vals=vals, m=m, C=C)


class RowSum:
    """A x for a batch of x, as a segment sum over A's nonzeros sorted by
    row: a cumulative sum along the nonzeros, differenced at the row ends.
    Deterministic (no atomics), float64."""

    def __init__(self, inst: Instance, device):
        mask = inst.vals != 0
        cols = np.broadcast_to(np.arange(inst.n)[:, None], mask.shape)[mask]
        rows, vals = inst.rows[mask], inst.vals[mask]
        order = np.argsort(rows, kind="stable")
        ptr = np.zeros(inst.m + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=inst.m), out=ptr[1:])
        self.cols = torch.as_tensor(cols[order], device=device)
        self.vals = torch.as_tensor(vals[order], dtype=torch.float64, device=device)
        self.ptr = torch.as_tensor(ptr, device=device)

    def __call__(self, X: torch.Tensor, chunk: int = 32) -> torch.Tensor:
        out = []
        for s in range(0, X.shape[0], chunk):
            contrib = X[s:s + chunk].index_select(1, self.cols) * self.vals
            cs = torch.nn.functional.pad(torch.cumsum(contrib, dim=1), (1, 0))
            out.append(cs.index_select(1, self.ptr[1:]) - cs.index_select(1, self.ptr[:-1]))
        return torch.cat(out)


def apply_A(inst: Instance, X: torch.Tensor) -> torch.Tensor:
    return RowSum(inst, X.device)(X.to(torch.float64))


def planted_flows(inst: Instance, S: int, gen: torch.Generator, alpha: float = 0.3) -> torch.Tensor:
    """(S, n) float64 flows, each block a Dirichlet(alpha) split, on the
    generator's device."""
    dev = gen.device
    g = torch._standard_gamma(torch.full((S, inst.n), alpha, dtype=torch.float64, device=dev),
                              generator=gen) + 1e-12
    starts = torch.as_tensor(inst.offsets, device=dev)
    ends = starts + torch.as_tensor(inst.sizes, device=dev)
    cs = torch.nn.functional.pad(torch.cumsum(g, dim=1), (1, 0))
    sums = cs.index_select(1, ends) - cs.index_select(1, starts)
    block = torch.repeat_interleave(torch.arange(len(inst.sizes), device=dev),
                                    torch.as_tensor(inst.sizes, device=dev))
    return g / sums.index_select(1, block)


class Requests:
    """The right-hand sides of a run's requests, each drawn once and never
    sent twice: entry i is a float32 numpy array, ``(scenarios, m)`` or, for
    ``scenarios: 1``, ``(m,)``.

    ``rhs: "planted"`` gives every scenario of every request a fresh planted
    flow (noise ``noise``); ``rhs: "drift"`` multiplies each entry of the
    instance's base b by (1 + drift N(0, 1)), fresh noise for each request.
    Rows are drawn on the device in draws of ``DRAW`` rows (a drift request is
    one draw), draw j from its own generator seeded by (seed, stream, j), so
    an entry is the same whether it was made before the clock or on demand.
    The first ``count`` entries are made at once, before the window; an entry
    past them is made when it is first asked for."""

    DRAW = 128

    def __init__(self, inst: Instance, traffic: dict, seed: int, device, count: int,
                 stream: int = 0):
        self.inst, self.device, self.seed, self.stream = inst, device, int(seed), int(stream)
        self.S, self.rhs = int(traffic["scenarios"]), traffic["rhs"]
        if self.rhs == "planted":
            self.noise, self.rowsum = float(traffic["noise"]), RowSum(inst, device)
        elif self.rhs == "drift":
            self.drift = float(traffic["drift"])
            self.base = torch.as_tensor(inst.b, dtype=torch.float64, device=device)
            if self.base.shape[0] != self.S:
                raise ValueError(f"drift traffic of {self.S} scenarios over a base of "
                                 f"{self.base.shape[0]}")
        else:
            raise ValueError(f"unknown rhs {self.rhs!r}")
        self._draws: dict = {}
        self._entries: dict = {}
        self.count = int(count)
        for i in range(self.count):
            self[i]

    def __len__(self) -> int:
        return max(self.count, len(self._entries))

    def _gen(self, j: int) -> torch.Generator:
        key = np.random.SeedSequence([self.seed % 2**63, self.stream, j]).generate_state(2, np.uint64)
        return torch.Generator(device=self.device).manual_seed(int(key[0] >> np.uint64(1)))

    def _draw(self, j: int) -> np.ndarray:
        if j not in self._draws:
            gen = self._gen(j)
            if self.rhs == "planted":
                B = self.rowsum(planted_flows(self.inst, self.DRAW, gen))
                B += self.noise * torch.randn(B.shape, generator=gen, dtype=B.dtype,
                                              device=self.device)
            else:
                noise = torch.randn(self.base.shape, generator=gen, dtype=torch.float64,
                                    device=self.device)
                B = self.base * (1.0 + self.drift * noise)
            self._draws[j] = B.float().cpu().numpy()
        return self._draws[j]

    def __getitem__(self, i: int) -> np.ndarray:
        i = int(i)
        if i < 0:
            raise IndexError(i)
        if i not in self._entries:
            if self.rhs == "drift":
                out = self._draw(i)
            else:
                lo, hi = i * self.S, (i + 1) * self.S
                js = range(lo // self.DRAW, (hi - 1) // self.DRAW + 1)
                parts = [self._draw(j)[max(lo - j * self.DRAW, 0):hi - j * self.DRAW] for j in js]
                # rows of one draw stay a view of it, so nothing is held twice
                out = parts[0] if len(parts) == 1 else np.concatenate(parts)
            self._entries[i] = out[0] if self.S == 1 else out
        return self._entries[i]


def plant_base(inst: Instance, params: dict, seed: int, device) -> None:
    """The instance's own scenarios (``params["scenarios"]`` planted flows):
    b = A x + noise, and d = C x where the instance has C (exact
    measurements, no noise)."""
    S = int(params.get("scenarios", 0))
    if not S:
        return
    gen = torch.Generator(device=device).manual_seed(int(seed) * 4 + 2)
    X = planted_flows(inst, S, gen)
    B = apply_A(inst, X)
    B += params["noise"] * torch.randn(B.shape, generator=gen, dtype=B.dtype, device=device)
    inst.b = B.float().cpu().numpy()
    if inst.C is not None:
        inst.d = (X @ torch.as_tensor(inst.C.T, device=device)).cpu().numpy()
