"""Synthetic instance generators for the benchmark configs.

Tiny dense, medium sparse, traffic-style equality-constrained and large
multi-RHS instances, generated with a planted feasible flow ``x_true`` so
objectives have a known small optimum and solutions are physically
meaningful (route fractions).

A copy of ``bsls_tpu/models/synthetic.py`` with the same seeds and the same
draw order: the same seed gives the same instance in both packages
(tests/test_torch_models.py and tests/test_torch_traffic.py assert it).
"""
from __future__ import annotations

import numpy as np

from .partition import BlockPartition
from .problem import DenseMatrix, EllMatrix, Problem

__all__ = [
    "random_block_x",
    "tiny_dense",
    "medium_sparse",
    "medium_banded",
    "traffic_like",
    "large_sharded",
    "make_config",
]


def random_block_x(rng: np.random.Generator, sizes: np.ndarray, concentrated: bool = True) -> np.ndarray:
    """A random feasible point (each block on its simplex).

    ``concentrated=True`` draws Dirichlet(0.3)-like sparse route splits, the
    realistic traffic regime; otherwise uniform Dirichlet(1).
    """
    alpha = 0.3 if concentrated else 1.0
    out = np.empty(int(np.sum(sizes)))
    off = 0
    for n in np.asarray(sizes, dtype=np.int64):
        g = rng.gamma(alpha, size=n) + 1e-12
        out[off : off + n] = g / g.sum()
        off += n
    return out


def tiny_dense(seed: int = 0, num_blocks: int = 100, dim: int = 10, m: int = 1000,
               noise: float = 1e-3) -> Problem:
    """Config 1: 100 blocks x dim-10, dense A (1k x 1k)."""
    rng = np.random.default_rng(seed)
    sizes = np.full(num_blocks, dim, dtype=np.int64)
    n = int(sizes.sum())
    A = rng.standard_normal((m, n)) / np.sqrt(n)
    x_true = random_block_x(rng, sizes)
    b = A @ x_true + noise * rng.standard_normal(m)
    return Problem(A=DenseMatrix(A), b=b,
                   partition=BlockPartition.from_sizes(sizes),
                   name="tiny_dense", x_true=x_true)


def _route_incidence(rng: np.random.Generator, sizes: np.ndarray, m: int,
                     route_len_lo: int, route_len_hi: int,
                     demand_lo: float = 1.0, demand_hi: float = 100.0):
    """Build a route->link incidence matrix in column-ELL form (vectorised).

    Column j (a route) touches ``L_j`` random links with value = the OD
    demand of its block (demand-scaled incidence, as in route-flow
    estimation where x holds route *fractions* per OD).  Repeated link
    draws within a route are coalesced (entry = summed demand) so the
    stored ELL satisfies the no-duplicate-coordinates invariant that
    diag(A^T A) consumers rely on — A as an operator is unchanged.
    Returns (EllMatrix, demands_per_block).
    """
    n = int(np.sum(sizes))
    B = len(sizes)
    demands = rng.uniform(demand_lo, demand_hi, size=B)
    col_demand = np.repeat(demands, sizes)
    k = route_len_hi
    lens = rng.integers(route_len_lo, route_len_hi + 1, size=n)
    active = np.arange(k)[None, :] < lens[:, None]
    rows = np.where(active, rng.integers(0, m, size=(n, k)), 0).astype(np.int32)
    vals = np.where(active, col_demand[:, None], 0.0)
    return EllMatrix(rows=rows, vals=vals, num_rows=m).coalesce(), demands


def medium_sparse(seed: int = 0, num_blocks: int = 10_000, dim_lo: int = 3,
                  dim_hi: int = 8, m: int = 100_000, noise: float = 1e-2) -> Problem:
    """Config 2: 10k blocks, sparse A (~100k x 50k)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(dim_lo, dim_hi + 1, size=num_blocks).astype(np.int64)
    A, _ = _route_incidence(rng, sizes, m, route_len_lo=4, route_len_hi=12)
    x_true = random_block_x(rng, sizes)
    b = A.matvec(x_true) + noise * rng.standard_normal(m)
    return Problem(A=A, b=b, partition=BlockPartition.from_sizes(sizes),
                   name="medium_sparse", x_true=x_true)


def medium_banded(seed: int = 0, num_blocks: int = 10_000, dim_lo: int = 3,
                  dim_hi: int = 8, m: int = 100_000, spread: int = 150,
                  noise: float = 1e-2) -> Problem:
    """Corridor-structured medium instance: each OD block's routes traverse
    links near a block-specific corridor center (the realistic regime —
    routes are spatially local), so the incidence matrix is bandable and
    the banded-split layout (``ops/banded.py``) applies.  Same scale and demand
    model as ``medium_sparse``; only the link-locality differs."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(dim_lo, dim_hi + 1, size=num_blocks).astype(np.int64)
    n = int(sizes.sum())
    B = len(sizes)
    demands = rng.uniform(1.0, 100.0, size=B)
    col_demand = np.repeat(demands, sizes)
    centers_b = rng.uniform(0, m, size=B)
    centers = np.repeat(centers_b, sizes)
    k = 12
    lens = rng.integers(4, k + 1, size=n)
    active = np.arange(k)[None, :] < lens[:, None]
    offs = rng.integers(-spread, spread + 1, size=(n, k))
    rows = np.clip(centers[:, None] + offs, 0, m - 1).astype(np.int32)
    rows = np.where(active, rows, 0)
    vals = np.where(active, col_demand[:, None], 0.0)
    A = EllMatrix(rows=rows, vals=vals, num_rows=m).coalesce()
    x_true = random_block_x(rng, sizes)
    b = A.matvec(x_true) + noise * rng.standard_normal(m)
    return Problem(A=A, b=b, partition=BlockPartition.from_sizes(sizes),
                   name="medium_banded", x_true=x_true)


def traffic_like(seed: int = 0, num_blocks: int = 500, dim_lo: int = 2, dim_hi: int = 12,
                 m: int = 2_000, num_eq: int = 50, noise: float = 0.0) -> Problem:
    """Config 3: traffic route-flow with equality constraints.

    Equality rows model exact auxiliary measurements (e.g. cellpath counts):
    each row sums a random subset of routes' scaled flows and is satisfied
    exactly by the planted ``x_true``.
    """
    rng = np.random.default_rng(seed)
    sizes = rng.integers(dim_lo, dim_hi + 1, size=num_blocks).astype(np.int64)
    n = int(sizes.sum())
    A, _ = _route_incidence(rng, sizes, m, route_len_lo=3, route_len_hi=10)
    x_true = random_block_x(rng, sizes)
    b = A.matvec(x_true) + noise * rng.standard_normal(m)
    C = np.zeros((num_eq, n))
    for i in range(num_eq):
        sel = rng.choice(n, size=rng.integers(5, 30), replace=False)
        C[i, sel] = rng.uniform(0.5, 2.0, size=sel.size)
    d = C @ x_true
    return Problem(A=A, b=b, partition=BlockPartition.from_sizes(sizes),
                   C=DenseMatrix(C), d=d, name="traffic_like", x_true=x_true)


def large_sharded(seed: int = 0, num_blocks: int = 1_000_000, dim: int = 8,
                  m: int = 262_144, num_scenarios: int = 4,
                  block_multiple: int = 8, noise: float = 1e-2) -> Problem:
    """Config 4: 1M uniform blocks, multi-RHS scenarios.

    Uniform block dim keeps a single bucket; ``block_multiple`` pads the
    block count for even sharding over the 'block' mesh axis.
    """
    rng = np.random.default_rng(seed)
    sizes = np.full(num_blocks, dim, dtype=np.int64)
    n = num_blocks * dim
    # vectorised sparse incidence: each route hits `k` random links
    k = 6
    rows = rng.integers(0, m, size=(n, k)).astype(np.int32)
    demands = rng.uniform(1.0, 100.0, size=num_blocks)
    vals = np.repeat(demands, dim)[:, None] * np.ones((1, k))
    A = EllMatrix(rows=rows, vals=vals, num_rows=m).coalesce()
    # one planted flow per scenario (vectorised Dirichlet per block)
    g = rng.gamma(0.3, size=(num_scenarios, num_blocks, dim)) + 1e-12
    xs = g / g.sum(axis=-1, keepdims=True)
    xs = xs.reshape(num_scenarios, n)
    b = np.stack([A.matvec(xs[s]) for s in range(num_scenarios)])
    b += noise * rng.standard_normal(b.shape)
    part = BlockPartition.from_sizes(sizes, block_multiple=block_multiple)
    return Problem(A=A, b=b, partition=part, name="large_sharded", x_true=xs)


def with_scenarios(prob: Problem, num_scenarios: int, seed: int = 1,
                   noise: float = 1e-2) -> Problem:
    """Expand a single-RHS instance to S scenarios with freshly planted
    flows (multi-RHS batching axis)."""
    rng = np.random.default_rng(seed)
    sizes = prob.partition.sizes
    xs = np.stack([random_block_x(rng, sizes) for _ in range(num_scenarios)])
    b = np.stack([prob.A.matvec(xs[s]) for s in range(num_scenarios)])
    b += noise * rng.standard_normal(b.shape)
    # equality constraints carry over per scenario: d_s = C x_s (exact
    # measurements of the planted flows — noise-free by construction)
    d = (None if prob.C is None
         else np.stack([prob.C.matvec(xs[s]) for s in range(num_scenarios)]))
    return Problem(A=prob.A, b=b, partition=prob.partition,
                   C=prob.C, d=d,
                   name=prob.name + f"x{num_scenarios}", x_true=xs)


def _traffic_net(**kw):
    from .traffic import grid_traffic

    return grid_traffic(**kw)


_CONFIGS = {
    "tiny": tiny_dense,
    "medium": medium_sparse,
    "medium_banded": medium_banded,
    "traffic": _traffic_net,  # grid-network route-flow (config 3)
    "traffic_random": traffic_like,  # random-incidence variant
    "large": large_sharded,
}


def make_config(name: str, **kw) -> Problem:
    """Factory over the named benchmark configs ('tiny', 'medium', 'traffic',
    'large'); config 5 ('full sweep') reuses the largest instance across all
    solvers at the harness level."""
    if name not in _CONFIGS:
        raise KeyError(f"unknown config {name!r}; options: {sorted(_CONFIGS)}")
    return _CONFIGS[name](**kw)
