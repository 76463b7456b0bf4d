"""Traffic-network route-flow instances (benchmark config 3).

Generates a directed grid road network, samples OD pairs with candidate
routes (perturbed-weight shortest paths, so routes of one OD overlap
realistically), and builds the demand-scaled link-route incidence A with
observed link counts b: real-network incidence A, equality-constrained
block-simplex least squares.  Equality constraints model exact auxiliary
measurements (cellpath/cordon counts) satisfied by the planted flow.

Pure numpy; no network libraries required.  A copy of
``bsls_tpu/models/traffic.py`` with the same draw order: the same seed gives
the same arrays, bit for bit, in both packages.
"""
from __future__ import annotations

import heapq

import numpy as np

from .partition import BlockPartition
from .problem import DenseMatrix, EllMatrix, Problem

__all__ = ["grid_network", "k_routes", "grid_traffic"]


def grid_network(nx: int, ny: int):
    """Directed 4-neighbour grid. Returns (num_nodes, edges, adj) where
    edges is a (E, 2) array of (u, v) and adj maps u -> list of (v, edge_id)."""
    def nid(i, j):
        return i * ny + j

    edges = []
    for i in range(nx):
        for j in range(ny):
            u = nid(i, j)
            if i + 1 < nx:
                edges.append((u, nid(i + 1, j)))
                edges.append((nid(i + 1, j), u))
            if j + 1 < ny:
                edges.append((u, nid(i, j + 1)))
                edges.append((nid(i, j + 1), u))
    edges = np.asarray(edges, dtype=np.int64)
    adj: dict[int, list[tuple[int, int]]] = {}
    for e, (u, v) in enumerate(edges):
        adj.setdefault(int(u), []).append((int(v), e))
    return nx * ny, edges, adj


def _dijkstra_path(adj, weights, src: int, dst: int):
    """Edge list of the min-weight path src->dst (or None)."""
    dist = {src: 0.0}
    prev: dict[int, tuple[int, int]] = {}
    pq = [(0.0, src)]
    seen = set()
    while pq:
        d, u = heapq.heappop(pq)
        if u in seen:
            continue
        seen.add(u)
        if u == dst:
            break
        for v, e in adj.get(u, ()):
            nd = d + weights[e]
            if nd < dist.get(v, np.inf):
                dist[v] = nd
                prev[v] = (u, e)
                heapq.heappush(pq, (nd, v))
    if dst not in prev and dst != src:
        return None
    path = []
    u = dst
    while u != src:
        pu, e = prev[u]
        path.append(e)
        u = pu
    return path[::-1]


def k_routes(adj, num_edges: int, src: int, dst: int, k: int, rng) -> list[list[int]]:
    """Up to k distinct routes src->dst via randomly perturbed edge weights
    (a cheap stand-in for k-shortest-paths; routes overlap heavily, as real
    candidate route sets do)."""
    routes: list[list[int]] = []
    seen: set[tuple[int, ...]] = set()
    base = np.ones(num_edges)
    for _ in range(4 * k):
        w = base * rng.uniform(1.0, 1.8, size=num_edges)
        p = _dijkstra_path(adj, w, src, dst)
        if p is None:
            break
        key = tuple(p)
        if key not in seen:
            seen.add(key)
            routes.append(p)
        if len(routes) >= k:
            break
    return routes


def grid_traffic(
    seed: int = 0,
    nx: int = 16,
    ny: int = 16,
    num_od: int = 300,
    routes_lo: int = 2,
    routes_hi: int = 6,
    demand_lo: float = 1.0,
    demand_hi: float = 100.0,
    noise: float = 1e-3,
    num_eq: int = 40,
    sensor_frac: float = 1.0,
) -> Problem:
    """Build a grid-network route-flow instance.

    ``sensor_frac`` < 1 keeps only a random subset of links as observed
    rows of A (unobserved links are simply not measured — the
    under-determined regime route-flow estimation lives in).
    """
    rng = np.random.default_rng(seed)
    n_nodes, edges, adj = grid_network(nx, ny)
    E = len(edges)

    blocks: list[list[list[int]]] = []  # per OD: list of routes (edge lists)
    tries = 0
    while len(blocks) < num_od and tries < 20 * num_od:
        tries += 1
        src, dst = rng.integers(0, n_nodes, size=2)
        if src == dst:
            continue
        k = int(rng.integers(routes_lo, routes_hi + 1))
        rts = k_routes(adj, E, int(src), int(dst), k, rng)
        if len(rts) >= 1:
            blocks.append(rts)

    sizes = np.asarray([len(b) for b in blocks], dtype=np.int64)
    n = int(sizes.sum())
    demands = rng.uniform(demand_lo, demand_hi, size=len(blocks))

    # observed links
    if sensor_frac < 1.0:
        obs = np.sort(rng.choice(E, size=max(1, int(sensor_frac * E)), replace=False))
        row_of_edge = -np.ones(E, dtype=np.int64)
        row_of_edge[obs] = np.arange(obs.size)
        m = obs.size
    else:
        row_of_edge = np.arange(E)
        m = E

    kmax = max(max(len(r) for rts in blocks for r in rts), 1)
    rows = np.zeros((n, kmax), dtype=np.int32)
    vals = np.zeros((n, kmax), dtype=np.float64)
    col = 0
    for bi, rts in enumerate(blocks):
        for r in rts:
            robs = [row_of_edge[e] for e in r if row_of_edge[e] >= 0]
            rows[col, : len(robs)] = robs
            vals[col, : len(robs)] = demands[bi]
            col += 1
    A = EllMatrix(rows=rows, vals=vals, num_rows=m)

    # planted route fractions (concentrated on the shortest candidates)
    x_parts = []
    for rts in blocks:
        g = rng.gamma(0.5, size=len(rts)) + 1e-12
        x_parts.append(g / g.sum())
    x_true = np.concatenate(x_parts)
    b = A.matvec(x_true) + noise * rng.standard_normal(m)

    C = d = None
    if num_eq > 0:
        C_ = np.zeros((num_eq, n))
        for i in range(num_eq):
            sel = rng.choice(n, size=int(rng.integers(5, max(6, n // 20))), replace=False)
            C_[i, sel] = 1.0  # exact counts of a route subset (cellpath/cordon)
        C = DenseMatrix(C_)
        d = C_ @ x_true

    return Problem(
        A=A, b=b, partition=BlockPartition.from_sizes(sizes),
        C=C, d=d, name=f"grid_traffic_{nx}x{ny}", x_true=x_true,
    )
