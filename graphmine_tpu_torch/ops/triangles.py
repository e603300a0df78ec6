"""Triangle counting and local clustering coefficients.

Counterpart of ``graphmine_tpu/ops/triangles.py``. Degree-ordered wedge
checking: the host simplifies the edges (dedup, no self-loops), orients
each from lower to higher (degree, id) rank and expands the exact wedge
list; the device binary-searches each wedge's closing edge in the
oriented CSR and credits every triangle to its three corners. Counts are
exact integers, equal to the JAX package's. The wedge-sampled estimator
(host NumPy, a stateless hash of (seed, vertex, sample)) replaces the
exact expansion where the wedge count is too large.
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph, simple_undirected_edges


def _oriented_csr(graph: Graph, simple_edges=None):
    """Host-side: simple undirected edges oriented by (degree, id) rank.

    Returns ``(ptr, col, wedge_u, wedge_v, wedge_w, simple_degree,
    wedge_e1, wedge_e2)``: the last two are each wedge's edge indices into
    ``col`` (the edge order), the generating edge ``(u, v)`` and the row
    entry ``(u, w)``; k-truss finds the third side by its binary search.
    ``simple_edges``: optional precomputed :func:`simple_undirected_edges`
    result — the driver's wedge-budget probe already paid that dedup.
    """
    v = graph.num_vertices
    a, b = simple_edges or simple_undirected_edges(graph)

    deg = np.bincount(a, minlength=v) + np.bincount(b, minlength=v)
    # orient small rank -> large rank; rank = (degree, id)
    rank = deg.astype(np.int64) * v + np.arange(v)
    lo = np.where(rank[a] <= rank[b], a, b)
    hi = np.where(rank[a] <= rank[b], b, a)

    order = np.lexsort((hi, lo))
    lo, hi = lo[order], hi[order]
    counts = np.bincount(lo, minlength=v)
    ptr = np.zeros(v + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])

    # wedge expansion: edge (u, v) x each w in N+(u)
    d_u = counts[lo]
    wedge_u = np.repeat(lo, d_u)
    wedge_v = np.repeat(hi, d_u)
    # w indices: for each edge e with endpoint u, the whole row of u;
    # within-run offsets computed vectorized (no per-edge host loop)
    total = int(d_u.sum())
    starts = np.cumsum(d_u) - d_u
    offsets = np.arange(total, dtype=np.int64) - np.repeat(starts, d_u)
    wedge_e2 = np.repeat(ptr[lo], d_u) + offsets
    wedge_w = hi[wedge_e2]
    wedge_e1 = np.repeat(np.arange(len(lo), dtype=np.int64), d_u)
    return (
        ptr.astype(np.int64), hi.astype(np.int32),
        wedge_u.astype(np.int32), wedge_v.astype(np.int32), wedge_w.astype(np.int32),
        deg.astype(np.int32), wedge_e1, wedge_e2,
    )


def _count_device(ptr, col, wedge_v, wedge_w, wedge_u, num_vertices: int,
                  search_iters: int):
    """Is (v, w) an oriented edge? A fixed-count binary search per wedge
    over the oriented CSR, then three bincounts credit u, v and w."""
    lo = ptr[wedge_v]
    hi = ptr[wedge_v + 1]
    last = col.shape[0] - 1
    for _ in range(search_iters):
        mid = (lo + hi) // 2
        val = col[torch.clamp(mid, 0, last)]
        go_right = (val < wedge_w) & (mid < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, torch.maximum(mid, lo))
    found = (lo < ptr[wedge_v + 1]) & (col[torch.clamp(lo, 0, last)] == wedge_w)
    # skip degenerate wedges where v == w (the edge itself)
    found &= wedge_v != wedge_w
    hit = found.to(torch.int64)
    tri = torch.zeros(num_vertices, dtype=torch.int64, device=hit.device)
    for corner in (wedge_u, wedge_v, wedge_w):
        tri.index_add_(0, corner, hit)
    return tri.to(torch.int32), int(hit.sum())


def _triangles(graph: Graph, simple_edges=None):
    """Host build + device count once: ``(tri [V], total, simple_degree [V])``."""
    ptr, col, wu, wv, ww, deg, _, _ = _oriented_csr(graph, simple_edges)
    dev = graph.device
    deg_t = torch.from_numpy(deg).to(dev)
    if len(wu) == 0:
        return torch.zeros(graph.num_vertices, dtype=torch.int32, device=dev), 0, deg_t
    max_row = int(np.max(np.diff(ptr), initial=1))
    iters = max(int(np.ceil(np.log2(max(max_row, 2)))) + 1, 1)
    to = lambda a: torch.from_numpy(a).to(dev)
    tri, total = _count_device(
        to(ptr), to(col), to(wv), to(ww), to(wu),
        num_vertices=graph.num_vertices, search_iters=iters,
    )
    return tri, total, deg_t


def triangle_count(graph: Graph):
    """Per-vertex triangle counts ``[V]`` and the global triangle total."""
    tri, total, _ = _triangles(graph)
    return tri, total


def oriented_wedge_count(graph: Graph, simple_edges=None) -> int:
    """Exact count of oriented wedges the exact triangle pipeline would
    materialize — WITHOUT materializing them (O(E log E) host work, O(E)
    memory).

    The feasibility probe for :func:`_oriented_csr`, whose wedge expansion
    allocates ~28 bytes per wedge on the host. The pipeline driver
    compares it against a budget and falls back to
    :func:`sampled_clustering_coefficient`, whose cost is independent of
    the wedge count.
    """
    v = graph.num_vertices
    a, b = simple_edges or simple_undirected_edges(graph)
    if len(a) == 0:
        return 0
    deg = np.bincount(a, minlength=v) + np.bincount(b, minlength=v)
    rank = deg.astype(np.int64) * v + np.arange(v)
    lo = np.where(rank[a] <= rank[b], a, b)
    counts = np.bincount(lo, minlength=v).astype(np.int64)
    # each oriented edge (u, v) expands against u's whole oriented row
    return int(counts[lo].sum())


def clustering_coefficient(graph: Graph, simple_edges=None, _cached=None) -> torch.Tensor:
    """Local clustering coefficient ``[V]`` (float32): triangles through a
    vertex over its wedge count on the simplified graph. ``_cached``: a
    prior :func:`_triangles` result, so a caller needing both the counts
    and the coefficients builds the wedges once."""
    tri, _, deg = _triangles(graph, simple_edges) if _cached is None else _cached
    deg = deg.to(torch.float32)
    wedges = deg * (deg - 1.0) / 2.0
    return torch.where(
        wedges > 0, tri / torch.clamp(wedges, min=1.0), 0.0
    ).to(torch.float32)


def _splitmix64(x):
    """Vectorized splitmix64 finalizer (uint64 in, uint64 out) — the
    stateless per-(vertex, sample) RNG of the wedge sampler. uint64
    wraparound is the intended modular arithmetic."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _hash_u01(key, seed_mix):
    """Hash uint64 keys + a pre-mixed seed to float64 uniforms in [0, 1)."""
    with np.errstate(over="ignore"):
        z = _splitmix64(key ^ seed_mix)
    return (z >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))


def sampled_clustering_coefficient(
    graph: Graph, samples: int = 64, seed: int = 0,
    chunk_vertices: int = 1 << 20, simple_edges=None,
) -> np.ndarray:
    """Wedge-sampled approximate local clustering coefficient ``[V]``
    (float32, HOST NumPy) — the at-scale replacement for the exact wedge
    pipeline.

    For every vertex with simple-undirected degree >= 2, draws ``samples``
    uniform unordered neighbor pairs (distinct within each pair, drawn
    with replacement across pairs) and reports the closed fraction — an
    unbiased estimator of the exact coefficient with binomial standard
    error ``<= 1 / (2 * sqrt(samples))`` per vertex (~0.0625 at the
    default 64; the error-bound test pins a 4-sigma envelope against the
    exact pipeline). Work is O(V * samples * log E) membership binary
    searches + one O(E log E) host CSR build — independent of the wedge
    count, which is what makes the clustering feature (and therefore the
    full 8-feature LOF set) survive at the scale where the exact
    O(sum d+^2) wedge expansion is infeasible.

    Processes vertices in ``chunk_vertices`` blocks so peak scratch memory
    stays ~``chunk_vertices * samples`` words regardless of V. Draws are a
    stateless splitmix64 hash of ``(seed, vertex, sample)``, so the result
    is a pure function of the seed — changing ``chunk_vertices`` to fit
    host RAM cannot change the estimates (pinned in tests).
    ``simple_edges`` forwards a precomputed dedup (see
    :func:`_oriented_csr`).
    """
    v = graph.num_vertices
    a, b = simple_edges or simple_undirected_edges(graph)
    # full undirected adjacency CSR of the simple graph (both directions)
    nodes = np.concatenate([a, b])
    nbrs = np.concatenate([b, a])
    order = np.argsort(nodes, kind="stable")
    nbrs = nbrs[order]
    deg = np.bincount(a, minlength=v) + np.bincount(b, minlength=v)
    ptr = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    # membership oracle: composite keys of the (a < b) edge list — already
    # sorted by construction (simple_undirected_edges unpacks a sorted
    # np.unique key array, and a*v+b reconstructs it exactly)
    edge_keys = a.astype(np.int64) * v + b.astype(np.int64)

    out = np.zeros(v, np.float32)
    seed_mix = _splitmix64(np.uint64(seed & 0xFFFFFFFFFFFFFFFF))
    active = np.flatnonzero(deg >= 2)
    for lo in range(0, len(active), chunk_vertices):
        vs = active[lo:lo + chunk_vertices]
        d = deg[vs].astype(np.int64)[:, None]           # [c, 1]
        # uniform unordered distinct pair (i, j) per sample: i uniform in
        # [0, d), j = (i + 1 + uniform[0, d-1)) mod d
        s_idx = np.arange(samples, dtype=np.uint64)[None, :]
        key = vs.astype(np.uint64)[:, None] * np.uint64(2 * samples)
        r1 = _hash_u01(key + 2 * s_idx, seed_mix)
        r2 = _hash_u01(key + 2 * s_idx + np.uint64(1), seed_mix)
        i = (r1 * d).astype(np.int64)
        j = (i + 1 + (r2 * (d - 1)).astype(np.int64)) % d
        base = ptr[vs][:, None]
        n1 = nbrs[base + i].astype(np.int64)
        n2 = nbrs[base + j].astype(np.int64)
        key = np.minimum(n1, n2) * v + np.maximum(n1, n2)
        pos = np.searchsorted(edge_keys, key)
        closed = (pos < len(edge_keys)) & (
            edge_keys[np.minimum(pos, len(edge_keys) - 1)] == key
        )
        out[vs] = closed.mean(axis=1, dtype=np.float64).astype(np.float32)
    return out
