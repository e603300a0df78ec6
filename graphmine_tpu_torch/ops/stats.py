"""Whole-graph summary statistics: assortativity, reciprocity, density,
diameter (PyTorch port).

Counterpart of ``graphmine_tpu/ops/stats.py``. The closed-form statistics
are host NumPy O(E) reductions over the edge list, a copy of the JAX
package's host code; the diameter estimate runs the port's BFS and
connected components on the graph's device.
"""

from __future__ import annotations

import numpy as np

from graphmine_tpu_torch.graph.container import Graph, simple_undirected_edges


def degree_assortativity(graph: Graph) -> float:
    """Pearson correlation of degrees across undirected edges
    (``nx.degree_assortativity_coefficient`` on the simple graph).
    Returns NaN when every vertex has the same degree (zero variance)."""
    a, b = simple_undirected_edges(graph)
    if len(a) == 0:
        return float("nan")
    v = graph.num_vertices
    deg = np.bincount(a, minlength=v) + np.bincount(b, minlength=v)
    x = np.concatenate([deg[a], deg[b]]).astype(np.float64)
    y = np.concatenate([deg[b], deg[a]]).astype(np.float64)
    sx = x.std()
    if sx == 0:
        return float("nan")
    return float(((x - x.mean()) * (y - y.mean())).mean() / (sx * y.std()))


def _endpoints(graph: Graph) -> tuple[np.ndarray, np.ndarray]:
    return graph.src.cpu().numpy().astype(np.int64), graph.dst.cpu().numpy().astype(np.int64)


def _directed_codes(graph: Graph, drop_self_loops: bool) -> np.ndarray:
    """Distinct directed edges encoded ``src * V + dst`` (int64)."""
    src, dst = _endpoints(graph)
    if drop_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    return np.unique(src * graph.num_vertices + dst)


def reciprocity(graph: Graph) -> float:
    """Fraction of directed edges whose reverse also exists
    (``nx.reciprocity``; duplicates collapse, self-loops drop). Raises on
    symmetric graphs, where messages already flow both ways."""
    if graph.symmetric:
        raise ValueError(
            "reciprocity needs a directed graph (build_graph(symmetric=False))"
        )
    v = graph.num_vertices
    codes = _directed_codes(graph, drop_self_loops=True)
    if len(codes) == 0:
        return float("nan")
    rev = (codes % v) * v + codes // v
    return float(np.isin(codes, rev).mean())


def density(graph: Graph, directed: bool | None = None) -> float:
    """Edge density (``nx.density``: distinct edges — self-loops count —
    over ``V(V-1)`` ordered or unordered pairs)."""
    v = graph.num_vertices
    if v <= 1:
        return 0.0
    if directed is None:
        directed = not graph.symmetric
    if directed:
        e = len(_directed_codes(graph, drop_self_loops=False))
        return e / (v * (v - 1))
    src, dst = _endpoints(graph)
    e = len(np.unique(np.minimum(src, dst) * v + np.maximum(src, dst)))
    return 2.0 * e / (v * (v - 1))


def diameter(graph: Graph, exact: bool = False, seed: int = 0) -> int:
    """Longest shortest path in hops over the symmetric graph, ignoring
    unreachable pairs (largest finite eccentricity).

    Default: the double-sweep lower bound — BFS from a seeded random vertex
    of the largest component, then BFS from the farthest vertex found.
    ``exact=True`` runs BFS from every vertex through the batched
    ``shortest_paths`` tiles (``[V, V]`` distances, validation-scale graphs
    only)."""
    from graphmine_tpu_torch.ops.paths import UNREACHABLE, bfs_distances, shortest_paths

    v = graph.num_vertices
    if v == 0:
        return 0
    if exact:
        dist = shortest_paths(graph, np.arange(v, dtype=np.int32), direction="both")
        dist = dist.cpu().numpy()
        finite = dist[dist < UNREACHABLE]
        return int(finite.max(initial=0))
    # start inside the largest component, else a sweep from a small or
    # singleton component reports its tiny eccentricity
    from graphmine_tpu_torch.ops.cc import connected_components

    comp = connected_components(graph).cpu().numpy()
    vals, counts = np.unique(comp, return_counts=True)
    members = np.flatnonzero(comp == vals[counts.argmax()])
    rng = np.random.default_rng(seed)
    start = np.int32(members[rng.integers(0, len(members))])
    d1 = bfs_distances(graph, np.array([start]), direction="both").cpu().numpy()
    d1 = np.where(d1 < UNREACHABLE, d1, -1)
    far = np.int32(d1.argmax())
    d2 = bfs_distances(graph, np.array([far]), direction="both").cpu().numpy()
    d2 = np.where(d2 < UNREACHABLE, d2, -1)
    return int(max(d1.max(initial=0), d2.max(initial=0)))
