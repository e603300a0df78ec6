"""Link-prediction scores for candidate vertex pairs.

Counterpart of ``graphmine_tpu/ops/linkpred.py``, the same host NumPy
over the port's :func:`~graphmine_tpu_torch.graph.container.
simple_undirected_edges`, so the scores are bit-equal to the JAX
package's.

NetworkX-parity neighborhood-overlap measures (``jaccard_coefficient``,
``adamic_adar_index``, ``common_neighbors``, ``preferential_attachment``,
``resource_allocation_index``), defined on the simple undirected graph
(duplicates and self-loops dropped, as NetworkX does).

Host-side vectorized NumPy — this is candidate-pair preprocessing (the
same class of op as the kNN feature stage), not a superstep kernel. The
membership test is one ``searchsorted`` over row-offset-encoded adjacency
(``row * V + col``, globally sorted), so cost is
``O(Σ deg(u) · log E)`` over the pairs with no per-pair Python.
"""

from __future__ import annotations

import numpy as np

from graphmine_tpu_torch.graph.container import Graph, simple_undirected_edges

_METHODS = ("common_neighbors", "jaccard", "adamic_adar",
            "resource_allocation", "preferential_attachment")


def _adjacency(graph: Graph):
    """Sorted CSR of the simple undirected graph + encoded entry list."""
    a, b = simple_undirected_edges(graph)
    v = graph.num_vertices
    src = np.concatenate([a, b]).astype(np.int64)
    dst = np.concatenate([b, a]).astype(np.int64)
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=v)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    encoded = src * v + dst  # globally ascending
    return indptr, dst, encoded, deg


def link_prediction(
    graph: Graph, pairs, method: str = "jaccard"
) -> np.ndarray:
    """Scores ``[P]`` (float64) for candidate ``pairs`` (``[P, 2]`` int
    array or iterable of 2-tuples). ``method`` is one of
    ``common_neighbors | jaccard | adamic_adar | resource_allocation |
    preferential_attachment`` (NetworkX-oracle tested)."""
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {_METHODS}")
    pairs = np.asarray(pairs, dtype=np.int64)
    if pairs.size == 0:
        return np.zeros(0, dtype=np.float64)
    pairs = np.atleast_2d(pairs)
    if pairs.shape[-1] != 2:
        raise ValueError("pairs must have shape [P, 2]")
    u, w = pairs[:, 0], pairs[:, 1]
    v = graph.num_vertices
    if (u < 0).any() or (u >= v).any() or (w < 0).any() or (w >= v).any():
        raise ValueError("pair endpoints out of range")
    if (u == w).any():
        raise ValueError("self-pairs are not valid link-prediction candidates")
    indptr, nbrs, encoded, deg = _adjacency(graph)

    if method == "preferential_attachment":
        return (deg[u] * deg[w]).astype(np.float64)

    # all overlap measures are symmetric: expand the lower-degree endpoint
    # so a (hub, leaf) pair costs deg(leaf), not deg(hub)
    swap = deg[w] < deg[u]
    u, w = np.where(swap, w, u), np.where(swap, u, w)

    # expand every pair over N(u); membership of each neighbor k in N(w)
    # via binary search on the encoded entries
    cnt = deg[u]
    total = int(cnt.sum())
    starts_out = np.cumsum(cnt) - cnt
    pid = np.repeat(np.arange(len(u)), cnt)
    pos = (np.repeat(indptr[u], cnt)
           + (np.arange(total) - np.repeat(starts_out, cnt)))
    ks = nbrs[pos]
    probe = w[pid] * v + ks
    loc = np.searchsorted(encoded, probe)
    member = (loc < len(encoded)) & (encoded[np.minimum(loc, len(encoded) - 1)]
                                     == probe)

    if method == "common_neighbors":
        vals = member.astype(np.float64)
    elif method == "adamic_adar":
        # common neighbors always have deg >= 2, so log(deg) > 0
        vals = np.where(member, 1.0 / np.log(np.maximum(deg[ks], 2)), 0.0)
    elif method == "resource_allocation":
        vals = np.where(member, 1.0 / np.maximum(deg[ks], 1), 0.0)
    else:  # jaccard
        vals = member.astype(np.float64)
    score = np.bincount(pid, weights=vals, minlength=len(u))
    if method == "jaccard":
        union = deg[u] + deg[w] - score
        return np.where(union > 0, score / np.maximum(union, 1), 0.0)
    return score
