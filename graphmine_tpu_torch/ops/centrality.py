"""HITS, eigenvector, Katz, betweenness and closeness centrality (PyTorch).

Counterpart of ``graphmine_tpu/ops/centrality.py``, with the same
semantics (NetworkX's). HITS, eigenvector and Katz are power iterations
over the gather + segment-sum machinery of PageRank
(:class:`~graphmine_tpu_torch.ops.segment.SegmentSums`: fixed-order float
sums, one sort per call); each stops on the JAX package's rule, read on
the host once per iteration. Betweenness is Brandes' algorithm as level
sweeps over lane blocks of sources, in float32 as in the JAX package.
Closeness runs on :func:`~graphmine_tpu_torch.ops.paths.shortest_paths`.
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.paths import UNREACHABLE, shortest_paths
from graphmine_tpu_torch.ops.segment import SegmentSums


def _in_edges(graph: Graph):
    """``(send, recv)`` int64 of the adjacency ``Aᵀx`` reads: both
    directions of every edge on a symmetric graph, the edges otherwise."""
    if graph.symmetric:
        return graph.msg_send.to(torch.int64), graph.msg_recv
    return graph.src.to(torch.int64), graph.dst


def hits(graph: Graph, max_iter: int = 100, tol: float = 1e-8):
    """HITS hub and authority scores ``([V], [V])``, NetworkX semantics:
    ``a = Aᵀh``, ``h = Aa``, each scaled by its max, until the L1 hub
    delta falls below ``tol`` or ``max_iter``; both sum-normalized at the
    end. Use a ``symmetric=False`` graph (directed edges)."""
    v, dev = graph.num_vertices, graph.device
    src, dst = graph.src.to(torch.int64), graph.dst.to(torch.int64)
    to_dst, to_src = SegmentSums(dst, v), SegmentSums(src, v)
    h = torch.full((v,), 1.0 / v, dtype=torch.float32, device=dev)
    a = torch.zeros(v, dtype=torch.float32, device=dev)
    tol = float(np.float32(tol))
    err, it = float("inf"), 0
    while err >= tol and it < max_iter:
        a = to_dst.sum(h[src])
        h_new = to_src.sum(a[dst])
        h_new = h_new / torch.clamp(h_new.max(), min=1e-30)
        a = a / torch.clamp(a.max(), min=1e-30)
        err = float((h_new - h).abs().sum())
        h, it = h_new, it + 1
    h = h / torch.clamp(h.sum(), min=1e-30)
    a = a / torch.clamp(a.sum(), min=1e-30)
    return h, a


def eigenvector_centrality(graph: Graph, max_iter: int = 100, tol: float = 1e-6) -> torch.Tensor:
    """Eigenvector centrality ``[V]``: power iteration on ``x + Aᵀx``,
    L2-normalized, until the L1 change falls below ``V * tol`` (as
    ``nx.eigenvector_centrality``). Use a symmetric graph for the
    undirected notion."""
    v, dev = graph.num_vertices, graph.device
    send, recv = _in_edges(graph)
    sums = SegmentSums(recv, v)
    x = torch.full((v,), 1.0 / v, dtype=torch.float32, device=dev)
    bound = float(np.float32(v) * np.float32(tol))
    err, it = float("inf"), 0
    while err >= bound and it < max_iter:
        nxt = x + sums.sum(x[send])
        nxt = nxt / torch.clamp(torch.sqrt((nxt * nxt).sum()), min=1e-30)
        err = float((nxt - x).abs().sum())
        x, it = nxt, it + 1
    return x


def katz_centrality(graph: Graph, alpha: float = 0.1, beta: float = 1.0,
                    max_iter: int = 1000, tol: float = 1e-6,
                    normalized: bool = True) -> torch.Tensor:
    """Katz centrality ``[V]``: fixpoint of ``x = alpha·Aᵀx + beta``
    (NetworkX semantics, L2-normalized when ``normalized``); ``alpha`` must
    be below ``1/λ_max`` to converge."""
    v, dev = graph.num_vertices, graph.device
    send, recv = _in_edges(graph)
    sums = SegmentSums(recv, v)
    a = torch.tensor(alpha, dtype=torch.float32, device=dev)
    b = torch.tensor(beta, dtype=torch.float32, device=dev)
    x = torch.zeros(v, dtype=torch.float32, device=dev)
    bound = float(np.float32(v) * np.float32(tol))
    err, it = float("inf"), 0
    while err >= bound and it < max_iter:
        nxt = a * sums.sum(x[send]) + b
        err = float((nxt - x).abs().sum())
        x, it = nxt, it + 1
    if normalized:
        x = x / torch.clamp(torch.sqrt((x * x).sum()), min=1e-30)
    return x


def betweenness_centrality(graph: Graph, sources=None, normalized: bool = True,
                           directed: bool | None = None, source_batch: int = 8,
                           mesh=None) -> torch.Tensor:
    """Betweenness centrality ``[V]`` (float32), Brandes' algorithm as
    level sweeps: a BFS forward pass counts shortest paths level by level,
    a backward pass accumulates pair dependencies, ``source_batch``
    sources at a time. ``sources=None`` runs every vertex (exact); an id
    array runs the sampled estimator scaled by ``V/k``. Parallel edges
    count as distinct shortest paths. ``directed`` defaults to ``not
    graph.symmetric``; undirected scores are halved, ``normalized``
    applies NetworkX's ``1/((V-1)(V-2))`` (×2 undirected). ``mesh`` (the
    JAX package's source-sharded run) waits for ROADMAP item A7b."""
    if mesh is not None:
        raise NotImplementedError(
            "betweenness_centrality over a mesh (the source-sharded run) is not "
            "ported; it waits for ROADMAP queue 1 item A7b (multi-device)"
        )
    v, dev = graph.num_vertices, graph.device
    if directed is None:
        directed = not graph.symmetric
    src, dst = graph.src.to(torch.int64), graph.dst.to(torch.int64)
    send, recv = (src, dst) if directed else (torch.cat([src, dst]), torch.cat([dst, src]))
    if sources is None:
        src_ids = torch.arange(v, dtype=torch.int64, device=dev)
    else:
        src_ids = torch.as_tensor(np.atleast_1d(np.asarray(sources, np.int64)), device=dev)
    k = int(src_ids.shape[0])
    b = max(1, min(source_batch, k))
    pad = (-k) % b
    tiles = torch.cat([src_ids, src_ids.new_zeros(pad)]).reshape(-1, b)
    valid = (torch.arange(k + pad, device=dev) < k).reshape(-1, b)
    fwd, bwd = SegmentSums(recv, v), SegmentSums(send, v)
    bc = torch.zeros(v, dtype=torch.float32, device=dev)
    for srcs, ok in zip(tiles, valid):
        bc = bc + _brandes_tile(srcs, ok, send, recv, fwd, bwd, v)
    if not directed:
        bc = bc / 2.0
    if sources is not None and k and k < v:
        bc = bc * np.float32(v / k)
    if normalized and v > 2:
        scale = 1.0 / ((v - 1) * (v - 2))
        if not directed:
            scale *= 2.0
        bc = bc * np.float32(scale)
    return bc


def _brandes_tile(srcs, valid, send, recv, fwd: SegmentSums, bwd: SegmentSums,
                  v: int) -> torch.Tensor:
    """Dependency accumulation for one lane block of sources: ``[V]``.
    ``fwd`` sums messages at their receivers, ``bwd`` at their senders."""
    dev = srcs.device
    b = srcs.shape[0]
    lanes = torch.arange(b, device=dev)
    unreach = v + 1
    dist = torch.full((v, b), unreach, dtype=torch.int32, device=dev)
    dist[srcs, lanes] = 0
    sigma = torch.zeros((v, b), dtype=torch.float32, device=dev)
    sigma.index_put_((srcs, lanes), torch.ones(b, device=dev), accumulate=True)
    depth, progressed = 0, 1
    while progressed > 0 and depth < v:
        on_level = dist[send] == depth
        contrib = fwd.sum(torch.where(on_level, sigma[send], 0.0))
        newly = (dist == unreach) & (contrib > 0)
        dist = torch.where(newly, depth + 1, dist)
        sigma = torch.where(newly, contrib, sigma)
        progressed = int(newly.sum())
        depth += 1
    delta = torch.zeros((v, b), dtype=torch.float32, device=dev)
    dist_send, dist_recv = dist[send], dist[recv]
    ratio = sigma[send] / torch.clamp(sigma[recv], min=1.0)
    for level in range(depth - 1, -1, -1):
        on_sp = (dist_send == level) & (dist_recv == level + 1)
        back = bwd.sum(torch.where(on_sp, ratio * (1.0 + delta[recv]), 0.0))
        delta = torch.where(dist == level, back, delta)
    delta[srcs, lanes] = 0.0
    return torch.where(valid[None, :], delta, 0.0).sum(dim=1)


def closeness_centrality(graph: Graph, vertices=None, wf_improved: bool = True) -> torch.Tensor:
    """Closeness centrality for ``vertices`` (default: all), ``[L]``
    float32, NetworkX semantics: ``(r-1)/s`` for ``r`` vertices reaching
    the vertex at total distance ``s``, scaled by ``(r-1)/(V-1)`` when
    ``wf_improved``. A symmetric graph gives the undirected notion, a
    ``symmetric=False`` one directed closeness over incoming paths."""
    v = graph.num_vertices
    idx = (np.arange(v, dtype=np.int32) if vertices is None
           else np.atleast_1d(np.asarray(vertices, np.int32)))
    direction = "both" if graph.symmetric else "out"
    dist = shortest_paths(graph, idx, direction=direction)
    reach = dist < UNREACHABLE
    total = torch.where(reach, dist, 0).to(torch.float32).sum(dim=0)
    r = reach.sum(dim=0).to(torch.float32)
    c = torch.where(total > 0, (r - 1.0) / torch.clamp(total, min=1.0),
                    torch.zeros_like(total))
    if wf_improved:
        c = c * (r - 1.0) / max(v - 1, 1)
    return c
