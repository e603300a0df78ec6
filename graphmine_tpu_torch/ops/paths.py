"""BFS distances and landmark shortest paths (PyTorch).

Counterpart of ``graphmine_tpu/ops/paths.py``: distances are dense int32
vectors; one superstep relaxes every edge with a gather and a segment
minimum (Bellman-Ford over unit weights), repeated until a superstep
changes nothing. Each loop reads the changed count on the host once a
superstep. Minima are exact in any order, so the answers equal the JAX
package's on every device.

Direction conventions: ``direction="out"`` follows edge direction (src ->
dst); ``direction="both"`` treats edges as undirected (the symmetric
message CSR).
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.segment import segment_min

UNREACHABLE = (1 << 31) - 1


def _edges(graph: Graph, direction: str):
    if direction == "out":
        return graph.src, graph.dst
    if direction == "both":
        if not graph.symmetric:
            raise ValueError(
                "direction='both' needs a graph built with symmetric=True "
                "(the message CSR of an asymmetric graph only carries the "
                "forward direction)"
            )
        return graph.msg_send, graph.msg_recv
    raise ValueError(f"direction must be 'out' or 'both', got {direction!r}")


def _ids(values, device) -> torch.Tensor:
    """Vertex ids (host or tensor, scalar or 1-D) as an int64 1-D tensor."""
    t = values if torch.is_tensor(values) else torch.as_tensor(np.asarray(values))
    return torch.atleast_1d(t).to(device, torch.int64)


def _unit_relax(dist: torch.Tensor, send: torch.Tensor, recv: torch.Tensor,
                v: int) -> torch.Tensor:
    """One unit-weight relaxation: ``min(dist, min over in-edges of
    dist[send] + 1)``, saturating so UNREACHABLE does not wrap."""
    ds = dist[send]
    msg = torch.where(ds == UNREACHABLE, UNREACHABLE, ds + 1)
    return torch.minimum(dist, segment_min(msg, recv, v))


def _fixpoint(step, state: torch.Tensor, limit: int) -> torch.Tensor:
    """Apply ``step`` until it changes nothing or ``limit`` steps ran."""
    changed, it = 1, 0
    while changed > 0 and it < limit:
        new = step(state)
        changed = int((new != state).sum())
        state, it = new, it + 1
    return state


def bfs_distances(graph: Graph, sources, direction: str = "out",
                  max_depth: int = 0) -> torch.Tensor:
    """Hop distance from the nearest of ``sources`` to every vertex.

    Returns int32 ``[V]``; unreachable vertices get ``UNREACHABLE`` (int32
    max). ``sources`` is an int array of vertex ids.
    """
    v = graph.num_vertices
    send, recv = (t.to(torch.int64) for t in _edges(graph, direction))
    limit = max_depth if max_depth > 0 else v + 1
    dist = torch.full((v,), UNREACHABLE, dtype=torch.int32, device=graph.device)
    dist[_ids(sources, graph.device)] = 0
    return _fixpoint(lambda d: _unit_relax(d, send, recv, v), dist, limit)


def shortest_paths(graph: Graph, landmarks, direction: str = "out",
                   landmark_batch: int = 16) -> torch.Tensor:
    """Distance to each landmark, shape ``[V, L]`` (GraphFrames
    ``shortestPaths``: distance FROM each vertex TO the landmark following
    edge direction).

    Landmarks run ``landmark_batch`` at a time in one vectorized
    Bellman-Ford (a ``[M, B]`` int32 message buffer per superstep, so lower
    ``B`` on huge graphs); the tiles run one after another.
    """
    landmarks = _ids(landmarks, graph.device)
    num = int(landmarks.shape[0])
    b = max(1, min(landmark_batch, num))
    # distance v -> landmark along src->dst == distance landmark -> v along
    # reversed edges; for "both" the graph is symmetric already
    if direction == "out":
        send, recv = graph.dst, graph.src
    else:
        send, recv = _edges(graph, direction)
    send, recv = send.to(torch.int64), recv.to(torch.int64)
    pad = (-num) % b
    tiles = torch.cat([landmarks, landmarks.new_zeros(pad)]).reshape(-1, b)
    out = [_bfs_tile(t, send, recv, graph.num_vertices) for t in tiles]
    return torch.cat(out, dim=1)[:, :num]


def _bfs_tile(sources: torch.Tensor, send: torch.Tensor, recv: torch.Tensor,
              v: int) -> torch.Tensor:
    """Per-source BFS distances for one lane block: ``[V, B]``."""
    b = sources.shape[0]
    dist = torch.full((v, b), UNREACHABLE, dtype=torch.int32, device=sources.device)
    dist[sources, torch.arange(b, device=sources.device)] = 0
    return _fixpoint(lambda d: _unit_relax(d, send, recv, v), dist, v + 1)


def weighted_shortest_paths(graph: Graph, sources, weights, direction: str = "out",
                            max_iter: int = 0) -> torch.Tensor:
    """Weighted distance from the nearest of ``sources`` to every vertex:
    Bellman-Ford over the same gather + segment-minimum superstep as BFS.

    ``weights``: non-negative float ``[E]`` aligned with ``graph.src`` /
    ``graph.dst`` (for ``direction="both"`` each edge's weight applies in
    both directions). Returns float32 ``[V]`` with ``inf`` for unreachable
    vertices. Negative weights converge too (bounded by ``max_iter``,
    default V), but negative cycles are not detected.
    """
    v = graph.num_vertices
    w = torch.as_tensor(weights).to(graph.device, torch.float32)
    # NaN would poison distances and defeat the convergence check
    if bool(torch.isnan(w).any()):
        raise ValueError("weights must not contain NaN")
    if direction == "out":
        send, recv = graph.src, graph.dst
    elif direction == "both":
        # weights align with the edge list, not the sorted message CSR
        send = torch.cat([graph.src, graph.dst])
        recv = torch.cat([graph.dst, graph.src])
        w = torch.cat([w, w])
    else:
        raise ValueError(f"direction must be 'out' or 'both', got {direction!r}")
    send, recv = send.to(torch.int64), recv.to(torch.int64)
    dist = torch.full((v,), float("inf"), dtype=torch.float32, device=graph.device)
    dist[_ids(sources, graph.device)] = 0.0
    limit = max_iter if max_iter > 0 else v
    return _fixpoint(lambda d: torch.minimum(d, segment_min(d[send] + w, recv, v)), dist,
                     limit)


def bfs_parents(graph: Graph, sources, direction: str = "out",
                max_depth: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """BFS distances plus parent pointers for path reconstruction.

    Returns ``(dist, parent)``, both int32 ``[V]``. ``parent[v]`` is the
    smallest-id predecessor of ``v`` on some shortest path from ``sources``
    (-1 for sources and unreachable vertices), recovered in one extra
    relaxation pass after the distance fixpoint.
    """
    v = graph.num_vertices
    send, recv = (t.to(torch.int64) for t in _edges(graph, direction))
    dist = bfs_distances(graph, sources, direction=direction, max_depth=max_depth)
    ds = dist[send]
    on_sp = (ds != UNREACHABLE) & (dist[recv] == ds + 1)
    cand = torch.where(on_sp, send.to(torch.int32), UNREACHABLE)
    parent = segment_min(cand, recv, v)
    parent = torch.where((parent == UNREACHABLE) | (dist == 0), -1, parent)
    return dist, parent.to(torch.int32)


def bfs(graph: Graph, from_vertices, to_vertices, direction: str = "out",
        max_path_length: int = 10):
    """Shortest paths from a source set to a target set
    (``GraphFrame.bfs(fromExpr, toExpr, maxPathLength)``): the search stops
    at the first depth where any target is reached, and one shortest path
    per target at that depth is returned, as a list of int32 NumPy paths
    ``[source, ..., target]`` (empty if no target is within
    ``max_path_length`` hops). The pointer walk runs on the host.
    """
    to_np = np.atleast_1d(np.asarray(to_vertices, np.int64))
    dist, parent = bfs_parents(graph, from_vertices, direction=direction,
                               max_depth=max_path_length)
    dist, parent = dist.cpu().numpy(), parent.cpu().numpy()
    if to_np.size == 0:
        return []
    tdist = dist[to_np]
    reach = tdist != UNREACHABLE
    if not reach.any():
        return []
    best = int(tdist[reach].min())
    paths = []
    for t in to_np[reach & (tdist == best)]:
        path = [int(t)]
        while parent[path[-1]] >= 0:
            path.append(int(parent[path[-1]]))
        paths.append(np.asarray(path[::-1], dtype=np.int32))
    return paths
