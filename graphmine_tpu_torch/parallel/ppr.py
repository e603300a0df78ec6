"""Source-sharded personalized PageRank: the query axis over a mesh.

Counterpart of ``graphmine_tpu/parallel/ppr.py``.
:func:`~graphmine_tpu_torch.ops.pagerank.parallel_personalized_pagerank`
runs one batched ``[V, S]`` power iteration in which every source column
shares the per-edge gather and segment sum. Here the source columns are
split over the mesh: each shard holds a copy of the graph on its device
and ``ceil(S/D)`` teleport columns, and runs the same iteration on them.
The only exchange is one scalar a superstep, the largest column delta
(:func:`~graphmine_tpu_torch.parallel.mesh.pmax`), so every column stops
when the slowest one meets ``tol``, the batch's own rule; the columns are
gathered onto the mesh's home device at the end (onto every process's
own on a process mesh).
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.parallel.mesh import Mesh, gather_to, pmax


def _on_device(graph: Graph, device: torch.device) -> Graph:
    """``graph`` with its edge arrays on ``device`` (itself when already
    there); the message CSR is not needed by the PPR iteration."""
    if graph.device == device:
        return graph
    from graphmine_tpu_torch.graph.container import build_graph

    return build_graph(graph.src.cpu().numpy(), graph.dst.cpu().numpy(),
                       num_vertices=graph.num_vertices, symmetric=graph.symmetric,
                       device=device)


def sharded_personalized_pagerank(graph: Graph, sources, mesh: Mesh, alpha: float = 0.85,
                                  max_iter: int = 100, tol: float = 1e-6) -> torch.Tensor:
    """``parallel_personalized_pagerank`` with the sources split over
    ``mesh``: ``[V, S]`` on the mesh's home device, within float noise of
    the single-device batch (the same iterations; the columns are the
    same arithmetic). Padding columns recompute ``sources[0]`` and are cut
    off."""
    from graphmine_tpu_torch.ops.pagerank import _BatchedPPR, _validate_sources

    v, d = graph.num_vertices, mesh.size
    sources = _validate_sources(sources, v)
    home = mesh.home
    if sources.size == 0:
        return torch.zeros((v, 0), dtype=torch.float32, device=home)
    s = len(sources)
    chunk = -(-s // d)
    padded = np.full(d * chunk, sources[0], np.int32)
    padded[:s] = sources
    runs = mesh.each(lambda i: _BatchedPPR(_on_device(graph, mesh.devices[i]),
                                           padded[i * chunk:(i + 1) * chunk], alpha))
    prs = [None if r is None else r.pr for r in runs]
    tol = float(np.float32(tol))
    it, delta = 0, 1.0
    while delta > tol and it < max_iter:
        steps = mesh.each(lambda i: runs[i].step(prs[i]))
        prs = [None if st is None else st[0] for st in steps]
        delta = float(pmax(mesh, [None if st is None else st[1] for st in steps])
                      [mesh.local[0]])
        it += 1
    cols = [None if p is None else p.T for p in prs]
    return gather_to(cols, home, mesh).T[:, :s].contiguous()
