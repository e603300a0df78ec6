"""k-truss: the maximal subgraph whose every edge closes >= k-2 triangles.

Counterpart of ``graphmine_tpu/ops/ktruss.py`` (``nx.k_truss`` parity on
the simple undirected graph). The host builds the oriented wedge list of
:func:`~graphmine_tpu_torch.ops.triangles._oriented_csr` once, each wedge
knowing the edge indices of two of its sides; on the device a binary
search finds the closing side once, then the peel runs to its fixpoint:
a triangle counts while its three edges are active, each edge's support
is three integer scatters over edge ids, and edges below ``k - 2`` drop
out. Integer counts: the kept edges equal the JAX package's on every
device.
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.triangles import _oriented_csr


def _truss_peel(ptr, col, wv, ww, e1, e2, k: int, num_edges: int,
                search_iters: int) -> torch.Tensor:
    """Active-edge mask ``[num_edges]`` of the peel's fixpoint."""
    lo, hi = ptr[wv], ptr[wv + 1]
    last = col.shape[0] - 1
    for _ in range(search_iters):
        mid = (lo + hi) // 2
        val = col[torch.clamp(mid, 0, last)]
        go_right = (val < ww) & (mid < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, torch.maximum(mid, lo))
    found = (lo < ptr[wv + 1]) & (col[torch.clamp(lo, 0, last)] == ww) & (wv != ww)
    e3 = torch.where(found, lo, 0)
    # only wedges that close a triangle take part in the peel
    e1, e2, e3 = e1[found], e2[found], e3[found]
    active = torch.ones(num_edges, dtype=torch.bool, device=col.device)
    changed = 1
    while changed > 0:
        valid = (active[e1] & active[e2] & active[e3]).to(torch.int32)
        sup = torch.zeros(num_edges, dtype=torch.int32, device=col.device)
        for e in (e1, e2, e3):
            sup.index_add_(0, e, valid)
        new_active = active & (sup >= k - 2)
        changed = int((new_active != active).sum())
        active = new_active
    return active


def k_truss(graph: Graph, k: int):
    """Edges of the ``k``-truss: host ``(a, b)`` int32 arrays with
    ``a < b``, one row per surviving undirected edge (isolated vertices
    do not appear)."""
    if k < 2:
        raise ValueError("k must be >= 2 (the 2-truss is the whole graph)")
    ptr, col, _, wv, ww, _, e1, e2 = _oriented_csr(graph)
    num_edges = len(col)
    if num_edges == 0:
        return np.zeros(0, np.int32), np.zeros(0, np.int32)
    lo_of_edge = np.repeat(np.arange(graph.num_vertices, dtype=np.int32),
                           np.diff(ptr).astype(np.int64))
    max_row = int(np.max(np.diff(ptr), initial=1))
    iters = max(int(np.ceil(np.log2(max(max_row, 2)))) + 1, 1)
    dev = graph.device
    to = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(dev)
    active = _truss_peel(to(ptr), to(col), to(wv), to(ww), to(e1), to(e2), k,
                         num_edges=num_edges, search_iters=iters).cpu().numpy()
    x, y = lo_of_edge[active], col[active]
    return np.minimum(x, y), np.maximum(x, y)
