"""k-core decomposition via iterated neighbourhood H-indices (PyTorch).

Counterpart of ``graphmine_tpu/ops/kcore.py`` (Lü et al., "The H-index of
a network node"): ``h[v] = degree(v)``, then repeatedly ``h[v]`` = the
H-index of its neighbours' values (the largest ``x`` such that at least
``x`` neighbours have ``h >= x``); the fixpoint is the core number. A
sweep sorts (vertex, -h) message pairs, ranks each within its vertex's
run and takes ``segment_max(min(h_sorted, rank + 1))``. Integer work
throughout, so the answers equal the JAX package's on every device.

Operates on the simple undirected graph (duplicates and self-loops
dropped), the standard k-core convention.
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph, simple_undirected_edges
from graphmine_tpu_torch.ops.segment import segment_max

_INT32_MIN = -(1 << 31)


def _simple_messages(graph: Graph):
    """Host-side: symmetric message list of the simplified graph."""
    a, b = simple_undirected_edges(graph)
    recv = np.concatenate([a, b])
    send = np.concatenate([b, a])
    order = np.argsort(recv, kind="stable")
    return recv[order], send[order]


def _core_device(recv: torch.Tensor, send: torch.Tensor, num_vertices: int,
                 max_iter: int) -> torch.Tensor:
    v = num_vertices
    recv, send = recv.to(torch.int64), send.to(torch.int64)
    h = torch.bincount(recv, minlength=v).to(torch.int32)
    pos = torch.arange(recv.shape[0], dtype=torch.int64, device=recv.device)

    def hindex_sweep(h):
        neg_h = -h[send].to(torch.int64)
        # one int64 key sorts (vertex, -h): the vertex in the high 32 bits
        key, _ = torch.sort((recv << 32) | (neg_h - _INT32_MIN))
        seg_s = key >> 32
        negh_s = (key & 0xFFFFFFFF) + _INT32_MIN
        new_seg = torch.ones(key.shape[0], dtype=torch.bool, device=key.device)
        new_seg[1:] = seg_s[1:] != seg_s[:-1]
        run_start = torch.cummax(torch.where(new_seg, pos, -1), 0).values
        rank = pos - run_start  # 0-based position within the vertex's run
        cand = torch.minimum(-negh_s, rank + 1).to(torch.int32)
        # empty segments (isolated vertices) come back as int32 min; their
        # core number is 0
        return torch.clamp(segment_max(cand, seg_s, v), min=0)

    changed, it = 1, 0
    while changed > 0 and it < max_iter:
        new = torch.minimum(h, hindex_sweep(h))
        changed = int((new != h).sum())
        h, it = new, it + 1
    return h


def core_numbers(graph: Graph, max_iter: int = 0) -> torch.Tensor:
    """Core number per vertex, int32 ``[V]`` (0 for isolated vertices)."""
    recv, send = _simple_messages(graph)
    if len(recv) == 0:
        return torch.zeros(graph.num_vertices, dtype=torch.int32, device=graph.device)
    limit = max_iter if max_iter > 0 else graph.num_vertices + 1
    return _core_device(torch.from_numpy(recv).to(graph.device),
                        torch.from_numpy(send).to(graph.device),
                        num_vertices=graph.num_vertices, max_iter=limit)
