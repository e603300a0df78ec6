"""Community detection by label propagation (LDBC Graphalytics CDLP, the
GraphX ``labelPropagation`` the reference calls).

Every vertex starts with its own id as label. In each of ``max_iter``
synchronous supersteps every vertex takes the label that is most frequent
among its neighbours, ties to the smallest label; a vertex with no
neighbour keeps its label. Each edge sends its label both ways, and an
edge that is listed twice counts twice.
"""

from __future__ import annotations

import torch


def cdlp(src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
         max_iter: int) -> torch.Tensor:
    """int64 labels ``[V]`` after ``max_iter`` supersteps, on the edges'
    device."""
    v = int(num_vertices)
    recv = torch.cat([dst, src]).to(torch.int64)
    send = torch.cat([src, dst]).to(torch.int64)
    labels = torch.arange(v, dtype=torch.int64, device=src.device)
    for _ in range(max_iter):
        # one row per distinct (receiver, label) pair, with its count
        pairs, counts = torch.unique(recv * v + labels[send], return_counts=True)
        r, lab = pairs // v, pairs % v
        del pairs
        best = torch.zeros(v, dtype=counts.dtype, device=src.device).scatter_reduce_(
            0, r, counts, "amax")
        top = counts == best[r]
        pick = torch.full((v,), v, dtype=torch.int64, device=src.device).scatter_reduce_(
            0, r[top], lab[top], "amin")
        labels = torch.where(pick < v, pick, labels)
    return labels
