"""Weakly connected components (LDBC Graphalytics WCC).

Every vertex is labelled with the smallest vertex id of its component:
plain minimum-label propagation over both directions of every edge, one
superstep at a time, until a superstep changes nothing.
"""

from __future__ import annotations

import torch


def wcc(src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
        max_steps: int | None = None) -> tuple[torch.Tensor, int]:
    """``(int64 labels [V], supersteps that changed a label)``. With
    ``max_steps`` it stops after that many supersteps, fixpoint or not."""
    v = int(num_vertices)
    recv = torch.cat([dst, src]).to(torch.int64)
    send = torch.cat([src, dst]).to(torch.int64)
    labels = torch.arange(v, dtype=torch.int64, device=src.device)
    steps = 0
    while max_steps is None or steps < max_steps:
        incoming = torch.full((v,), v, dtype=torch.int64, device=src.device).scatter_reduce_(
            0, recv, labels[send], "amin")
        new = torch.minimum(labels, incoming)
        if torch.equal(new, labels):
            break
        labels = new
        steps += 1
    return labels, steps
