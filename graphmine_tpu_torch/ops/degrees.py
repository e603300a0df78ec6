"""Degree views of a graph (PyTorch).

Counterpart of ``graphmine_tpu/ops/degrees.py``: dense int32 vectors on
the graph's device, duplicate edges counted with multiplicity.
"""

from __future__ import annotations

import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.segment import segment_sum


def out_degrees(graph: Graph) -> torch.Tensor:
    return torch.bincount(graph.src.to(torch.int64),
                          minlength=graph.num_vertices).to(torch.int32)


def out_weights(graph: Graph) -> torch.Tensor:
    """Out-edge weight sums (weighted out-degree), float32; on an
    unweighted graph ``out_degrees`` as float. On a symmetric graph the
    messages flow both directions, so the sum is the undirected strength."""
    if graph.msg_weight is None:
        return out_degrees(graph).to(torch.float32)
    return segment_sum(graph.msg_weight, graph.msg_send, graph.num_vertices)


def in_degrees(graph: Graph) -> torch.Tensor:
    return torch.bincount(graph.dst.to(torch.int64),
                          minlength=graph.num_vertices).to(torch.int32)


def degrees(graph: Graph) -> torch.Tensor:
    """Undirected degree (in + out; self-loops therefore count twice)."""
    return out_degrees(graph) + in_degrees(graph)
