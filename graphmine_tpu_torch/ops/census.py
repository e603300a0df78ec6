"""Community census (PyTorch).

Counterpart of ``graphmine_tpu/ops/census.py``: vertex and intra-community
edge counts per label, as bincounts on the graph's device, and the
intra-community edge mask.
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph


def community_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Vertex count per label value, shape ``[V]`` (0 for unused labels)."""
    return torch.bincount(labels, minlength=labels.shape[0])


def intra_community_edge_mask(labels: torch.Tensor, graph: Graph) -> torch.Tensor:
    """Boolean ``[E]``: the edge's endpoints share a community (the induced
    subgraph of every community at once)."""
    return labels[graph.src] == labels[graph.dst]


def community_edge_counts(labels: torch.Tensor, graph: Graph) -> torch.Tensor:
    """Intra-community edge count per label value, shape ``[V]``."""
    counts = torch.zeros(labels.shape[0], dtype=torch.int64, device=labels.device)
    return counts.index_add_(0, labels[graph.src],
                             intra_community_edge_mask(labels, graph).to(torch.int64))


def census_table(labels: torch.Tensor, graph: Graph):
    """Host summary over present labels only: ``(label values int64,
    vertex counts int32, intra-edge counts int32)`` as NumPy arrays, the
    JAX package's types (the snapshot store writes them as they are)."""
    sizes = community_sizes(labels).cpu().numpy()
    edges = community_edge_counts(labels, graph).cpu().numpy()
    present = np.flatnonzero(sizes > 0)
    return present, sizes[present].astype(np.int32), edges[present].astype(np.int32)
