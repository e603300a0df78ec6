"""Community census (PyTorch).

Counterpart of ``graphmine_tpu/ops/census.py``: vertex and intra-community
edge counts per label, as bincounts on the graph's device.
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph


def community_sizes(labels: torch.Tensor) -> torch.Tensor:
    """Vertex count per label value, shape ``[V]`` (0 for unused labels)."""
    return torch.bincount(labels, minlength=labels.shape[0])


def community_edge_counts(labels: torch.Tensor, graph: Graph) -> torch.Tensor:
    """Intra-community edge count per label value, shape ``[V]``."""
    ls, ld = labels[graph.src], labels[graph.dst]
    counts = torch.zeros(labels.shape[0], dtype=torch.int64, device=labels.device)
    return counts.index_add_(0, ls, (ls == ld).to(torch.int64))


def census_table(labels: torch.Tensor, graph: Graph):
    """Host summary over present labels only: ``(label values, vertex
    counts, intra-edge counts)`` as NumPy arrays."""
    sizes = community_sizes(labels).cpu().numpy()
    edges = community_edge_counts(labels, graph).cpu().numpy()
    present = np.flatnonzero(sizes > 0)
    return present, sizes[present], edges[present]
