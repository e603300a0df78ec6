"""Label propagation (PyTorch).

Counterpart of ``graphmine_tpu/ops/lpa.py``: GraphX Pregel LPA semantics —
initial label = own id; synchronous supersteps in which every vertex
adopts the mode of its neighbours' labels (messages along both directions
of every edge, duplicates counted); exactly ``max_iter`` supersteps;
isolated vertices keep their label; ties toward the smallest label. On a
weighted graph the mode is the label of largest incoming weight sum.
"""

from __future__ import annotations

import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.segment import segment_mode


def lpa_superstep(labels: torch.Tensor, graph: Graph) -> torch.Tensor:
    """One synchronous LPA superstep: gather → segment mode → select; the
    mode weighs each message by ``graph.msg_weight`` when the graph has it."""
    msg = labels[graph.msg_send]
    mode, _ = segment_mode(graph.msg_recv, msg, graph.num_vertices, weights=graph.msg_weight)
    return torch.where(graph.degrees() > 0, mode, labels).to(torch.int32)


def label_propagation(graph: Graph, max_iter: int = 5,
                      init_labels: torch.Tensor | None = None,
                      return_history: bool = False, plan=None):
    """Run ``max_iter`` LPA supersteps; returns int32 labels ``[V]``.

    ``plan``: a :class:`~graphmine_tpu_torch.ops.bucketed_mode.BucketedModePlan`
    runs the degree-bucketed superstep (labels must stay in ``[0, V)``, as
    the default initialization guarantees); ``None`` runs the sort-based
    superstep. Labels are identical either way.

    With ``return_history=True`` also returns the per-superstep count of
    changed labels (int32 ``[max_iter]``).
    """
    from graphmine_tpu_torch.ops.bucketed_mode import lpa_superstep_bucketed

    labels = (
        torch.arange(graph.num_vertices, dtype=torch.int32, device=graph.device)
        if init_labels is None else init_labels.to(torch.int32)
    )
    changed = []
    for _ in range(max_iter):
        new = (lpa_superstep(labels, graph) if plan is None
               else lpa_superstep_bucketed(labels, graph, plan))
        changed.append((new != labels).sum(dtype=torch.int32))
        labels = new
    if return_history:
        hist = (torch.stack(changed) if changed
                else torch.zeros(0, dtype=torch.int32, device=labels.device))
        return labels, hist
    return labels


def num_communities(labels: torch.Tensor) -> int:
    """Distinct-label count."""
    return int(torch.unique(labels).numel())


def canonicalize(labels: torch.Tensor) -> torch.Tensor:
    """Relabel communities to dense ids ordered by first member vertex."""
    v = labels.shape[0]
    idx = labels.to(torch.int64)
    first_member = torch.full((v,), v, dtype=torch.int64, device=labels.device)
    first_member.scatter_reduce_(0, idx, torch.arange(v, device=labels.device), "amin")
    rep = first_member[idx]
    return torch.searchsorted(torch.unique(rep), rep).to(torch.int32)
