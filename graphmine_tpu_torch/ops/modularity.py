"""Newman modularity of a community partition (PyTorch).

Counterpart of ``graphmine_tpu/ops/modularity.py::modularity``: the
symmetric message list with each message's edge weight (1 on an
unweighted graph), where a self-loop message carries weight 0 in the list and adds half its weight
per appearance to its vertex's self weight (so a self-loop adds 2 to the
vertex's degree and 2 to its community's internal weight). ``modularity``
accumulates in float64 (the census's Q; the JAX package accumulates in
float32). ``message_weights`` and ``modularity_weighted`` are the JAX
functions in float32, as Louvain and Leiden read them when they decide
on a level.
"""

from __future__ import annotations

import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.segment import segment_sum


def _require_symmetric(graph: Graph) -> None:
    if not graph.symmetric:
        raise ValueError(
            "modularity needs the symmetric message list (both edge "
            "directions); rebuild with symmetric=True"
        )


def modularity_weighted(labels: torch.Tensor, recv: torch.Tensor, send: torch.Tensor,
                        weight: torch.Tensor, self_weight: torch.Tensor, num_vertices: int,
                        gamma: float = 1.0) -> torch.Tensor:
    """Q = sum_c [ Sigma_in_c / 2m  -  gamma * (Sigma_tot_c / 2m)^2 ] in
    float32, a 0-d tensor on the inputs' device.

    ``recv``/``send``/``weight`` are the symmetric message list (self-loops
    excluded, carried in ``self_weight``). Out-of-range receivers (padding
    sentinels) are dropped.
    """
    v = num_vertices
    recv = recv.to(torch.int64)
    w = weight.to(torch.float32)
    k = segment_sum(w, recv, v) + 2.0 * self_weight
    two_m = torch.clamp(k.sum(), min=1e-12)
    labels = labels.to(torch.int64)
    valid = recv < v
    same = labels[torch.clamp(recv, max=v - 1)] == labels[send.to(torch.int64)]
    intra_msgs = torch.where(valid & same, w, 0.0).sum()
    sigma_in = intra_msgs + 2.0 * self_weight.sum()
    sigma_tot = segment_sum(k, labels, v)
    return sigma_in / two_m - gamma * torch.sum((sigma_tot / two_m) ** 2)


def message_weights(graph: Graph) -> tuple[torch.Tensor, torch.Tensor]:
    """Split a symmetric graph's messages into ``(w [M], self_w [V])``,
    float32: self-loop messages carry weight 0 in ``w`` and add half their
    weight per appearance to ``self_w`` (each self-loop edge appears twice
    in the symmetric list). Per-edge weights come from ``graph.msg_weight``
    when present, else 1."""
    _require_symmetric(graph)
    recv, send = graph.msg_recv, graph.msg_send
    is_self = recv == send
    base = (torch.ones(recv.shape[0], dtype=torch.float32, device=recv.device)
            if graph.msg_weight is None else graph.msg_weight.to(torch.float32))
    w = torch.where(is_self, 0.0, base)
    self_w = segment_sum(torch.where(is_self, 0.5 * base, 0.0), recv, graph.num_vertices)
    return w, self_w


def modularity(labels: torch.Tensor, graph: Graph, gamma: float = 1.0) -> float:
    """Q = sum_c [ Sigma_in_c / 2m  -  gamma * (Sigma_tot_c / 2m)^2 ]."""
    _require_symmetric(graph)
    v = graph.num_vertices
    recv, send = graph.msg_recv, graph.msg_send
    is_self = recv == send
    base = (torch.ones(recv.shape[0], dtype=torch.float64, device=recv.device)
            if graph.msg_weight is None else graph.msg_weight.to(torch.float64))
    w = torch.where(is_self, 0.0, base)
    self_w = torch.zeros(v, dtype=torch.float64, device=recv.device).index_add_(
        0, recv, torch.where(is_self, 0.5 * base, 0.0)
    )
    k = torch.zeros(v, dtype=torch.float64, device=recv.device).index_add_(0, recv, w)
    k = k + 2.0 * self_w
    two_m = max(float(k.sum()), 1e-12)
    intra = float(torch.where(labels[recv] == labels[send], w, 0.0).sum())
    sigma_in = intra + 2.0 * float(self_w.sum())
    sigma_tot = torch.zeros(v, dtype=torch.float64, device=recv.device).index_add_(
        0, labels, k
    )
    return sigma_in / two_m - gamma * float(((sigma_tot / two_m) ** 2).sum())
