"""Newman modularity of a community partition (PyTorch).

Counterpart of ``graphmine_tpu/ops/modularity.py::modularity`` for
unweighted graphs: the symmetric message list with unit weights, where a
self-loop message carries weight 0 in the list and adds half its weight
per appearance to its vertex's self weight (so a self-loop adds 2 to the
vertex's degree and 2 to its community's internal weight). Accumulates in
float64; the JAX package accumulates in float32.
"""

from __future__ import annotations

import torch

from graphmine_tpu_torch.graph.container import Graph


def modularity(labels: torch.Tensor, graph: Graph, gamma: float = 1.0) -> float:
    """Q = sum_c [ Sigma_in_c / 2m  -  gamma * (Sigma_tot_c / 2m)^2 ]."""
    if not graph.symmetric:
        raise ValueError(
            "modularity needs the symmetric message list (both edge "
            "directions); rebuild with symmetric=True"
        )
    v = graph.num_vertices
    recv, send = graph.msg_recv, graph.msg_send
    is_self = recv == send
    w = (~is_self).to(torch.float64)
    self_w = torch.zeros(v, dtype=torch.float64, device=recv.device).index_add_(
        0, recv, 0.5 * is_self.to(torch.float64)
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
