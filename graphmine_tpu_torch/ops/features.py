"""Per-vertex structural features for the kNN/LOF outlier scorer (PyTorch).

Counterpart of ``graphmine_tpu/ops/features.py::vertex_features``: eight
float32 columns per vertex, computed on the graph's device except the
clustering column's host wedge build.
"""

from __future__ import annotations

import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.census import community_sizes


def vertex_features(graph: Graph, communities: torch.Tensor,
                    include_clustering: bool | str = True,
                    simple_edges=None) -> torch.Tensor:
    """Feature matrix ``[V, 8]`` (float32):

    log1p(out-degree), log1p(in-degree), log1p(message degree),
    log1p(community size), log1p(mean neighbour degree), log1p(distinct
    neighbour communities), the same-community neighbour fraction, and
    the local clustering coefficient.

    ``include_clustering``: ``True`` = exact wedge pipeline; ``"sampled"``
    = the wedge-count-independent estimator; ``False`` zeros the column.
    """
    if include_clustering == "sampled":
        from graphmine_tpu_torch.ops.triangles import sampled_clustering_coefficient

        clust = torch.from_numpy(
            sampled_clustering_coefficient(graph, simple_edges=simple_edges)
        ).to(graph.device)
    elif include_clustering is True:
        from graphmine_tpu_torch.ops.triangles import clustering_coefficient

        clust = clustering_coefficient(graph, simple_edges=simple_edges)
    elif include_clustering is False:
        clust = torch.zeros(graph.num_vertices, dtype=torch.float32, device=graph.device)
    else:
        raise ValueError(
            f"include_clustering must be True, False or 'sampled' "
            f"(got {include_clustering!r})"
        )
    return _vertex_features(graph, communities, clust)


def _vertex_features(graph: Graph, communities: torch.Tensor,
                     clust: torch.Tensor) -> torch.Tensor:
    v = graph.num_vertices
    recv, send = graph.msg_recv, graph.msg_send
    out_deg = torch.bincount(graph.src, minlength=v)
    in_deg = torch.bincount(graph.dst, minlength=v)
    msg_deg = graph.degrees().to(torch.int64)
    comm_size = community_sizes(communities)[communities]
    neigh_deg_sum = torch.zeros(v, dtype=torch.int64, device=recv.device).index_add_(
        0, recv, msg_deg[send]
    )
    # int / int true division rounds both to float32 first, as jnp does
    mean_neigh_deg = neigh_deg_sum.to(torch.float32) / torch.clamp(msg_deg, min=1).to(torch.float32)
    same = (communities[send] == communities[recv]).to(torch.int64)
    same_cnt = torch.zeros(v, dtype=torch.int64, device=recv.device).index_add_(0, recv, same)
    same_frac = same_cnt.to(torch.float32) / torch.clamp(msg_deg, min=1).to(torch.float32)
    distinct = _distinct_neighbor_communities(graph, communities)
    feats = torch.log1p(torch.stack(
        [out_deg.to(torch.float32), in_deg.to(torch.float32),
         msg_deg.to(torch.float32), comm_size.to(torch.float32),
         mean_neigh_deg, distinct.to(torch.float32)], dim=1,
    ))
    return torch.cat(
        [feats, same_frac[:, None], clust[:, None].to(torch.float32)], dim=1
    )


def _distinct_neighbor_communities(graph: Graph, communities: torch.Tensor) -> torch.Tensor:
    """Per-vertex count of distinct communities among message senders:
    distinct (receiver, sender community) pairs via one int64 key."""
    v = graph.num_vertices
    key = graph.msg_recv.to(torch.int64) * v + communities[graph.msg_send].to(torch.int64)
    return torch.bincount(torch.unique(key) // v, minlength=v)


def standardize(feats: torch.Tensor) -> torch.Tensor:
    """Zero-mean unit-variance columns (population std, guarding constant
    features)."""
    mu = feats.mean(dim=0, keepdim=True)
    sd = feats.std(dim=0, correction=0, keepdim=True)
    return (feats - mu) / torch.clamp(sd, min=1e-6)
