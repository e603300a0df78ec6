"""Per-vertex structural features for the kNN/LOF outlier scorer (PyTorch).

Counterpart of ``graphmine_tpu/ops/features.py``: :func:`vertex_features`,
eight float32 columns per vertex computed on the graph's device except the
clustering column's host wedge build, and :func:`vertex_features_host`,
the same columns in host NumPy for a host-resident graph (the scale-out
pipeline, whose graph does not fit one device).
"""

from __future__ import annotations

import numpy as np
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
    counts = torch.stack(
        [out_deg.to(torch.float32), in_deg.to(torch.float32),
         msg_deg.to(torch.float32), comm_size.to(torch.float32),
         mean_neigh_deg, distinct.to(torch.float32)], dim=1,
    )
    # log1p on the host: the card's float32 log1p differs from the CPU's in
    # the last place, and LOF turns such a difference into another
    # neighbour among near-tied ones
    feats = torch.log1p(counts.cpu()).to(counts.device)
    return torch.cat(
        [feats, same_frac[:, None], clust[:, None].to(torch.float32)], dim=1
    )


def _distinct_neighbor_communities(graph: Graph, communities: torch.Tensor) -> torch.Tensor:
    """Per-vertex count of distinct communities among message senders:
    distinct (receiver, sender community) pairs via one int64 key."""
    v = graph.num_vertices
    key = graph.msg_recv.to(torch.int64) * v + communities[graph.msg_send].to(torch.int64)
    return torch.bincount(torch.unique(key) // v, minlength=v)


def vertex_features_host(graph: Graph, communities, include_clustering: bool | str = True,
                         clustering_samples: int = 64, clustering_seed: int = 0) -> np.ndarray:
    """NumPy twin of :func:`vertex_features` for a host graph (the
    scale-out mode): bincounts, float64 accumulation and one int64 unique,
    no device transfer of the edge arrays. Returns float32 ``[V, 8]``.
    ``include_clustering``: ``True`` the exact wedge pipeline, ``"sampled"``
    the wedge-sampled estimator (per-vertex standard error at most
    ``1/(2*sqrt(clustering_samples))``, cost independent of the wedge
    count: the scale-out default), ``False`` a zero column."""
    v = graph.num_vertices

    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    src, dst = host(graph.src), host(graph.dst)
    recv, send = host(graph.msg_recv), host(graph.msg_send)
    comm = host(communities)
    out_deg = np.bincount(src, minlength=v).astype(np.float64)
    in_deg = np.bincount(dst, minlength=v).astype(np.float64)
    msg_deg = np.diff(host(graph.msg_ptr).astype(np.int64)).astype(np.float64)
    comm_size = np.bincount(comm, minlength=v).astype(np.float64)[comm]
    neigh_deg_sum = np.bincount(recv, weights=msg_deg[send], minlength=v)
    mean_neigh_deg = neigh_deg_sum / np.maximum(msg_deg, 1.0)
    same = comm[send] == comm[recv]
    same_cnt = np.bincount(recv[same], minlength=v).astype(np.float64)
    same_frac = same_cnt / np.maximum(msg_deg, 1.0)
    # distinct (receiver, sender community) pairs through one int64 key
    key = recv.astype(np.int64) * v + comm[send].astype(np.int64)
    distinct = np.bincount((np.unique(key) // v).astype(np.int64), minlength=v).astype(np.float64)
    if isinstance(include_clustering, np.bool_):
        include_clustering = bool(include_clustering)
    if include_clustering == "sampled":
        from graphmine_tpu_torch.ops.triangles import sampled_clustering_coefficient

        clust = sampled_clustering_coefficient(
            graph, samples=clustering_samples, seed=clustering_seed).astype(np.float64)
    elif include_clustering is True:
        from graphmine_tpu_torch.ops.triangles import clustering_coefficient

        clust = clustering_coefficient(graph).cpu().numpy().astype(np.float64)
    elif include_clustering is False:
        clust = np.zeros(v, np.float64)
    else:
        raise ValueError(
            f"include_clustering must be True, False or 'sampled' "
            f"(got {include_clustering!r})"
        )
    feats = np.log1p(np.stack([out_deg, in_deg, msg_deg, comm_size, mean_neigh_deg, distinct],
                              axis=1)).astype(np.float32)
    return np.concatenate([feats, same_frac[:, None].astype(np.float32),
                           clust[:, None].astype(np.float32)], axis=1)


def standardize(feats: torch.Tensor) -> torch.Tensor:
    """Zero-mean unit-variance columns (population std, guarding constant
    features). The column means and deviations are reduced on the host,
    in the CPU's order, so features on the card carry the CPU's bits (a
    float32 reduction rounds differently on the card)."""
    host = feats.cpu()
    mu = host.mean(dim=0, keepdim=True).to(feats.device)
    sd = host.std(dim=0, correction=0, keepdim=True).to(feats.device)
    return (feats - mu) / torch.clamp(sd, min=1e-6)
