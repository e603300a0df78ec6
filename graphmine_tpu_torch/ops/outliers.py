"""Outlier detection, parity path: recursive LPA + bottom-decile threshold.

Counterpart of ``graphmine_tpu/ops/outliers.py``. One masked global LPA
computes every community's recursive LPA at once: cross-community
messages are retargeted to a drop sentinel, so labels flow only inside
each community's induced subgraph. Sub-communities in the bottom size
decile of their parent community are flagged; parents with fewer than 10
sub-communities flag nothing. :func:`recursive_lpa_outliers_sharded` is
the same pass over a mesh, for a graph that stays on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.segment import segment_mode


def masked_label_propagation(graph: Graph, communities: torch.Tensor,
                             max_iter: int = 5) -> torch.Tensor:
    """LPA restricted to intra-community edges, for all communities at once."""
    v = graph.num_vertices
    keep = communities[graph.msg_send] == communities[graph.msg_recv]
    recv = torch.where(keep, graph.msg_recv, v)  # v = drop sentinel
    deg = torch.zeros(v, dtype=torch.int32, device=keep.device).index_add_(
        0, graph.msg_recv, keep.to(torch.int32)
    )
    labels = torch.arange(v, dtype=torch.int32, device=keep.device)
    for _ in range(max_iter):
        mode, _ = segment_mode(recv, labels[graph.msg_send], v)
        labels = torch.where(deg > 0, mode, labels)
    return labels


@dataclass(frozen=True)
class OutlierReport:
    """Result of the recursive-LPA outlier pass (host-side arrays)."""

    sub_labels: np.ndarray        # int32 [V] sub-community of each vertex
    outlier_vertices: np.ndarray  # bool [V] vertex is in an outlier sub-community
    sub_sizes: np.ndarray         # int32 [S] size of each distinct sub-community
    sub_parents: np.ndarray       # int32 [S] parent community of each sub-community
    thresholds: dict              # parent community -> bottom-decile size threshold


def recursive_lpa_outliers(graph: Graph, communities: torch.Tensor,
                           max_iter: int = 5, decile: float = 0.1) -> OutlierReport:
    """Masked LPA on the device, then the per-parent decile thresholds over
    the (small) sub-community size table on the host."""
    sub = masked_label_propagation(graph, communities, max_iter=max_iter)
    return _decile_report(sub.cpu().numpy(), communities.cpu().numpy(), decile)


def recursive_lpa_outliers_sharded(graph: Graph, communities, mesh, max_iter: int = 5,
                                   decile: float = 0.1,
                                   schedule: str = "replicated") -> OutlierReport:
    """The recursive-LPA outlier pass for a graph that does not fit one
    device. Masked LPA equals plain LPA over the graph filtered to its
    intra-community edges (the segment mode is order-independent, and a
    vertex with no surviving message keeps its label), so that subgraph is
    built on the host from the graph's edge arrays, partitioned over
    ``mesh`` and run through ``schedule`` (``"replicated"`` or ``"ring"``,
    the planner's schedule of the main run). Unweighted, as the masked
    pass is. The flags equal :func:`recursive_lpa_outliers`'."""
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.parallel.sharded import (
        partition_graph,
        shard_graph_arrays,
        sharded_label_propagation,
    )

    if schedule not in ("replicated", "ring"):
        raise ValueError(
            f"unknown schedule {schedule!r}; expected 'replicated' or 'ring' (the "
            "planner's distributed schedules; a 'single' plan uses recursive_lpa_outliers)"
        )

    def host(t):
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    comm = host(communities)
    src, dst = host(graph.src), host(graph.dst)
    keep = comm[src] == comm[dst]
    intra = build_graph(src[keep], dst[keep], num_vertices=graph.num_vertices,
                        symmetric=graph.symmetric, device="cpu")
    sg = shard_graph_arrays(partition_graph(intra, mesh=mesh), mesh)
    if schedule == "ring":
        from graphmine_tpu_torch.parallel.ring import ring_label_propagation

        sub = ring_label_propagation(sg, mesh, max_iter=max_iter)
    else:
        sub = sharded_label_propagation(sg, mesh, max_iter=max_iter)
    return _decile_report(sub.cpu().numpy(), comm, decile)


def _decile_report(sub: np.ndarray, comm: np.ndarray, decile: float) -> OutlierReport:
    """Bottom-decile thresholding over the sub-community size table: the
    threshold is the cut-th smallest size within the parent, ties all
    flagged. One (parent, size) lexsort + per-group threshold gather."""
    sub_ids, inverse, sizes = np.unique(sub, return_inverse=True, return_counts=True)
    parents = comm[sub_ids]  # sub-community label = a member vertex id

    outlier_sub = np.zeros(len(sub_ids), dtype=bool)
    thresholds: dict[int, int] = {}
    if len(sub_ids):
        order = np.lexsort((sizes, parents))  # group by parent, sizes asc
        p_sorted = parents[order]
        s_sorted = sizes[order]
        uniq_p, starts, counts = np.unique(
            p_sorted, return_index=True, return_counts=True
        )
        cuts = (counts * decile).astype(np.int64)
        has_decile = cuts > 0  # fewer than 1/decile sub-communities: skip
        thr = s_sorted[starts[has_decile] + cuts[has_decile] - 1]
        thresholds = dict(zip(
            uniq_p[has_decile].astype(int).tolist(),
            thr.astype(int).tolist(),
        ))
        # per-row parent group -> its threshold (-1: flags nothing)
        thr_full = np.full(len(uniq_p), -1, dtype=np.int64)
        thr_full[has_decile] = thr
        group_of_row = np.repeat(np.arange(len(uniq_p)), counts)
        outlier_sub[order] = s_sorted <= thr_full[group_of_row]

    return OutlierReport(
        sub_labels=sub.astype(np.int32),
        outlier_vertices=outlier_sub[inverse],
        sub_sizes=sizes.astype(np.int32),
        sub_parents=parents.astype(np.int32),
        thresholds=thresholds,
    )
