"""Outlier detection, parity path: recursive LPA + bottom-decile threshold.

Counterpart of ``graphmine_tpu/ops/outliers.py`` (single device). One
masked global LPA computes every community's recursive LPA at once:
cross-community messages are retargeted to a drop sentinel, so labels
flow only inside each community's induced subgraph. Sub-communities in
the bottom size decile of their parent community are flagged; parents
with fewer than 10 sub-communities flag nothing.
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
