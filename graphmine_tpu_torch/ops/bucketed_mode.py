"""Degree-bucketed dense segment mode — the LPA superstep of the main path.

Counterpart of ``graphmine_tpu/ops/bucketed_mode.py`` (fused plans only).
Each vertex's messages are a contiguous CSR slice whose length is known
when the plan is built, so vertices are bucketed by degree class and each
bucket's sender ids are gathered once into a dense ``[n_b, w_b]`` matrix
(padded with ``V``, which reads the sentinel label). A superstep gathers
labels through those matrices and takes each row's mode with the cheapest
method for its width; hubs of degree above 2048 use a label histogram.
Every path breaks ties toward the smallest label, so the labels are
bit-equal to the sort-based :func:`~graphmine_tpu_torch.ops.segment.segment_mode`
superstep and to the JAX package.

The plan's matrices are gathered on the graph's device from the resident
sender array; only row starts and degrees are computed on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import (
    Graph,
    _message_csr,
    _prepare_edges,
)
from graphmine_tpu_torch.device import resolve_device

_SENTINEL = (1 << 31) - 1

# Width classes step by ~1.10x (padding <= 10% per row), exact through
# degree 20. Degrees beyond the ladder extend it by 1.5x steps; degrees
# above _HIST_MIN_DEG go to the histogram path while the budget lasts.
_WIDTHS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
           19, 20, 22, 24, 26, 28, 30, 33, 36, 39, 42, 46, 50, 55, 60, 66,
           72, 79, 86, 94, 103, 113, 124, 136, 149, 163, 179, 196, 215,
           236, 259, 284, 312, 343, 377, 414, 455, 500, 550, 605, 665,
           731, 804, 884, 972, 1069, 1175, 1292, 1421, 1563, 1719, 1890,
           2048)
_PAIRWISE_MAX_W = 32      # <=32: O(w^2) pairwise mode; >32: row sort
_HIST_MIN_DEG = 2048      # degree above this -> histogram mode
_HIST_BUDGET = 1 << 26    # max total int32 entries across all histograms


def _extend_widths(max_deg: int) -> np.ndarray:
    """The width ladder, extended by 1.5x steps beyond 2048 to ``max_deg``."""
    ws = list(_WIDTHS)
    while ws[-1] < max_deg:
        ws.append(ws[-1] + ws[-1] // 2)
    return np.asarray(ws, dtype=np.int64)


def _gather_rows(send: torch.Tensor, starts: torch.Tensor, degs: torch.Tensor,
                 w: int, fill: int) -> torch.Tensor:
    """``[n, w]`` int32 matrix of each row's senders, padded with ``fill``."""
    offs = torch.arange(w, dtype=torch.int64, device=send.device)[None, :]
    idx = starts[:, None] + offs
    valid = offs < degs[:, None]
    safe = torch.clamp(idx, max=send.shape[0] - 1)
    return torch.where(valid, send[safe], fill).to(torch.int32)


@dataclass(frozen=True)
class BucketedModePlan:
    """Static gather plan of a graph, all tensors on its device.

    ``vertex_ids[b]``: int32 ``[n_b]`` vertices in bucket ``b``;
    ``send_idx[b]``: int32 ``[n_b, w_b]`` their senders, padded with ``V``.
    Hubs (degree > 2048, within ``_HIST_BUDGET``): ``hist_vertex_ids``
    int32 ``[n_hist]``, ``hist_send`` the exact sender ids of all hub
    messages, ``hist_row_offset`` the owning hub's ``row * V`` per message;
    all ``None`` when no hub qualifies.
    """

    vertex_ids: tuple
    send_idx: tuple
    num_vertices: int
    num_messages: int
    hist_vertex_ids: torch.Tensor | None = None
    hist_send: torch.Tensor | None = None
    hist_row_offset: torch.Tensor | None = None

    @classmethod
    def from_ptr(cls, ptr: np.ndarray, num_vertices: int,
                 send: torch.Tensor) -> "BucketedModePlan":
        """Plan from the host row pointers and the device sender array."""
        ptr = np.asarray(ptr).astype(np.int64)
        deg = ptr[1:] - ptr[:-1]
        m = int(ptr[-1])
        dev = send.device
        hist_mask = np.zeros(len(deg), dtype=bool)
        if num_vertices > 0:
            allowed = max(_HIST_BUDGET // num_vertices, 0)
            cand = np.nonzero(deg > _HIST_MIN_DEG)[0]
            if len(cand) > allowed:
                cand = cand[np.argsort(deg[cand], kind="stable")[::-1][:allowed]]
            hist_mask[cand] = True

        widths = _extend_widths(int(deg[~hist_mask].max(initial=1)))
        classes = np.searchsorted(widths, np.maximum(deg, 1))
        bucketed = (deg > 0) & ~hist_mask
        vertex_ids, send_idx = [], []
        for c in np.unique(classes[bucketed]):
            rows = np.nonzero((classes == c) & bucketed)[0]
            send_idx.append(_gather_rows(
                send, torch.from_numpy(ptr[rows]).to(dev),
                torch.from_numpy(deg[rows]).to(dev), int(widths[c]), num_vertices,
            ))
            vertex_ids.append(torch.from_numpy(rows.astype(np.int32)).to(dev))

        hist_vertex_ids = hist_send = hist_row_offset = None
        if hist_mask.any():
            hubs = np.nonzero(hist_mask)[0]
            rows = np.repeat(np.arange(len(hubs), dtype=np.int64), deg[hubs])
            hist_vertex_ids = torch.from_numpy(hubs.astype(np.int32)).to(dev)
            # hub messages are contiguous CSR spans: device slices
            hist_send = torch.cat(
                [send[int(ptr[h]):int(ptr[h + 1])] for h in hubs]
            ).to(torch.int32)
            hist_row_offset = torch.from_numpy(
                (rows * num_vertices).astype(np.int32)
            ).to(dev)
        return cls(
            vertex_ids=tuple(vertex_ids), send_idx=tuple(send_idx),
            num_vertices=num_vertices, num_messages=m,
            hist_vertex_ids=hist_vertex_ids, hist_send=hist_send,
            hist_row_offset=hist_row_offset,
        )


def build_graph_and_plan(src, dst, num_vertices: int | None = None,
                         symmetric: bool = True, edge_weights=None, device=None):
    """Build the :class:`Graph` and its fused plan from ONE message-CSR
    pass on ``device`` — the pipeline's single-device build."""
    dev = resolve_device(device)
    src, dst, num_vertices = _prepare_edges(src, dst, num_vertices, edge_weights)
    src_t = torch.from_numpy(src).to(dev)
    dst_t = torch.from_numpy(dst).to(dev)
    ptr, recv, send = _message_csr(src_t, dst_t, num_vertices, symmetric)
    graph = Graph(
        src=src_t, dst=dst_t, msg_recv=recv, msg_send=send,
        msg_ptr=ptr.to(torch.int32), num_vertices=num_vertices, symmetric=symmetric,
    )
    return graph, BucketedModePlan.from_ptr(ptr.cpu().numpy(), num_vertices, send)


def _rowwise_mode(lbl: torch.Tensor) -> torch.Tensor:
    """Mode of each row of a ``[n, w]`` int32 matrix; sentinel entries
    ignored; ties break toward the smallest value. Rows must contain at
    least one non-sentinel entry."""
    s, _ = torch.sort(lbl, dim=1)
    w = s.shape[1]
    pos = torch.arange(w, dtype=torch.int32, device=s.device)[None, :]
    new_run = torch.ones_like(s, dtype=torch.bool)
    new_run[:, 1:] = s[:, 1:] != s[:, :-1]
    run_start = torch.cummax(torch.where(new_run, pos, -1), dim=1).values
    rank = torch.where(s == _SENTINEL, -1, pos - run_start)
    best = rank.max(dim=1).values
    cand = torch.where(rank == best[:, None], s, _SENTINEL)
    return cand.min(dim=1).values


def _rowwise_mode_pairwise(lbl: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`_rowwise_mode` via O(w^2) pairwise-equality
    counting — no sort for narrow rows."""
    valid = lbl != _SENTINEL
    eq = (lbl[:, :, None] == lbl[:, None, :]) & valid[:, None, :]
    counts = torch.where(valid, eq.sum(dim=2, dtype=torch.int32), 0)
    best = counts.max(dim=1).values
    cand = torch.where(counts == best[:, None], lbl, _SENTINEL)
    return cand.min(dim=1).values


def _bucket_mode(mat: torch.Tensor) -> torch.Tensor:
    """Row-wise mode with the cheapest method for the bucket width.

    Width 1 is the value itself; width 2 is ``min`` (the w=2 class holds
    only degree-2 vertices: equal labels -> that label, distinct -> tie ->
    smallest); narrow rows use pairwise counting, wide rows a row sort."""
    w = mat.shape[1]
    if w == 1:
        return mat[:, 0]
    if w == 2:
        return mat.min(dim=1).values
    if w <= _PAIRWISE_MAX_W:
        return _rowwise_mode_pairwise(mat)
    return _rowwise_mode(mat)


def lpa_superstep_bucketed(labels: torch.Tensor, graph: Graph,
                           plan: BucketedModePlan) -> torch.Tensor:
    """One LPA superstep via the bucketed plan — labels identical to
    :func:`graphmine_tpu_torch.ops.lpa.lpa_superstep`."""
    if labels.shape[0] != plan.num_vertices or graph.num_messages != plan.num_messages:
        raise ValueError(
            f"plan built for V={plan.num_vertices}, M={plan.num_messages} "
            f"but got V={labels.shape[0]}, M={graph.num_messages} — "
            "plan/graph mismatch"
        )
    labels = labels.to(torch.int32)
    lbl_pad = torch.cat([labels, labels.new_full((1,), _SENTINEL)])
    out = labels.clone()
    for ids, sidx in zip(plan.vertex_ids, plan.send_idx):
        out[ids] = _bucket_mode(lbl_pad[sidx])
    if plan.hist_vertex_ids is not None:
        # Mega-hub mode: per-hub label histogram + argmax. torch.argmax
        # returns the FIRST maximal index, i.e. the smallest label among
        # the most frequent ones — the smallest-label tie-break.
        n_hist = plan.hist_vertex_ids.shape[0]
        flat = plan.hist_row_offset + labels[plan.hist_send]
        hist = torch.zeros(n_hist * plan.num_vertices, dtype=torch.int32,
                           device=labels.device)
        hist.index_add_(0, flat, torch.ones_like(flat))
        modes = torch.argmax(hist.view(n_hist, plan.num_vertices), dim=1)
        out[plan.hist_vertex_ids] = modes.to(torch.int32)
    return out
