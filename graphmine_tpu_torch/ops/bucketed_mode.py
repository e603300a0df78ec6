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

On a weighted graph the plan carries slot-aligned weight matrices (padding
weighs 0) and every path takes the label of largest weight sum instead:
narrow rows by pairwise sums, wide rows by a row sort and a segmented scan
that sums each run on its own, hubs by a histogram whose sums come from a
sort of the hub messages, each run summed on its own in message order.

The plan's matrices are gathered on the graph's device from the resident
sender array; only row starts and degrees are computed on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph, _build_with_csr
from graphmine_tpu_torch.ops.segment import run_totals

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


def _gather_rows(values: torch.Tensor, starts: torch.Tensor, degs: torch.Tensor,
                 w: int, fill) -> torch.Tensor:
    """``[n, w]`` matrix of each row's CSR entries of ``values`` (its
    dtype), padded with ``fill``."""
    offs = torch.arange(w, dtype=torch.int64, device=values.device)[None, :]
    idx = starts[:, None] + offs
    valid = offs < degs[:, None]
    safe = torch.clamp(idx, max=values.shape[0] - 1)
    return values[safe].masked_fill_(~valid, fill)


@dataclass(frozen=True)
class BucketedModePlan:
    """Static gather plan of a graph, all tensors on its device.

    ``vertex_ids[b]``: int32 ``[n_b]`` vertices in bucket ``b``;
    ``send_idx[b]``: int32 ``[n_b, w_b]`` their senders, padded with ``V``.
    Hubs (degree > 2048, within ``_HIST_BUDGET``): ``hist_vertex_ids``
    int32 ``[n_hist]``, ``hist_send`` the exact sender ids of all hub
    messages, ``hist_row_offset`` the owning hub's ``row * V`` per message;
    all ``None`` when no hub qualifies. Weighted plans: ``weight_mat[b]``
    float32 ``[n_b, w_b]`` slot-aligned with ``send_idx[b]`` (padding 0)
    and ``hist_weight`` the hub messages' weights; ``None`` otherwise.
    """

    vertex_ids: tuple
    send_idx: tuple
    num_vertices: int
    num_messages: int
    hist_vertex_ids: torch.Tensor | None = None
    hist_send: torch.Tensor | None = None
    hist_row_offset: torch.Tensor | None = None
    weight_mat: tuple | None = None
    hist_weight: torch.Tensor | None = None

    @classmethod
    def from_ptr(cls, ptr: np.ndarray, num_vertices: int, send: torch.Tensor,
                 weights: torch.Tensor | None = None) -> "BucketedModePlan":
        """Plan from the host row pointers and the device sender array, with
        the weight payload when ``weights`` (``[M]``, CSR order) is given."""
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
        vertex_ids, send_idx, weight_mat = [], [], []
        for c in np.unique(classes[bucketed]):
            rows = np.nonzero((classes == c) & bucketed)[0]
            starts = torch.from_numpy(ptr[rows]).to(dev)
            degs = torch.from_numpy(deg[rows]).to(dev)
            send_idx.append(_gather_rows(send, starts, degs, int(widths[c]), num_vertices))
            if weights is not None:
                weight_mat.append(_gather_rows(weights, starts, degs, int(widths[c]), 0.0))
            vertex_ids.append(torch.from_numpy(rows.astype(np.int32)).to(dev))

        hist_vertex_ids = hist_send = hist_row_offset = hist_weight = None
        if hist_mask.any():
            hubs = np.nonzero(hist_mask)[0]
            rows = np.repeat(np.arange(len(hubs), dtype=np.int64), deg[hubs])
            hist_vertex_ids = torch.from_numpy(hubs.astype(np.int32)).to(dev)
            # hub messages are contiguous CSR spans: device slices
            spans = [slice(int(ptr[h]), int(ptr[h + 1])) for h in hubs]
            hist_send = torch.cat([send[sl] for sl in spans]).to(torch.int32)
            if weights is not None:
                hist_weight = torch.cat([weights[sl] for sl in spans])
            hist_row_offset = torch.from_numpy(
                (rows * num_vertices).astype(np.int32)
            ).to(dev)
        return cls(
            vertex_ids=tuple(vertex_ids), send_idx=tuple(send_idx),
            num_vertices=num_vertices, num_messages=m,
            hist_vertex_ids=hist_vertex_ids, hist_send=hist_send,
            hist_row_offset=hist_row_offset,
            weight_mat=tuple(weight_mat) if weights is not None else None,
            hist_weight=hist_weight,
        )


def build_graph_and_plan(src, dst, num_vertices: int | None = None,
                         symmetric: bool = True, edge_weights=None, device=None):
    """Build the :class:`Graph` and its fused plan from ONE message-CSR
    pass on ``device`` — the pipeline's single-device build.
    ``edge_weights`` builds a weighted graph and the plan's weight payload."""
    graph, ptr = _build_with_csr(src, dst, num_vertices, symmetric, edge_weights, device)
    return graph, BucketedModePlan.from_ptr(ptr, graph.num_vertices, graph.msg_send,
                                            weights=graph.msg_weight)


def plan_build_stats(plan: BucketedModePlan, num_edges: int) -> dict:
    """The ``plan_build`` record's payload for a plan: its family, width
    classes and padded gather slots per edge (the JAX package's keys),
    with the port's bucket and hub counts."""
    from graphmine_tpu_torch.obs.costmodel import _bucketed_padded_slots

    return {
        "family": "bucketed", "bins": 0, "width_classes": len(plan.vertex_ids),
        "padded_slots_per_edge": round(_bucketed_padded_slots(plan) / max(int(num_edges), 1), 3),
        "buckets": len(plan.vertex_ids),
        "hub_vertices": 0 if plan.hist_vertex_ids is None else len(plan.hist_vertex_ids),
    }


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


def _segmented_row_cumsum(new_run: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along each row that restarts where
    ``new_run`` is set: a Hillis-Steele scan of log2(w) shifted adds, so
    every prefix is a sum of its own run's elements only (never a
    difference of a row-wide cumsum, whose rounding at wide rows would
    misrank labels)."""
    flag, val = new_run, vals
    n, w = vals.shape
    d = 1
    while d < w:
        # combine x[p-d] into x[p]; the identity (False, 0) pads the left
        a_f = torch.cat([flag.new_zeros((n, d)), flag[:, :-d]], dim=1)
        a_v = torch.cat([val.new_zeros((n, d)), val[:, :-d]], dim=1)
        val = torch.where(flag, val, a_v + val)
        flag = flag | a_f
        d *= 2
    return val


def _rowwise_wmode(lbl: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Weighted mode of each ``[n, w]`` row: the label of largest weight
    sum, ties toward the smallest; sentinel slots weigh 0 and are
    excluded. Weights are non-negative, so each run's last prefix is its
    total and the row maximum of the scan is attained at a run's end."""
    s, order = torch.sort(lbl, dim=1, stable=True)
    ws = torch.gather(torch.where(lbl == _SENTINEL, 0.0, wgt), 1, order)
    new_run = torch.ones_like(s, dtype=torch.bool)
    new_run[:, 1:] = s[:, 1:] != s[:, :-1]
    score = torch.where(s == _SENTINEL, -1.0, _segmented_row_cumsum(new_run, ws))
    best = score.max(dim=1).values
    cand = torch.where(score == best[:, None], s, _SENTINEL)
    return cand.min(dim=1).values


def _rowwise_wmode_pairwise(lbl: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """Same contract as :func:`_rowwise_wmode` via O(w^2) pairwise weight
    sums — no sort for narrow rows."""
    valid = lbl != _SENTINEL
    wz = torch.where(valid, wgt, 0.0)
    eq = (lbl[:, :, None] == lbl[:, None, :]) & valid[:, None, :]
    scores = torch.where(valid, (eq * wz[:, None, :]).sum(dim=2), -1.0)
    best = scores.max(dim=1).values
    cand = torch.where(scores == best[:, None], lbl, _SENTINEL)
    return cand.min(dim=1).values


def _bucket_wmode(mat: torch.Tensor, wmat: torch.Tensor) -> torch.Tensor:
    """Weighted :func:`_bucket_mode`: the cheapest method per bucket width."""
    w = mat.shape[1]
    if w == 1:
        return mat[:, 0]
    if w == 2:
        # degree-2 rows are exact: equal labels -> that label; else the
        # heavier label wins, equal weights tie toward the smaller label
        l0, l1 = mat[:, 0], mat[:, 1]
        w0, w1 = wmat[:, 0], wmat[:, 1]
        pick0 = (w0 > w1) | ((w0 == w1) & (l0 <= l1))
        return torch.where(l0 == l1, l0, torch.where(pick0, l0, l1))
    if w <= _PAIRWISE_MAX_W:
        return _rowwise_wmode_pairwise(mat, wmat)
    return _rowwise_wmode(mat, wmat)


def _hub_weight_hist(flat: torch.Tensor, weights: torch.Tensor, size: int) -> torch.Tensor:
    """Float32 ``[size]`` histogram: each received slot of ``flat`` holds
    the sum of its messages' weights, every other slot -inf, so a hub
    whose weights are all 0 still picks a label it received. The sums come
    from a stable sort of the slots, each run summed on its own in message
    order: the bits depend on the data, not on atomics' order."""
    key, order = torch.sort(flat.to(torch.int64), stable=True)
    new_run = torch.ones_like(key, dtype=torch.bool)
    new_run[1:] = key[1:] != key[:-1]
    hist = torch.full((size,), float("-inf"), dtype=torch.float32, device=flat.device)
    hist[key[new_run]] = run_totals(new_run, weights[order])[new_run]
    return hist


def lpa_superstep_bucketed(labels: torch.Tensor, graph: Graph,
                           plan: BucketedModePlan) -> torch.Tensor:
    """One LPA superstep via the bucketed plan — labels identical to
    :func:`graphmine_tpu_torch.ops.lpa.lpa_superstep`, weighted when the
    plan carries weights."""
    if graph.msg_weight is not None and plan.weight_mat is None:
        raise ValueError(
            "graph carries msg_weight but the plan has no weight payload; "
            "build it with build_graph_and_plan(edge_weights=...) or "
            "BucketedModePlan.from_ptr(weights=...)"
        )
    if labels.shape[0] != plan.num_vertices or graph.num_messages != plan.num_messages:
        raise ValueError(
            f"plan built for V={plan.num_vertices}, M={plan.num_messages} "
            f"but got V={labels.shape[0]}, M={graph.num_messages} — "
            "plan/graph mismatch"
        )
    labels = labels.to(torch.int32)
    lbl_pad = torch.cat([labels, labels.new_full((1,), _SENTINEL)])
    out = labels.clone()
    wmats = plan.weight_mat or (None,) * len(plan.vertex_ids)
    for ids, sidx, wmat in zip(plan.vertex_ids, plan.send_idx, wmats):
        mat = lbl_pad[sidx]
        out[ids] = _bucket_mode(mat) if wmat is None else _bucket_wmode(mat, wmat)
    if plan.hist_vertex_ids is not None:
        # Mega-hub mode: per-hub label histogram + argmax. torch.argmax
        # returns the FIRST maximal index, i.e. the smallest label among
        # the most frequent (heaviest) ones — the smallest-label tie-break.
        n_hist = plan.hist_vertex_ids.shape[0]
        flat = plan.hist_row_offset + labels[plan.hist_send]
        if plan.hist_weight is not None:
            hist = _hub_weight_hist(flat, plan.hist_weight, n_hist * plan.num_vertices)
        else:
            hist = torch.zeros(n_hist * plan.num_vertices, dtype=torch.int32,
                               device=labels.device)
            hist.index_add_(0, flat, torch.ones_like(flat))
        modes = torch.argmax(hist.view(n_hist, plan.num_vertices), dim=1)
        out[plan.hist_vertex_ids] = modes.to(torch.int32)
    return out
