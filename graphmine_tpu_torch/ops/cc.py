"""Connected components by iterated min-label propagation (PyTorch).

Counterpart of ``graphmine_tpu/ops/cc.py``: the *weakly* connected
components of the directed edge list (messages flow both directions), each
vertex labelled with the smallest vertex id it reaches. A superstep takes
``min(own, neighbour minimum)`` and then jumps one pointer,
``min(new, new[new])``; the fixpoint stops at the first superstep that
changes nothing (counted) or after ``V + 2`` supersteps. Every step is a
minimum, which is exact in any order, so the scatter-min on CUDA (atomics)
gives the same bits as the CPU and as the JAX package at every superstep.

Plans: ``plan="auto"`` resolves the family through
:func:`~graphmine_tpu_torch.ops.blocking.select_superstep_family`, the
policy LPA and PageRank share (sort below 2^16 messages, bucketed from
there, blocked past the card's crossover), and reuses LPA's per-graph plan
cache. A :class:`~graphmine_tpu_torch.ops.bucketed_mode.BucketedModePlan`
or :class:`~graphmine_tpu_torch.ops.blocking.BlockedPlan` may be passed
directly. With a sink, the auto resolution emits ``impl_selected`` and
``plan_build``, and the fixpoint's supersteps are timed against the cost
model in a ``superstep_timing`` record, as the JAX package's CC does.
"""

from __future__ import annotations

import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.obs.costmodel import emit_superstep_timing, superstep_cost, timed_fixpoint
from graphmine_tpu_torch.ops.blocking import (  # noqa: F401 — BUCKETED_MIN_MESSAGES re-exported
    BUCKETED_MIN_MESSAGES,
    BlockedPlan,
    cc_superstep_blocked,
    emit_plan_records,
    select_superstep_family,
)
from graphmine_tpu_torch.ops.bucketed_mode import BucketedModePlan

_SENTINEL = (1 << 31) - 1


def _scatter_min(values: torch.Tensor, index: torch.Tensor, size: int) -> torch.Tensor:
    """int32 ``[size]``: the minimum of ``values`` per ``index``, the
    sentinel where no value lands."""
    out = torch.full((size,), _SENTINEL, dtype=torch.int32, device=values.device)
    return out.scatter_reduce_(0, index.to(torch.int64), values.to(torch.int32), "amin")


def cc_superstep(labels: torch.Tensor, graph: Graph) -> torch.Tensor:
    """One CC superstep on the message CSR: segment minimum, then the
    pointer jump."""
    neigh_min = _scatter_min(labels[graph.msg_send], graph.msg_recv, graph.num_vertices)
    new = torch.minimum(labels.to(torch.int32), neigh_min)
    return torch.minimum(new, new[new.to(torch.int64)])


def cc_superstep_bucketed(labels: torch.Tensor, plan: BucketedModePlan) -> torch.Tensor:
    """One CC superstep on the degree-bucketed plan: a row minimum over
    each bucket's ``[n_b, w_b]`` sender rows (padding reads the sentinel,
    which never wins), a scatter-min over the hubs' message spans, then
    the pointer jump. Equal to :func:`cc_superstep` every superstep."""
    if plan.send_idx is None:
        raise ValueError("cc_superstep_bucketed needs a fused plan (send_idx); build it with "
                         "build_graph_and_plan or BucketedModePlan.from_graph(with_send=True)")
    labels = labels.to(torch.int32)
    lbl_pad = torch.cat([labels, labels.new_full((1,), _SENTINEL)])
    new = labels.clone()
    for ids, sidx in zip(plan.vertex_ids, plan.send_idx):
        row_min = lbl_pad[sidx].min(dim=1).values
        new[ids] = torch.minimum(new[ids], row_min)  # ids are distinct
    if plan.hist_vertex_ids is not None:
        n_hist = plan.hist_vertex_ids.shape[0]
        rows = plan.hist_row_offset // plan.num_vertices
        hub_min = _scatter_min(labels[plan.hist_send], rows, n_hist)
        new[plan.hist_vertex_ids] = torch.minimum(new[plan.hist_vertex_ids], hub_min)
    return torch.minimum(new, new[new.to(torch.int64)])


def connected_components(graph: Graph, max_iter: int = 0, return_iterations: bool = False,
                         plan="auto", sink=None):
    """Weakly connected component labels, int32 ``[V]`` (each the smallest
    member vertex id), run to the fixpoint (at most ``max_iter``
    supersteps when it is positive, else ``V + 2``).

    ``return_iterations`` also returns the supersteps run, the last,
    unchanged one included. ``plan``: ``"auto"`` (see the module note), a
    :class:`BucketedModePlan` or :class:`BlockedPlan` of this graph, or
    ``None`` for the sort-based superstep. ``sink`` gets the
    ``impl_selected`` and ``plan_build`` records of an auto resolution and
    the fixpoint's ``superstep_timing`` record.
    """
    if isinstance(plan, str):
        if plan != "auto":
            raise ValueError(f"unknown plan {plan!r}; use 'auto', a BucketedModePlan, a "
                             "BlockedPlan or None")
        from graphmine_tpu_torch.ops.lpa import _cached_auto_plan

        family, reason = select_superstep_family(graph.num_vertices, graph.num_messages,
                                                 weighted=graph.msg_weight is not None)
        plan, seconds, cached = None, 0.0, False
        if family != "sort":
            plan, seconds, cached = _cached_auto_plan(graph, family)
        emit_plan_records(sink, "cc_superstep", plan, reason, seconds, cached,
                          graph.num_edges, graph.num_messages, num_vertices=graph.num_vertices)
    elif plan is not None and (plan.num_vertices != graph.num_vertices
                               or plan.num_messages != graph.num_messages):
        raise ValueError(
            f"plan built for V={plan.num_vertices}, M={plan.num_messages} but graph has "
            f"V={graph.num_vertices}, M={graph.num_messages} — plan/graph mismatch"
        )
    (labels, iters), secs, cold = timed_fixpoint(lambda: _fixpoint(graph, max_iter, plan))
    if sink is not None:
        # CC's minimum never reads the weights, even on a weighted graph
        cost = superstep_cost("cc_superstep", "sort" if plan is None else "auto",
                              graph.num_vertices, graph.num_messages, graph.num_edges,
                              plan=plan, weighted=False)
        emit_superstep_timing(sink, "cc_superstep", cost, iters, iters, secs,
                              graph.num_edges, variant="fused", cold_compile=cold)
    return (labels, iters) if return_iterations else labels


def _fixpoint(graph: Graph, max_iter: int, plan) -> tuple:
    """``(labels, supersteps)`` of the fixpoint loop."""
    limit = max_iter if max_iter > 0 else graph.num_vertices + 2
    labels = torch.arange(graph.num_vertices, dtype=torch.int32, device=graph.device)
    iters, changed = 0, 1
    while changed > 0 and iters < limit:
        if plan is None:
            new = cc_superstep(labels, graph)
        elif isinstance(plan, BlockedPlan):
            new = cc_superstep_blocked(labels, plan)
        else:
            new = cc_superstep_bucketed(labels, plan)
        changed = int((new != labels).sum())
        labels = new
        iters += 1
    return labels, iters
