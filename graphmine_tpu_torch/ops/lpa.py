"""Label propagation (PyTorch).

Counterpart of ``graphmine_tpu/ops/lpa.py``: GraphX Pregel LPA semantics —
initial label = own id; synchronous supersteps in which every vertex
adopts the mode of its neighbours' labels (messages along both directions
of every edge, duplicates counted); exactly ``max_iter`` supersteps;
isolated vertices keep their label; ties toward the smallest label. On a
weighted graph the mode is the label of largest incoming weight sum.
"""

from __future__ import annotations

import weakref

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
                      return_history: bool = False, plan="auto", sink=None):
    """Run ``max_iter`` LPA supersteps; returns int32 labels ``[V]``.

    ``plan``: a :class:`~graphmine_tpu_torch.ops.bucketed_mode.BucketedModePlan`
    (the degree-bucketed superstep) or a
    :class:`~graphmine_tpu_torch.ops.blocking.BlockedPlan` (the
    destination-binned one); ``None`` runs the sort-based superstep. Labels
    are identical whichever runs. The default ``"auto"`` resolves the
    family through :func:`~graphmine_tpu_torch.ops.blocking.select_superstep_family`
    and builds its plan once per graph and family; it stays on the sort
    superstep with custom ``init_labels`` (the plans assume labels in
    ``[0, V)``, as the default initialization guarantees).

    ``sink``: an auto resolution emits ``impl_selected`` and, when a plan
    is built or reused, ``plan_build``; every run with a sink emits one
    ``superstep_timing`` record of its supersteps against the cost model.

    With ``return_history=True`` also returns the per-superstep count of
    changed labels (int32 ``[max_iter]``).
    """
    from graphmine_tpu_torch.ops.blocking import (
        BlockedPlan,
        emit_plan_records,
        select_superstep_family,
    )
    from graphmine_tpu_torch.ops.bucketed_mode import BucketedModePlan

    if isinstance(plan, str) and plan == "auto":
        plan = None
        if init_labels is None:
            family, reason = select_superstep_family(graph.num_vertices, graph.num_messages,
                                                     weighted=graph.msg_weight is not None)
            seconds, cached = 0.0, False
            if family != "sort":
                plan, seconds, cached = _cached_auto_plan(graph, family)
            emit_plan_records(sink, "lpa_superstep", plan, reason, seconds, cached,
                              graph.num_edges, graph.num_messages,
                              num_vertices=graph.num_vertices)
    elif plan is not None and not isinstance(plan, (BucketedModePlan, BlockedPlan)):
        raise ValueError("plan must be 'auto', None, a BucketedModePlan or a BlockedPlan; "
                         f"got {plan!r}")
    if (isinstance(plan, BucketedModePlan) and plan.hist_vertex_ids is not None
            and init_labels is not None and init_labels.numel()):
        # the hub histogram indexes by label: out-of-range labels would
        # land in another hub's row
        lo, hi = int(init_labels.min()), int(init_labels.max())
        if lo < 0 or hi >= plan.num_vertices:
            raise ValueError(
                f"fused plans with a histogram path need init_labels in [0, {plan.num_vertices}); "
                f"got range [{lo}, {hi}] — pass plan=None for arbitrary label values")
    if sink is None:
        return _label_propagation(graph, max_iter, init_labels, return_history, plan)
    from graphmine_tpu_torch.obs.costmodel import (
        emit_superstep_timing,
        superstep_cost,
        timed_fixpoint,
    )

    out, secs, cold = timed_fixpoint(
        lambda: _label_propagation(graph, max_iter, init_labels, return_history, plan))
    cost = superstep_cost("lpa_superstep", "sort" if plan is None else "auto",
                          graph.num_vertices, graph.num_messages, graph.num_edges, plan=plan,
                          weighted=graph.msg_weight is not None)
    emit_superstep_timing(sink, "lpa_superstep", cost, max_iter, max_iter, secs,
                          graph.num_edges, variant="fused", cold_compile=cold)
    return out


# id(graph.msg_ptr) -> (weak reference to it, {family: plan}); an entry
# goes when its graph's msg_ptr is collected
_auto_plan_cache: dict = {}


def _cached_auto_plan(graph: Graph, family: str) -> tuple:
    """``(plan, build seconds, cached)``: the auto plan of ``family`` for
    ``graph``, built once per graph and family (0.0 seconds on a hit)."""
    from graphmine_tpu_torch.ops.blocking import build_family_plan, timed_plan_build

    key = id(graph.msg_ptr)
    hit = _auto_plan_cache.get(key)
    if hit is None or hit[0]() is not graph.msg_ptr:
        ref = weakref.ref(graph.msg_ptr, lambda _, k=key: _auto_plan_cache.pop(k, None))
        hit = _auto_plan_cache[key] = (ref, {})
    plans = hit[1]
    if family in plans:
        return plans[family], 0.0, True
    plan, seconds = timed_plan_build(lambda: build_family_plan(graph, family))
    plans[family] = plan
    return plan, seconds, False


def _label_propagation(graph: Graph, max_iter: int, init_labels, return_history: bool, plan):
    from graphmine_tpu_torch.ops.blocking import BlockedPlan, lpa_superstep_blocked
    from graphmine_tpu_torch.ops.bucketed_mode import lpa_superstep_bucketed

    if plan is None:
        superstep = lambda lbl: lpa_superstep(lbl, graph)  # noqa: E731
    elif isinstance(plan, BlockedPlan):
        superstep = lambda lbl: lpa_superstep_blocked(lbl, graph, plan)  # noqa: E731
    else:
        superstep = lambda lbl: lpa_superstep_bucketed(lbl, graph, plan)  # noqa: E731
    labels = (
        torch.arange(graph.num_vertices, dtype=torch.int32, device=graph.device)
        if init_labels is None else init_labels.to(torch.int32)
    )
    changed = []
    for _ in range(max_iter):
        new = superstep(labels)
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
