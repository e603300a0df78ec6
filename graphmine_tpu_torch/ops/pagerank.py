"""PageRank and batched personalized PageRank as power iterations (PyTorch).

Counterpart of ``graphmine_tpu/ops/pagerank.py``, on its segment-sum
path: rank is a dense float32 vector; one iteration gathers along edge
sources and sums at destinations (:class:`~graphmine_tpu_torch.ops.
segment.SegmentSums`: the sort by destination is paid once, and each
destination's inflow is summed on its own in a fixed order, so a run
repeats itself bit for bit on each device). Damping ``alpha``, uniform or
personalized teleport, dangling mass redistributed through the teleport
vector, ranks summing to 1.

A :class:`~graphmine_tpu_torch.ops.blocking.BlockedPlan` of a directed,
unweighted graph routes the inflow through the destination-binned layout
(:func:`~graphmine_tpu_torch.ops.blocking.blocked_inflow`; its row sums
reassociate, so ranks agree with the segment path to float tolerance).
``plan="auto"`` takes it only where the shared superstep policy picks the
blocked family, past the card's crossover; everything else keeps the
segment path bit for bit.

The stopping rule is the JAX package's, ``delta > tol`` on the L1 change,
read on the host once per iteration (one synchronise each).
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.blocking import (
    BlockedPlan,
    blocked_inflow,
    emit_plan_records,
    select_superstep_family,
)
from graphmine_tpu_torch.ops.segment import SegmentSums, segment_sum


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def pagerank(graph: Graph, alpha: float = 0.85, max_iter: int = 100, tol: float = 1e-6,
             reset=None, weights=None, plan="auto", sink=None) -> torch.Tensor:
    """PageRank vector ``[V]`` (float32, sums to 1) on ``graph``'s device.

    ``reset``: optional personalization distribution (normalized here);
    ``None`` = uniform teleport. ``weights``: optional non-negative
    per-edge weights ``[E]`` aligned with ``graph.src``: each vertex splits
    its rank across out-edges in proportion to weight (vertices whose
    out-weight is 0 are dangling). Stops when the L1 delta is no longer
    above ``tol``, or after ``max_iter`` iterations. ``plan``: ``"auto"``,
    ``None`` (the segment path) or a ``BlockedPlan`` of this graph, which
    needs a directed graph (``symmetric=False``: a symmetric CSR carries
    both directions and would double the inflow) and ``weights=None`` (the
    weights are edge-aligned, the plan CSR-aligned). ``sink``: optional
    metrics sink for the auto resolution's ``impl_selected`` and
    ``plan_build`` records (when it takes the blocked family) and a
    ``superstep_timing`` record of the run.
    """
    resolved = None
    if isinstance(plan, str) and plan == "auto":
        if weights is None and not graph.symmetric:
            from graphmine_tpu_torch.ops.lpa import _cached_auto_plan

            family, reason = select_superstep_family(graph.num_vertices, graph.num_messages)
            if family == "blocked":
                resolved, seconds, cached = _cached_auto_plan(graph, "blocked")
                emit_plan_records(sink, "pagerank_inflow", resolved, reason, seconds, cached,
                                  graph.num_edges, graph.num_messages,
                                  num_vertices=graph.num_vertices)
    elif isinstance(plan, BlockedPlan):
        if plan.num_vertices != graph.num_vertices or plan.num_messages != graph.num_messages:
            raise ValueError(
                f"plan built for V={plan.num_vertices}, M={plan.num_messages} but graph has "
                f"V={graph.num_vertices}, M={graph.num_messages} — plan/graph mismatch")
        if graph.symmetric:
            raise ValueError(
                "blocked PageRank needs a directed message CSR (build_graph(..., "
                "symmetric=False)); this graph's CSR carries both directions and would "
                "double the inflow")
        if weights is not None:
            raise ValueError(
                "blocked PageRank does not carry the edge-aligned weights argument (the "
                "plan's layout is CSR-aligned); pass plan=None for weighted ranks — weights "
                "are never silently dropped")
        resolved = plan
    elif plan is not None:
        raise ValueError(f"plan must be 'auto', None, or a BlockedPlan; got {plan!r}")
    if sink is None:
        return _pagerank(graph, alpha, max_iter, tol, reset, weights, resolved)[0]
    from graphmine_tpu_torch.obs.costmodel import (
        emit_superstep_timing,
        superstep_cost,
        timed_fixpoint,
    )

    (pr, iters), secs, cold = timed_fixpoint(
        lambda: _pagerank(graph, alpha, max_iter, tol, reset, weights, resolved))
    iters = max(int(iters), 1)
    cost = superstep_cost("pagerank_inflow", "sort" if resolved is None else "auto",
                          graph.num_vertices, graph.num_messages, graph.num_edges,
                          plan=resolved, weighted=weights is not None)
    emit_superstep_timing(sink, "pagerank_inflow", cost, iters, iters, secs, graph.num_edges,
                          variant="fused", cold_compile=cold)
    return pr


def _as_tensor(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _pagerank(graph: Graph, alpha, max_iter: int, tol, reset, weights, plan=None):
    """``(ranks, iterations)``; the inflow on ``plan``'s blocked layout
    when one is given."""
    dev, v = graph.device, graph.num_vertices
    src = graph.src.to(torch.int64)
    by_src = SegmentSums(src, v)
    inflow = SegmentSums(graph.dst, v) if plan is None else None
    if weights is None:
        out_w = by_src.sum(torch.ones(src.shape[0], dtype=torch.float32, device=dev))
        edge_frac = None
    else:
        w = torch.clamp(_as_tensor(weights, dev), min=0.0)
        out_w = by_src.sum(w)
        edge_frac = w / torch.clamp(out_w[src], min=1e-30)
    inv_out = torch.where(out_w > 0, 1.0 / torch.clamp(out_w, min=1e-30),
                          torch.zeros_like(out_w))
    dangling = out_w <= 0
    if reset is None:
        reset_v = torch.full((v,), 1.0 / v, dtype=torch.float32, device=dev)
    else:
        r = torch.clamp(_as_tensor(reset, dev), min=0.0)
        reset_v = r / torch.clamp(r.sum(), min=1e-12)
    a = _f32(alpha, dev)
    teleport = (1.0 - a) * reset_v
    pr = torch.full((v,), 1.0 / v, dtype=torch.float32, device=dev)
    tol = float(np.float32(tol))
    it = 0
    delta = 1.0
    while delta > tol and it < max_iter:
        if plan is not None:
            flow = blocked_inflow(plan, pr * inv_out)
        elif edge_frac is None:
            flow = inflow.sum((pr * inv_out)[src])
        else:
            flow = inflow.sum(pr[src] * edge_frac)
        dangling_mass = torch.where(dangling, pr, 0.0).sum()
        new = a * (flow + dangling_mass * reset_v) + teleport
        delta = float((new - pr).abs().sum())
        pr, it = new, it + 1
    return pr, it


def _validate_sources(sources, v: int) -> np.ndarray:
    """Source ids as int32, each in [0, V)."""
    sources = np.asarray(sources, dtype=np.int32)
    if sources.size and (sources.min() < 0 or sources.max() >= v):
        bad = sources[(sources < 0) | (sources >= v)]
        raise ValueError(f"source ids {bad.tolist()} out of range [0, {v})")
    return sources


def parallel_personalized_pagerank(graph: Graph, sources, alpha: float = 0.85,
                                   max_iter: int = 100, tol: float = 1e-6) -> torch.Tensor:
    """Personalized PageRank from many sources at once (GraphFrames'
    ``parallelPersonalizedPageRank``): ``[V, S]``, column ``j`` teleporting
    to ``sources[j]``. One power iteration over the whole rank matrix; it
    stops when the largest column's L1 delta is no longer above ``tol``."""
    v = graph.num_vertices
    sources = _validate_sources(sources, v)
    dev = graph.device
    if sources.size == 0:
        return torch.zeros((v, 0), dtype=torch.float32, device=dev)
    s = sources.shape[0]
    src = graph.src.to(torch.int64)
    out_deg = segment_sum(torch.ones_like(src), src, v)
    inv_out = torch.where(out_deg > 0, 1.0 / torch.clamp(out_deg, min=1).to(torch.float32),
                          torch.zeros(v, dtype=torch.float32, device=dev))
    dangling = out_deg == 0
    reset = torch.zeros((v, s), dtype=torch.float32, device=dev)
    reset[torch.as_tensor(sources, dtype=torch.int64, device=dev),
          torch.arange(s, device=dev)] = 1.0
    inflow = SegmentSums(graph.dst, v)
    a = _f32(alpha, dev)
    teleport = (1.0 - a) * reset
    pr = torch.full((v, s), 1.0 / v, dtype=torch.float32, device=dev)
    tol = float(np.float32(tol))
    it, delta = 0, 1.0
    while delta > tol and it < max_iter:
        flow = inflow.sum((pr * inv_out[:, None])[src])
        dangling_mass = torch.where(dangling[:, None], pr, 0.0).sum(dim=0)
        new = a * (flow + dangling_mass[None, :] * reset) + teleport
        delta = float((new - pr).abs().sum(dim=0).max())
        pr, it = new, it + 1
    return pr
