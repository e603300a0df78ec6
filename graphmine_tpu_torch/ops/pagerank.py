"""PageRank and batched personalized PageRank as power iterations (PyTorch).

Counterpart of ``graphmine_tpu/ops/pagerank.py``, on its segment-sum
path: rank is a dense float32 vector; one iteration gathers along edge
sources and sums at destinations (:class:`~graphmine_tpu_torch.ops.
segment.SegmentSums`: the sort by destination is paid once, and each
destination's inflow is summed on its own in a fixed order, so a run
repeats itself bit for bit on each device). Damping ``alpha``, uniform or
personalized teleport, dangling mass redistributed through the teleport
vector, ranks summing to 1.

The JAX package's blocked inflow (its bin-then-reduce layout, picked by
``plan="auto"`` only from V >= 2^21 and M >= 2^22) is not ported:
``"auto"`` keeps the segment path at every size here, and a plan object
raises :class:`~graphmine_tpu_torch.pipeline.planner.PlanError`.

The stopping rule is the JAX package's, ``delta > tol`` on the L1 change,
read on the host once per iteration (one synchronise each).
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.segment import SegmentSums, segment_sum


def _check_plan(plan) -> None:
    """``"auto"`` and ``None`` take the segment path; a blocked plan is
    refused for what it is, anything else as the JAX package refuses it."""
    if isinstance(plan, str) and plan == "auto" or plan is None:
        return
    if not isinstance(plan, str) and hasattr(plan, "num_vertices") and hasattr(
            plan, "num_messages"):
        from graphmine_tpu_torch.pipeline.planner import _not_ported

        raise _not_ported("blocked", "PageRank plan")
    raise ValueError(f"plan must be 'auto', None, or a BlockedPlan; got {plan!r}")


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
    above ``tol``, or after ``max_iter`` iterations. ``plan``: ``"auto"``
    or ``None`` (the segment path); ``sink``: optional metrics sink for a
    ``superstep_timing`` record of the run.
    """
    _check_plan(plan)
    if sink is None:
        return _pagerank(graph, alpha, max_iter, tol, reset, weights)[0]
    from graphmine_tpu_torch.obs.costmodel import (
        emit_superstep_timing,
        superstep_cost,
        timed_fixpoint,
    )

    (pr, iters), secs, cold = timed_fixpoint(
        lambda: _pagerank(graph, alpha, max_iter, tol, reset, weights))
    iters = max(int(iters), 1)
    cost = superstep_cost("pagerank_inflow", "sort", graph.num_vertices, graph.num_messages,
                          graph.num_edges, weighted=weights is not None)
    emit_superstep_timing(sink, "pagerank_inflow", cost, iters, iters, secs, graph.num_edges,
                          variant="fused", cold_compile=cold)
    return pr


def _as_tensor(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def _pagerank(graph: Graph, alpha, max_iter: int, tol, reset, weights):
    """``(ranks, iterations)``."""
    dev, v = graph.device, graph.num_vertices
    src = graph.src.to(torch.int64)
    by_src = SegmentSums(src, v)
    inflow = SegmentSums(graph.dst, v)
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
        if edge_frac is None:
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
