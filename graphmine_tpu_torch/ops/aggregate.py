"""Generic message passing: ``aggregate_messages`` + ``pregel`` (PyTorch).

Counterpart of ``graphmine_tpu/ops/aggregate.py``, GraphFrames'
``aggregateMessages`` and ``pregel`` substrate. A superstep is

    gather endpoint values → per-edge message fn → segment-reduce at the
    receiving vertex → vertex update fn

with message and update functions as plain callables over tensors, and
vertex state as a tensor or a pytree (dict, tuple, list) of ``[V]``
tensors. Sums of float messages run in message order on the CPU (see
:func:`~graphmine_tpu_torch.ops.segment.segment_sum`); minima, maxima,
integer sums and the mode are exact in any order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.segment import segment_max, segment_min, segment_mode, segment_sum

# message fn: (src_values, dst_values, edge_values) -> [E] message tensor.
MessageFn = Callable[[Any, Any, Any], torch.Tensor]


def _tree_take(tree: Any, idx: torch.Tensor) -> Any:
    return pytree.tree_map(lambda a: a[idx], tree)


def _reduce(reduce: str, msgs: torch.Tensor, recv: torch.Tensor, num_segments: int):
    if reduce == "sum":
        return segment_sum(msgs, recv, num_segments)
    if reduce == "max":
        return segment_max(msgs, recv, num_segments)
    if reduce == "min":
        return segment_min(msgs, recv, num_segments)
    if reduce == "mean":
        total = segment_sum(msgs, recv, num_segments)
        count = segment_sum(torch.ones(recv.shape[0], dtype=msgs.dtype, device=msgs.device),
                            recv, num_segments)
        count = count.view(-1, *([1] * (total.dim() - 1)))
        return total / torch.clamp(count, min=1)
    if reduce == "mode":
        if msgs.is_floating_point() or msgs.dtype == torch.bool:
            raise TypeError(
                f"reduce='mode' needs integer messages, got {msgs.dtype} "
                "(segment_mode is pure int32 arithmetic)"
            )
        mode, _ = segment_mode(recv, msgs, num_segments)
        return mode
    raise ValueError(f"unknown reduce {reduce!r}; want sum|max|min|mean|mode")


def aggregate_messages(graph: Graph, vertex_values: Any, edge_values: Any = None, *,
                       to_dst: MessageFn | None = None, to_src: MessageFn | None = None,
                       reduce: str = "sum") -> torch.Tensor:
    """One gather → message → segment-reduce round (GraphFrames
    ``aggregateMessages`` semantics).

    ``vertex_values``: a tensor or pytree of ``[V]`` tensors, gathered at
    both endpoints and handed to the message functions; ``edge_values``:
    optional ``[E]`` edge attributes; ``to_dst`` / ``to_src``:
    ``fn(src_vals, dst_vals, edge_vals) -> [E] msgs`` sent to the edge's
    dst / src (at least one); ``reduce``: ``sum|max|min|mean|mode`` per
    receiving vertex. Vertices receiving no message get the reducer's
    identity (0 for sum/mean, the dtype's max/min for min/max, int32 max
    for mode).
    """
    if to_dst is None and to_src is None:
        raise ValueError("provide at least one of to_dst/to_src")
    src, dst = graph.src.to(torch.int64), graph.dst.to(torch.int64)
    sv = _tree_take(vertex_values, src)
    dv = _tree_take(vertex_values, dst)
    msgs, recv = [], []
    if to_dst is not None:
        msgs.append(torch.as_tensor(to_dst(sv, dv, edge_values)))
        recv.append(dst)
    if to_src is not None:
        msgs.append(torch.as_tensor(to_src(sv, dv, edge_values)))
        recv.append(src)
    m = msgs[0] if len(msgs) == 1 else torch.cat(msgs)
    r = recv[0] if len(recv) == 1 else torch.cat(recv)
    return _reduce(reduce, m, r, graph.num_vertices)


def pregel(graph: Graph, init_state: Any, *, to_dst: MessageFn | None = None,
           to_src: MessageFn | None = None, reduce: str = "sum",
           update: Callable[[Any, torch.Tensor], Any], max_iter: int = 10,
           edge_values: Any = None) -> Any:
    """Run ``max_iter`` synchronous supersteps of a vertex program: each
    computes the per-vertex aggregate with :func:`aggregate_messages` and
    applies ``update(state, aggregate) -> new_state``. A fixed superstep
    count, the reference's ``maxIter`` contract."""
    state = init_state
    for _ in range(max_iter):
        agg = aggregate_messages(graph, state, edge_values, to_dst=to_dst, to_src=to_src,
                                 reduce=reduce)
        state = update(state, agg)
    return state
