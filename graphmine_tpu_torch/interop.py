"""Carry the JAX package's graph state into the port.

This system has no model weights: its state is the graph (the message
CSR, with edge weights on a weighted graph) and the LPA plan. :func:`reference_arrays` flattens a graph and fused plan of
the JAX package (or of this port) into a dict of NumPy arrays, reading
them by attribute with ``np.asarray`` and importing neither package;
:func:`graph_from_reference_arrays` builds the port's :class:`Graph` and
:class:`BucketedModePlan` from such a dict on a device. The parity tests
use the pair to run the port's ops on exactly the CSR and plan JAX built.
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.bucketed_mode import BucketedModePlan

_GRAPH_KEYS = ("src", "dst", "msg_recv", "msg_send", "msg_ptr")
_HIST_KEYS = ("hist_vertex_ids", "hist_send", "hist_row_offset")


def reference_arrays(graph, plan=None) -> dict[str, np.ndarray]:
    """Flatten ``graph`` (and a fused ``plan``, optional) into NumPy arrays:
    the graph fields, ``num_vertices``/``symmetric`` as 0-d arrays, and the
    plan's buckets as ``plan_vertex_ids_<b>`` / ``plan_send_idx_<b>``; a
    weighted graph adds ``msg_weight``, and its plan ``plan_weight_mat_<b>``
    and ``plan_hist_weight``."""
    out = {key: np.asarray(getattr(graph, key)) for key in _GRAPH_KEYS}
    out["num_vertices"] = np.asarray(graph.num_vertices)
    out["symmetric"] = np.asarray(graph.symmetric)
    if graph.msg_weight is not None:
        out["msg_weight"] = np.asarray(graph.msg_weight)
    if plan is not None:
        if plan.send_idx is None:
            raise ValueError("only fused plans (send_idx) carry over")
        for b, (ids, sidx) in enumerate(zip(plan.vertex_ids, plan.send_idx)):
            out[f"plan_vertex_ids_{b}"] = np.asarray(ids)
            out[f"plan_send_idx_{b}"] = np.asarray(sidx)
        for b, wmat in enumerate(plan.weight_mat or ()):
            out[f"plan_weight_mat_{b}"] = np.asarray(wmat)
        for key in _HIST_KEYS + ("hist_weight",):
            if getattr(plan, key) is not None:
                out[f"plan_{key}"] = np.asarray(getattr(plan, key))
    return out


def graph_from_reference_arrays(arrays: dict[str, np.ndarray], device=None):
    """``(Graph, BucketedModePlan | None)`` on ``device`` from a dict made
    by :func:`reference_arrays`; the plan is ``None`` when the dict holds
    no bucket."""
    dev = resolve_device(device)
    to = lambda a: torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)
    to_f = lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
    v = int(arrays["num_vertices"])
    weighted = "msg_weight" in arrays
    graph = Graph(**{key: to(arrays[key]) for key in _GRAPH_KEYS}, num_vertices=v,
                  symmetric=bool(arrays.get("symmetric", True)),
                  msg_weight=to_f(arrays["msg_weight"]) if weighted else None)
    n_buckets = sum(1 for key in arrays if key.startswith("plan_vertex_ids_"))
    if n_buckets == 0 and "plan_hist_vertex_ids" not in arrays:
        return graph, None
    hist = {key: to(arrays[f"plan_{key}"]) if f"plan_{key}" in arrays else None
            for key in _HIST_KEYS}
    plan = BucketedModePlan(
        vertex_ids=tuple(to(arrays[f"plan_vertex_ids_{b}"]) for b in range(n_buckets)),
        send_idx=tuple(to(arrays[f"plan_send_idx_{b}"]) for b in range(n_buckets)),
        num_vertices=v, num_messages=graph.num_messages, **hist,
        weight_mat=tuple(to_f(arrays[f"plan_weight_mat_{b}"]) for b in range(n_buckets))
        if weighted else None,
        hist_weight=to_f(arrays["plan_hist_weight"]) if "plan_hist_weight" in arrays else None,
    )
    return graph, plan
