"""Propagation blocking: the destination-binned superstep family (PyTorch).

Counterpart of ``graphmine_tpu/ops/blocking.py`` on one device, the third
plan family beside the sort-based superstep and the degree-bucketed plan:

1. **Plan** (:class:`BlockedPlan`, built once per graph): destination
   vertices are grouped into contiguous **bins** of at most ``tile_slots``
   messages, snapped to vertex boundaries (a vertex with more messages
   than the budget gets a bin of its own). Every bin is padded to the
   largest, so the tile holds ``num_bins * tile_slots + 1`` slots; the
   last slot is never written and is the target of every row padding.
   The ``[M]`` arrays are built on the graph's device: the sender-major
   stream (``src_sorted``, a stable sort of the senders) and each
   streamed message's tile slot (``scatter_pos``, its bin from
   ``torch.searchsorted``). Only the bin bounds and the width classes are
   computed on the host. Every plan array equals the JAX package's.
2. **Bin pass** (each superstep): read the values in sender-major order
   (monotone gather indices) and scatter each message into its slot of
   the destination-binned tile (unique indices, so deterministic on
   CUDA).
3. **Reduce pass**: each destination's messages are one contiguous run
   of its bin, gathered as dense rows on the bucketed plan's width ladder
   (with tile-local indices) and reduced by its row mode, weighted row
   mode, row minimum or row sum. Rows are order-independent, so LPA and
   CC labels are bit-equal to the sort-based superstep's; PageRank's row
   sums reassociate and agree to float tolerance.

There is no hub histogram in this family: a hub's run rides one wide row
of the 1.5x-extended width ladder.

**The crossover is the card's, not the TPU's.** The JAX package picks
this family from V >= 2^21 and M >= 2^22, sized to a TPU core's ~16 MB of
VMEM. On the H100 the bucketed superstep's random gather reads a ``[V]``
int32 label table that the 50 MB L2 holds: smoke phase 10c (``python3
chip_smoke.py --blocked-only``; R-MAT at edge factor 8.3, scales 20-24)
measured a random gather of 70.4-72.8 G slots/s at scales 20-22, 51.9-52.1
G at 23 and 34.3-34.4 G at 24, against 10.4-12.4 G slots/s for the bin
pass (NVIDIA H100 80GB HBM3, 700.00 W, two runs; PERF.md §6). The blocked
superstep took 1.01-1.02x the bucketed one's time at scale 21, 1.12-1.18x
at 22, 1.26-1.44x at 23 and 1.42-1.43x at 24; at scale 20 one run read
0.79x and the other 1.14x. It wins at no scale from which it also wins
at every larger one, so the port's walls sit above the ladder's top rung
and ``"auto"`` never picks this family on one card. Requests and
``GRAPHMINE_SUPERSTEP_FAMILY`` still run it, and the environment
variables move every wall, as in the JAX package. Consequence: from V >= 2^21 and M >= 2^22 the port's
``"auto"`` takes the bucketed family where the JAX package's takes the
blocked one. Labels are the same either way; PageRank agrees to float
tolerance.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.graph.container import Graph, _build_with_csr
from graphmine_tpu_torch.ops.bucketed_mode import (
    _SENTINEL,
    BucketedModePlan,
    _bucket_mode,
    _bucket_wmode,
    _class_rows,
    _extend_widths,
)

# ---- the family crossover (single owner) -----------------------------------
# bucketed beats sort from 2^16 messages (the JAX package's r1 crossover,
# which the port has always used).
BUCKETED_MIN_MESSAGES = 1 << 16
# blocked: above the top rung of smoke phase 10c, where it never won from
# any rung on (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6): the ladder's top
# is V = 2^24, M = 278,501,784, and no single-card graph reaches 2^31
# messages (the int32 message bound), so "auto" never picks it on one card.
BLOCKED_MIN_MESSAGES = 1 << 31
BLOCKED_MIN_VERTICES = 1 << 25
# One bin's message budget in int32 slots (1 MiB), the JAX package's
# default: phase 10c's sweep at scale 22 found no budget faster beyond the
# run-to-run spread (22.7-23.2 ms at 2^16, 2^18 and 2^20 in two runs, one
# 27.8 ms reading at 2^18 where the bucketed superstep also read 27.7;
# NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6).
DEFAULT_TILE_SLOTS = 1 << 18

FAMILIES = ("blocked", "bucketed", "sort", "sharded_2d")

_INT32_MAX = (1 << 31) - 1


def crossover_thresholds() -> dict:
    """The active crossover constants, environment overrides applied: the
    numbers every ``plan="auto"`` resolution reads, and its records carry."""
    env = os.environ.get
    return {
        "bucketed_min_messages": BUCKETED_MIN_MESSAGES,
        "blocked_min_messages": int(env("GRAPHMINE_BLOCKED_MIN_MESSAGES", BLOCKED_MIN_MESSAGES)),
        "blocked_min_vertices": int(env("GRAPHMINE_BLOCKED_MIN_VERTICES", BLOCKED_MIN_VERTICES)),
        "blocked_tile_slots": int(env("GRAPHMINE_BLOCKED_TILE_SLOTS", DEFAULT_TILE_SLOTS)),
    }


def select_superstep_family(num_vertices: int, num_messages: int, requested: str = "auto",
                            weighted: bool = False, num_devices: int = 1) -> tuple[str, str]:
    """``(family, reason)``: the single policy behind ``plan="auto"`` in
    LPA, CC and PageRank and the planner's ``plan_superstep``.

    ``requested`` forces a family (validated), else
    ``GRAPHMINE_SUPERSTEP_FAMILY`` forces it process-wide, else the
    walls of :func:`crossover_thresholds` decide: ``blocked`` from both
    its vertex and its message wall, ``bucketed`` from 2^16 messages,
    ``sort`` below. Weights never change the choice. ``sharded_2d`` and
    more than one device (the sharded families of the serving repair)
    raise :class:`~graphmine_tpu_torch.pipeline.planner.PlanError` naming
    ROADMAP item A7b."""
    del weighted
    from graphmine_tpu_torch.pipeline.planner import _not_ported

    if int(num_devices) != 1:
        raise _not_ported("sharded_2d", "multi-device superstep")
    if requested != "auto":
        if requested not in FAMILIES:
            raise ValueError(f"unknown superstep family {requested!r}; expected one of "
                             f"{FAMILIES} or 'auto'")
        if requested == "sharded_2d":
            raise _not_ported(requested, "superstep family")
        return requested, f"requested {requested!r}"
    env = os.environ.get("GRAPHMINE_SUPERSTEP_FAMILY")
    if env:
        if env not in FAMILIES:
            raise ValueError(f"GRAPHMINE_SUPERSTEP_FAMILY={env!r} is not one of {FAMILIES}")
        if env == "sharded_2d":
            raise _not_ported(env, "superstep family")
        return env, f"GRAPHMINE_SUPERSTEP_FAMILY={env} (env override)"
    thr = crossover_thresholds()
    min_m, min_v = thr["blocked_min_messages"], thr["blocked_min_vertices"]
    if num_messages >= min_m and num_vertices >= min_v:
        return "blocked", (
            f"V={num_vertices} >= {min_v} and M={num_messages} >= {min_m}: destination-"
            "binned tiles beat the bucketed superstep's random gather on this card "
            "(chip smoke phase 10c)"
        )
    if num_messages >= BUCKETED_MIN_MESSAGES:
        return "bucketed", (f"M={num_messages} >= {BUCKETED_MIN_MESSAGES}: degree-bucketed "
                            "dense rows amortize the host plan build (r1 crossover)")
    return "sort", (f"M={num_messages} < {BUCKETED_MIN_MESSAGES}: sort-based "
                    "segment_mode superstep (plan build would dominate)")


# ---- the plan ---------------------------------------------------------------


def _bin_bounds(ptr: np.ndarray, tile_slots: int) -> np.ndarray:
    """Bin vertex bounds, int64 ``[n_bins + 1]``: greedy contiguous vertex
    ranges of at most ``tile_slots`` messages, snapped to vertex
    boundaries; a vertex above the budget gets a bin of its own."""
    v = len(ptr) - 1
    bounds = [0]
    while bounds[-1] < v:
        start = bounds[-1]
        end = int(np.searchsorted(ptr, ptr[start] + tile_slots, side="right")) - 1
        bounds.append(min(max(end, start + 1), v))
    return np.asarray(bounds, dtype=np.int64)


def _blocked_layout(ptr: np.ndarray, send: torch.Tensor, tile_slots: int,
                    weights: torch.Tensor | None = None):
    """The layout on ``send``'s device: ``(src_sorted, scatter_pos,
    bounds, tb, rows)`` with ``rows`` a list, one per width class, of
    ``(vertex ids, [n, w] tile slots with -1 padding, [n, w] weights or
    None)``."""
    dev = send.device
    deg = ptr[1:] - ptr[:-1]
    m = int(ptr[-1])
    bounds = _bin_bounds(ptr, tile_slots)
    bin_msg_start = ptr[bounds[:-1]]
    tb = int((ptr[bounds[1:]] - bin_msg_start).max(initial=1))
    tb = -(-tb // 8) * 8
    if (len(bounds) - 1) * tb + 1 > _INT32_MAX:
        raise ValueError(
            f"the blocked tile needs {(len(bounds) - 1) * tb + 1:,} slots, past the int32 "
            "index bound; raise tile_slots or use the bucketed family"
        )

    # each CSR message's tile slot: bin-major, CSR order within its bin
    starts = torch.from_numpy(bin_msg_start).to(dev)
    pos = torch.arange(m, dtype=torch.int64, device=dev)
    bin_of = torch.searchsorted(starts, pos, right=True) - 1
    slot_of_csr = bin_of * tb + (pos - starts[bin_of])
    del pos, bin_of
    # sender-major stream: a stable sort keeps equal senders in CSR order
    src_sorted, order = torch.sort(send[:m], stable=True)
    scatter_pos = slot_of_csr[order].to(torch.int32)
    del order

    widths = _extend_widths(int(deg.max(initial=1)))
    rows = []
    for c, vr in _class_rows(deg, widths, deg > 0):
        w = int(widths[c])
        first = torch.from_numpy(ptr[vr]).to(dev)
        offs = torch.arange(w, dtype=torch.int64, device=dev)[None, :]
        valid = offs < torch.from_numpy(deg[vr]).to(dev)[:, None]
        idx = torch.where(valid, slot_of_csr[first][:, None] + offs, -1)
        wmat = None
        if weights is not None:
            cidx = torch.clamp(first[:, None] + offs, max=max(m - 1, 0))
            wmat = torch.where(valid, weights[cidx], 0.0).to(torch.float32)
        rows.append((vr, idx, wmat))
    return src_sorted.to(torch.int32), scatter_pos, bounds, tb, rows


def _on(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (a tensor, or an array copied) as a ``dtype`` tensor on ``dev``."""
    t = x if torch.is_tensor(x) else torch.from_numpy(np.array(x))
    return t.to(device=dev, dtype=dtype)


@dataclass(frozen=True)
class BlockedPlan:
    """Static propagation-blocking plan of one graph's message CSR, every
    tensor on the graph's device.

    ``src_sorted``: int32 ``[M]`` senders in sender-major order (monotone).
    ``scatter_pos``: int32 ``[M]`` each streamed message's tile slot
    (bin-major, CSR order within a bin). ``row_idx[c]``: int32 ``[n_c,
    w_c]`` each destination's run as tile slots on the width ladder,
    padded with the reserved slot ``tile_alloc - 1``; ``row_vertex[c]``:
    int32 ``[n_c]`` the destinations. ``weight_mat[c]``: float32 ``[n_c,
    w_c]`` slot-aligned message weights (padding 0), present iff built
    from a weighted CSR. ``tile_slots`` is the padded bin width (the
    largest bin, a multiple of 8), ``tile_alloc = num_bins * tile_slots +
    1``.
    """

    src_sorted: torch.Tensor
    scatter_pos: torch.Tensor
    row_idx: tuple
    row_vertex: tuple
    num_vertices: int
    num_messages: int
    num_bins: int
    tile_slots: int
    tile_alloc: int
    weight_mat: tuple | None = None

    @property
    def num_width_classes(self) -> int:
        return len(self.row_idx)

    @property
    def padded_row_slots(self) -> int:
        """The reduce pass's gathered slots, row padding included."""
        return int(sum(int(r.shape[0]) * int(r.shape[1]) for r in self.row_idx))

    @classmethod
    def from_graph(cls, graph: Graph, tile_slots: int | None = None) -> "BlockedPlan":
        """The plan of ``graph`` on its device, with the weight payload of
        a weighted graph; only ``msg_ptr`` comes to the host."""
        return cls.from_ptr(graph.msg_ptr.cpu().numpy(), graph.num_vertices, graph.msg_send,
                            weights_sorted=graph.msg_weight, tile_slots=tile_slots)

    @classmethod
    def from_ptr(cls, ptr: np.ndarray, num_vertices: int, send_sorted,
                 weights_sorted=None, tile_slots: int | None = None,
                 device=None) -> "BlockedPlan":
        """The plan from the message CSR: host row pointers ``ptr``
        (``[V+1]``), the senders ``send_sorted`` (``[M]``, CSR order) and
        optional weights ``weights_sorted`` (``[M]``). Tensors keep their
        device; NumPy inputs go to ``device`` (CUDA unless named).
        ``tile_slots`` defaults to ``GRAPHMINE_BLOCKED_TILE_SLOTS``, else
        :data:`DEFAULT_TILE_SLOTS`."""
        if tile_slots is None:
            tile_slots = int(os.environ.get("GRAPHMINE_BLOCKED_TILE_SLOTS", DEFAULT_TILE_SLOTS))
        if tile_slots < 1:
            raise ValueError("tile_slots must be >= 1")
        dev = (send_sorted.device if torch.is_tensor(send_sorted) and device is None
               else resolve_device(device))
        ptr = np.asarray(ptr, dtype=np.int64)
        m = int(ptr[-1]) if len(ptr) else 0
        if m >= _INT32_MAX:
            raise ValueError("message count exceeds int32; shard the build")
        send = _on(send_sorted, dev, torch.int32)
        weights = None if weights_sorted is None else _on(weights_sorted, dev, torch.float32)
        if m == 0:
            empty = torch.zeros(0, dtype=torch.int32, device=dev)
            return cls(src_sorted=empty, scatter_pos=empty.clone(), row_idx=(), row_vertex=(),
                       num_vertices=num_vertices, num_messages=0, num_bins=0,
                       tile_slots=tile_slots, tile_alloc=1,
                       weight_mat=None if weights is None else ())
        src_sorted, scatter_pos, bounds, tb, rows = _blocked_layout(ptr, send, tile_slots,
                                                                    weights)
        n_bins = len(bounds) - 1
        # one reserved slot past the bins, never written: it keeps the fill
        # value and every row padding points at it
        tile_alloc = n_bins * tb + 1
        row_idx, row_vertex, weight_mat = [], [], []
        for vr, idx, wmat in rows:
            row_vertex.append(torch.from_numpy(vr.astype(np.int32)).to(dev))
            row_idx.append(torch.where(idx < 0, tile_alloc - 1, idx).to(torch.int32))
            if wmat is not None:
                weight_mat.append(wmat)
        return cls(src_sorted=src_sorted, scatter_pos=scatter_pos, row_idx=tuple(row_idx),
                   row_vertex=tuple(row_vertex), num_vertices=num_vertices, num_messages=m,
                   num_bins=n_bins, tile_slots=tb, tile_alloc=tile_alloc,
                   weight_mat=tuple(weight_mat) if weights is not None else None)


def build_graph_and_blocked_plan(src, dst, num_vertices: int | None = None,
                                 symmetric: bool = True, edge_weights=None,
                                 tile_slots: int | None = None, device=None):
    """The :class:`Graph` and its :class:`BlockedPlan` from ONE message-CSR
    pass on ``device`` (CUDA unless named): the blocked twin of
    :func:`~graphmine_tpu_torch.ops.bucketed_mode.build_graph_and_plan`."""
    graph, ptr = _build_with_csr(src, dst, num_vertices, symmetric, edge_weights, device)
    return graph, BlockedPlan.from_ptr(ptr, graph.num_vertices, graph.msg_send,
                                       weights_sorted=graph.msg_weight, tile_slots=tile_slots)


# ---- supersteps -------------------------------------------------------------


def _blocked_tile(plan: BlockedPlan, values: torch.Tensor, fill) -> torch.Tensor:
    """The bin pass: ``values`` read in sender-major order and scattered
    into the tile; slots nobody writes (bin padding, the reserved slot)
    keep ``fill``, which the reduce rows rely on."""
    tile = torch.full((plan.tile_alloc,), fill, dtype=values.dtype, device=values.device)
    tile[plan.scatter_pos] = values[plan.src_sorted]
    return tile


def _check_plan(plan: BlockedPlan, num_vertices: int, graph: Graph | None) -> None:
    if num_vertices != plan.num_vertices or (
            graph is not None and graph.num_messages != plan.num_messages):
        raise ValueError(
            f"plan built for V={plan.num_vertices}, M={plan.num_messages} but got "
            f"V={num_vertices}" + (f", M={graph.num_messages}" if graph is not None else "")
            + " — plan/graph mismatch"
        )


def lpa_superstep_blocked(labels: torch.Tensor, graph: Graph, plan: BlockedPlan) -> torch.Tensor:
    """One LPA superstep on the blocked plan: labels bit-equal to
    :func:`~graphmine_tpu_torch.ops.lpa.lpa_superstep`. A plan with a
    weight payload takes the weighted row modes; a weighted graph with a
    weightless plan raises (weights are never silently dropped)."""
    if graph.msg_weight is not None and plan.weight_mat is None:
        raise ValueError(
            "graph carries msg_weight but the blocked plan has no weight payload; build it "
            "with BlockedPlan.from_graph / build_graph_and_blocked_plan(edge_weights=...), "
            "or pass plan=None / a weighted bucketed plan — weights are never silently "
            "dropped"
        )
    _check_plan(plan, labels.shape[0], graph)
    labels = labels.to(torch.int32)
    tile = _blocked_tile(plan, labels, _SENTINEL)
    out = labels.clone()
    wmats = plan.weight_mat or (None,) * len(plan.row_idx)
    for ids, ridx, wmat in zip(plan.row_vertex, plan.row_idx, wmats):
        mat = tile[ridx]
        out[ids] = _bucket_mode(mat) if wmat is None else _bucket_wmode(mat, wmat)
    return out


def cc_superstep_blocked(labels: torch.Tensor, plan: BlockedPlan) -> torch.Tensor:
    """One CC superstep on the blocked plan: the row minimum of each run
    (padding reads the int32-max fill, which never wins), then the
    pointer jump; equal to :func:`~graphmine_tpu_torch.ops.cc.cc_superstep`
    every superstep."""
    _check_plan(plan, labels.shape[0], None)
    labels = labels.to(torch.int32)
    tile = _blocked_tile(plan, labels, _SENTINEL)
    new = labels.clone()
    for ids, ridx in zip(plan.row_vertex, plan.row_idx):
        new[ids] = torch.minimum(new[ids], tile[ridx].min(dim=1).values)  # ids distinct
    return torch.minimum(new, new[new.to(torch.int64)])


def blocked_inflow(plan: BlockedPlan, contrib: torch.Tensor) -> torch.Tensor:
    """Per-destination sum of ``contrib[sender]`` over the blocked layout,
    the PageRank inflow: each destination's row summed on its own, so it
    agrees with a segment sum to float tolerance, not to the bit."""
    if contrib.shape[0] != plan.num_vertices:
        raise ValueError(f"plan built for V={plan.num_vertices} but contrib has "
                         f"V={contrib.shape[0]} — plan/graph mismatch")
    tile = _blocked_tile(plan, contrib, 0.0)
    inflow = torch.zeros(plan.num_vertices, dtype=contrib.dtype, device=contrib.device)
    for ids, ridx in zip(plan.row_vertex, plan.row_idx):
        inflow[ids] = tile[ridx].sum(dim=1)
    return inflow


# ---- plan builds and their records ------------------------------------------


def _sync(plan) -> None:
    t = plan.src_sorted if isinstance(plan, BlockedPlan) else (
        plan.vertex_ids[0] if plan.vertex_ids else None)
    if t is not None and t.is_cuda:
        torch.cuda.synchronize(t.device)


def timed_plan_build(build) -> tuple:
    """``(plan, seconds)`` of one plan build, its device work included."""
    t0 = time.perf_counter()
    plan = build()
    _sync(plan)
    return plan, time.perf_counter() - t0


def build_family_plan(graph: Graph, family: str):
    """A fresh plan of ``family`` (``"blocked"`` or ``"bucketed"``) for
    ``graph`` on its device, with its weight payload."""
    if family == "blocked":
        return BlockedPlan.from_graph(graph)
    if family == "bucketed":
        return BucketedModePlan.from_ptr(graph.msg_ptr.cpu().numpy(), graph.num_vertices,
                                         graph.msg_send, weights=graph.msg_weight)
    raise ValueError(f"no plan to build for family {family!r}")


def plan_build_stats(plan, num_edges: int) -> dict:
    """The ``plan_build`` record's payload for either plan family: bins,
    width classes and padded gather slots per edge (the blocked family:
    the bin pass's M slots plus the reduce rows)."""
    if isinstance(plan, BucketedModePlan):
        from graphmine_tpu_torch.ops.bucketed_mode import plan_build_stats as bucketed_stats

        return bucketed_stats(plan, num_edges)
    if not isinstance(plan, BlockedPlan):
        raise TypeError(f"unknown plan type {type(plan).__name__}")
    slots = plan.num_messages + plan.padded_row_slots
    return {
        "family": "blocked", "bins": plan.num_bins, "width_classes": plan.num_width_classes,
        "tile_slots": plan.tile_slots,
        "padded_slots_per_edge": round(slots / max(int(num_edges), 1), 3),
    }


def emit_plan_records(sink, op: str, plan, reason: str, seconds: float, cached: bool,
                      num_edges: int, num_messages: int, num_vertices: int | None = None) -> None:
    """The ``impl_selected`` record of an auto resolution and, when a plan
    was resolved (``plan=None`` is the sort family), its ``plan_build``
    record, each with the thresholds and the cost model's ``cost``
    sub-record; nothing without a sink."""
    if sink is None:
        return
    from graphmine_tpu_torch.obs.costmodel import superstep_cost

    family = "sort" if plan is None else plan_build_stats(plan, num_edges)["family"]
    v = num_vertices if num_vertices is not None else getattr(plan, "num_vertices", 0)
    cost = superstep_cost(op, family, v, num_messages, num_edges, plan=plan).record()
    sink.emit("impl_selected", op=op, impl=family, n=num_messages, reason=reason,
              thresholds=crossover_thresholds(), cost=cost)
    if plan is not None:
        sink.emit("plan_build", op=op, seconds=round(seconds, 6), cached=cached, cost=cost,
                  **plan_build_stats(plan, num_edges))
