"""Analytical memory model: what an operating point should hold on the card.

Counterpart of the single-device part of ``graphmine_tpu/obs/memmodel.py``,
re-derived for the port's own buffers (the JAX package's 36 and 16 B/edge
are XLA's layout on a TPU and are not carried over):

- the graph (``graph/container.py``): ``src``/``dst`` int32 [E], the
  message CSR ``msg_recv``/``msg_send`` int32 [M = 2E] and ``msg_ptr``
  int32 [V+1], ``msg_weight`` float32 [M] when weighted;
- the fused plan (``ops/bucketed_mode.py::BucketedModePlan``): one int32
  ``[n_b, w_b]`` sender matrix and one int32 ``[n_b]`` vertex list per
  width class, the hubs' int32 sender and row-offset arrays, and the
  float32 weight matrices of a weighted plan;
- the blocked plan (``ops/blocking.py::BlockedPlan``): the int32 stream
  pair ``src_sorted``/``scatter_pos`` [M], the int32 tile of
  ``tile_alloc`` slots, the int32 reduce rows and their vertex lists, and
  the float32 weight rows of a weighted plan; its superstep holds the
  streamed values [M] while the tile fills, then, class by class, the
  gathered rows with the mode's scratch (smoke phase 10b measured the
  streamed values alone 17% short of its peak: the index kernel copies
  the scatter indices to int64, which the model now counts);
- a superstep's transient: the labels padded with the sentinel and the
  output copy, then, bucket by bucket, the gathered ``[n_b, w_b]`` labels
  and the mode's scratch (pairwise: two bool ``[n_b, w_b, w_b]`` masks
  and int32 counts; row sort: int32 values with int64 indices, a cummax
  and the ranks), and the hubs' int32 ``[n_hub, V]`` histogram; the peak
  is the largest of these;
- LOF (:func:`lof_footprint`): the exact kNN on ``knn_topk`` (features,
  the ``[N, k]`` outputs, the packed copy the wrapper allocates, and the
  8-byte keys in device scratch past k = 1,760) or the IVF index
  (``ops/ann.py``: the probe lists and the chunk results ``[R, 4096, k]``
  float32 + int32, which live twice while the merge's flat copies are
  made), with the LOF formula's ``[N, k]`` temporaries.

Without a plan the estimate uses the byte seeds below, which are these
counts at the width ladder's <= 10% padding; a plan makes the counts
exact. :func:`emit_memory_watermark` alone emits
``memory_watermark`` records (predicted beside the measured bytes from
``torch.cuda.memory_allocated`` and its peak, or host RSS off CUDA), and
:func:`predegrade_superstep` walks the family ladder at plan time.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from math import sqrt

from graphmine_tpu_torch.obs.costmodel import _bucketed_padded_slots, _plan_family, _plan_weighted

_I32 = 4  # bytes per int32/float32 slot
_PAD = 1.10  # the width ladder pads each row by at most ~10%

# ---- byte seeds (single owner) ----------------------------------------------
# Per edge (M = 2E messages): endpoints 8 + message CSR 16 + plan mats
# 4 * 2 * 1.1 = 8.8 + the gathered transient, bounded by one gathered copy
# of the plan mats, 8.8. Weighted: message weights 8 + weight mats 8.8.
# Per vertex: msg_ptr 4 + plan vertex ids 4 + labels in, out and padded 12.
BYTES_PER_EDGE = 8.0 + 16.0 + 2 * _I32 * 2 * _PAD
BYTES_PER_EDGE_WEIGHTED = 8.0 + _I32 * 2 * _PAD
SINGLE_BYTES_PER_VERTEX = 20.0
# The multi-device schedules (parallel/sharded.py, parallel/ring.py): the
# O(E) terms above divide by D. Replicated, per vertex on every shard: the
# full label vector in, its sentinel-padded copy, the all-gathered vector
# out and the driver's [V] state. Ring, per vertex over D: the own chunk,
# the new one, the chunk in hand, the copy in transit, the pointer jump's
# gathered chunk and the driver's share of its [V] state.
REPLICATED_BYTES_PER_VERTEX = 16.0
RING_BYTES_PER_VERTEX = 24.0
_SCHEDULES = ("single", "replicated", "ring")

# The IVF search's chunk height (ops/ann.py _CHUNK_B) and its batched
# distance block (_SEARCH_ELEMS entries), mirrored so this module needs no
# ops import.
IVF_CHUNK_B = 4096
IVF_SEARCH_ELEMS = 1 << 25
IVF_N_PROBE = 16

# knn_topk's launch plan (kernels/knn_cuda.py), mirrored: the fast
# instance packs 512-point tiles of 9 floats; the general instance keeps
# kcap = k rounded up to 32 keys a row, in device scratch past this k.
KNN_FAST_F, KNN_FAST_K = 8, 128
KNN_TILE_POINTS, KNN_TILE_FLOATS = 512, 512 * 9
KNN_SCRATCH_MIN_K = 1761

# The blocked family's bin budget (ops/blocking.py DEFAULT_TILE_SLOTS),
# mirrored: a sharded pre-build estimate's tile is at most one bin a shard.
BLOCKED_TILE_SLOTS_EST = 1 << 18

# The plan-time pre-degrade ladder: sharded_2d -> blocked -> bucketed ->
# sort, planner._SUPERSTEP_DEGRADE's order (sharded_2d's rung drops the
# per-peer tables for the one-all-gather exchange); sort is the floor.
FAMILY_DEGRADE = {"sharded_2d": "blocked", "blocked": "bucketed", "bucketed": "sort",
                  "sort": None}


@dataclass(frozen=True)
class MemEstimate:
    """Predicted peak device footprint of one operating point as a named
    byte inventory. ``exact`` when read off a built plan's shapes."""

    op: str
    family: str
    devices: int
    weighted: bool
    inventory: dict      # component -> bytes
    exact: bool
    unit: str = "bytes/device"

    @property
    def total_bytes(self) -> int:
        return int(sum(self.inventory.values()))

    def record(self) -> dict:
        """The ``mem`` sub-record (built here and nowhere else; the shape
        ``obs.schema.MEM_KEYS`` checks)."""
        return {
            "family": self.family, "devices": self.devices, "weighted": self.weighted,
            "total_bytes": self.total_bytes,
            "inventory": {k: int(v) for k, v in sorted(self.inventory.items())},
            "exact": self.exact, "unit": self.unit,
        }


# ---- the whole-run model (the planner's consumer) ----------------------------


def schedule_bytes_per_device(schedule: str, num_vertices: int, num_edges: int,
                              num_devices: int = 1, weighted: bool = False) -> int:
    """Modeled peak bytes per device of the LPA operating point for
    ``schedule`` (``single``, ``replicated`` or ``ring``)."""
    v, e, d = float(num_vertices), float(num_edges), float(max(num_devices, 1))
    edge = BYTES_PER_EDGE + (BYTES_PER_EDGE_WEIGHTED if weighted else 0.0)
    if schedule == "single":
        return int(edge * e + SINGLE_BYTES_PER_VERTEX * v)
    if schedule == "replicated":
        return int(edge * e / d + REPLICATED_BYTES_PER_VERTEX * v)
    if schedule == "ring":
        return int(edge * e / d + RING_BYTES_PER_VERTEX * v / d)
    raise ValueError(f"unknown schedule {schedule!r}")


def schedule_inventory(schedule: str, num_vertices: int, num_edges: int,
                       num_devices: int = 1, weighted: bool = False) -> dict:
    """The seeds decomposed into named components per device; their sum
    is :func:`schedule_bytes_per_device` up to per-term rounding."""
    if schedule not in _SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r}")
    v, e = float(num_vertices), float(num_edges)
    div = 1.0 if schedule == "single" else float(max(num_devices, 1))
    mats = _I32 * 2 * _PAD * e / div
    inv = {
        "edge_endpoints": 8.0 * e / div,
        "message_csr": 16.0 * e / div,
        "plan_mats": mats,
        "gather_transient": mats,
    }
    if weighted:
        inv["msg_weights"] = 8.0 * e / div
        inv["weight_mats"] = mats
    if schedule == "single":
        inv["message_csr"] += 4.0 * v
        inv["plan_vertex_ids"] = 4.0 * v
        inv["labels"] = 12.0 * v
    elif schedule == "replicated":
        inv["labels_replicated"] = 12.0 * v
        inv["exchange_buffer"] = 4.0 * v
    else:
        inv["labels_sharded"] = 8.0 * v / div
        inv["ring_chunks"] = 16.0 * v / div
    return {k: int(b) for k, b in inv.items()}


def schedule_footprint(schedule: str, num_vertices: int, num_edges: int,
                       num_devices: int = 1, weighted: bool = False,
                       op: str = "run_plan") -> MemEstimate:
    """The whole-run model as a :class:`MemEstimate` (the ``plan``
    record's ``mem``)."""
    return MemEstimate(op=op, family=schedule, devices=max(int(num_devices), 1),
                       weighted=bool(weighted),
                       inventory=schedule_inventory(schedule, num_vertices, num_edges,
                                                    num_devices, weighted),
                       exact=False)


# ---- one superstep -----------------------------------------------------------


def _bucket_transient(n: int, w: int, weighted: bool) -> int:
    """Bytes a bucket's step holds at once: the gathered ``[n, w]`` labels
    and its mode's scratch (``ops/bucketed_mode.py``)."""
    nw = n * w
    gathered = _I32 * nw
    if w <= 2:
        return gathered
    if w <= 32:
        # eq and its masked copy (bool [n, w, w]), counts and candidates
        scratch = 2 * nw * w + 2 * _I32 * nw
        if weighted:  # the weighted product and sums are float32
            scratch += _I32 * nw * w
        return gathered + scratch
    # row sort: values int32 + indices int64, run flags, cummax values +
    # indices, ranks, candidates
    scratch = (4 + 8) * nw + nw + (4 + 8) * nw + 2 * _I32 * nw
    if weighted:  # sorted weights, scan buffers
        scratch += 3 * _I32 * nw
    return gathered + scratch


def superstep_footprint(op: str, family: str, num_vertices: int, num_messages: int,
                        num_edges: int | None = None, plan=None,
                        weighted: bool | None = None, num_devices: int = 1) -> MemEstimate:
    """Footprint of one single-device superstep operating point
    (``"sort"``, ``"bucketed"`` or ``"blocked"``; ``"auto"`` with a plan
    reads it off).

    With a plan the counts are exact: the graph's arrays, the plan's
    tensors and the largest transient of its superstep. Without one the
    seeds estimate them; ``sort`` drops the plan and its transient is the
    gathered message labels with ``segment_mode``'s sort (two int64 keys
    and the permutation); ``blocked`` adds the stream pair and a tile of
    at least M slots (every bin is padded to the largest) to the bucketed
    seeds.

    ``num_devices`` > 1 gives the pre-build estimate of one shard of a
    sharded operating point: ``sharded_2d`` (which needs >= 2 devices)
    as the single-device seeds over D, the stream pair and a tile of at
    most one bin, the sharded labels and the per-peer tables at their
    worst case (a boundary of the whole peer chunk: the real one is known
    only once the partition is built, and an estimate too high
    pre-degrades where one too low runs out of memory); the
    one-all-gather families as the replicated schedule's seeds (the
    blocked one with its stream pair and tile), so a walk off
    ``sharded_2d`` compares shard with shard."""
    d = max(int(num_devices), 1)
    if family == "sharded_2d" and d < 2:
        raise ValueError(
            "family 'sharded_2d' needs num_devices >= 2 (its per-peer "
            "exchange tables have no single-device meaning)"
        )
    if d > 1:
        if plan is not None:
            raise ValueError("a sharded footprint with a built partition is "
                             "sharded_superstep_footprint's")
        return _sharded_seed_footprint(op, family, int(num_vertices), int(num_messages),
                                       num_edges, bool(weighted), d)
    if plan is not None:
        family = _plan_family(plan)
        if weighted is None:
            weighted = _plan_weighted(plan)
    weighted = bool(weighted)
    if family not in FAMILY_DEGRADE:
        raise ValueError(f"unknown superstep family {family!r}")
    v = int(num_vertices)
    m = max(int(num_messages), 1)
    e = int(num_edges) if num_edges is not None else m // 2
    inv = {
        "edge_endpoints": 2 * _I32 * e,
        "message_csr": _I32 * (2 * m + v + 1),
        "labels": 3 * _I32 * v,
    }
    if weighted:
        inv["msg_weights"] = _I32 * m
    if family == "sort":
        # gathered labels, the (receiver, label) keys and their sort
        inv["gather_transient"] = _I32 * m * (2 if weighted else 1) + 3 * 8 * m
        return MemEstimate(op=op, family=family, devices=1, weighted=weighted,
                           inventory=inv, exact=True)
    if plan is None:
        seeds = schedule_inventory("single", v, e, 1, weighted)
        for key in ("plan_mats", "plan_vertex_ids", "gather_transient", "weight_mats"):
            if key in seeds:
                inv[key] = seeds[key]
        if family == "blocked":
            inv["stream"] = 2 * _I32 * m
            inv["tile"] = int(_I32 * m * _PAD)
        return MemEstimate(op=op, family=family, devices=1, weighted=weighted,
                           inventory=inv, exact=False)
    if family == "blocked":
        rows = int(plan.padded_row_slots)
        inv["labels"] = 2 * _I32 * v  # in and out: the tile reads the labels as they are
        inv["stream"] = 2 * _I32 * int(plan.num_messages)
        inv["tile"] = _I32 * int(plan.tile_alloc)
        inv["reduce_rows"] = _I32 * rows
        inv["row_vertex"] = _I32 * sum(int(r.shape[0]) for r in plan.row_idx)
        if weighted:
            inv["weight_mats"] = _I32 * rows
        # the streamed values and the int64 copy of the scatter indices
        # the index kernel makes while the tile fills, then a class's rows
        inv["gather_transient"] = max(
            [(_I32 + 8) * int(plan.num_messages)]
            + [_bucket_transient(int(r.shape[0]), int(r.shape[1]), weighted)
               for r in plan.row_idx])
        return MemEstimate(op=op, family=family, devices=1, weighted=weighted,
                           inventory=inv, exact=True)
    padded = _bucketed_padded_slots(plan)
    ids = sum(int(x.shape[0]) for x in plan.vertex_ids)
    hub_msgs = 0 if plan.hist_send is None else int(plan.hist_send.shape[0])
    n_hub = 0 if plan.hist_vertex_ids is None else int(plan.hist_vertex_ids.shape[0])
    inv["plan_mats"] = _I32 * padded + _I32 * hub_msgs  # + the hubs' row offsets
    inv["plan_vertex_ids"] = _I32 * (ids + n_hub)
    if weighted:
        inv["weight_mats"] = _I32 * padded
    transient = max((_bucket_transient(int(s.shape[0]), int(s.shape[1]), weighted)
                     for s in (plan.send_idx if plan.send_idx is not None else plan.msg_idx)),
                    default=0)
    if n_hub:
        # the [n_hub, V] histogram, with the slot ids and ones (unweighted)
        # or the sorted int64 keys, their order and the run sums (weighted)
        per_msg = (8 + 8 + 2 * _I32) if weighted else 2 * _I32
        transient = max(transient, _I32 * n_hub * v + per_msg * hub_msgs)
    inv["gather_transient"] = transient
    return MemEstimate(op=op, family=family, devices=1, weighted=weighted,
                       inventory=inv, exact=True)


def _sharded_seed_footprint(op: str, family: str, v: int, m: int, num_edges, weighted: bool,
                            d: int) -> MemEstimate:
    """The pre-build per-shard estimate of :func:`superstep_footprint` on
    ``d`` devices."""
    if family not in FAMILY_DEGRADE:
        raise ValueError(f"unknown superstep family {family!r}")
    m = max(m, 1)
    e = int(num_edges) if num_edges is not None else m // 2
    vc, mc = -(-v // d), -(-m // d)
    if family == "sharded_2d":
        base = schedule_inventory("single", v, e, 1, weighted)
        inv = {k: b // d for k, b in base.items() if k != "labels"}
        inv["stream"] = 2 * _I32 * mc
        inv["tile"] = _I32 * min(mc, BLOCKED_TILE_SLOTS_EST)
        inv["labels_sharded"] = 2 * _I32 * vc
        inv["exchange_send_tab"] = _I32 * vc * (d - 1)
        inv["exchange_recv_bufs"] = _I32 * vc * (d - 1)
    else:
        inv = schedule_inventory("replicated", v, e, d, weighted)
        if family == "sort":
            del inv["plan_mats"]
        elif family == "blocked":
            inv["stream"] = 2 * _I32 * mc
            inv["tile"] = _I32 * min(mc, BLOCKED_TILE_SLOTS_EST)
    return MemEstimate(op=op, family=family, devices=d, weighted=weighted, inventory=inv,
                       exact=False)


# ---- one sharded superstep ----------------------------------------------------


def _per_chip_bytes(arr) -> int:
    """Bytes of one shard of a stacked ``[D, ...]`` partition array (host
    or placed)."""
    shape = (len(arr), *arr[0].shape) if isinstance(arr, tuple) else tuple(arr.shape)
    n = 1
    for x in shape[1:]:
        n *= int(x)
    return _I32 * n


def sharded_superstep_footprint(op: str, sg, weighted: bool | None = None,
                                schedule: str = "replicated") -> MemEstimate:
    """Per-shard footprint of one sharded superstep, read off a built
    partition's shapes: the shard's arrays (an ``lpa_only`` placement has
    no sort-body arrays), its superstep's largest transient (a bucketed or
    blocked class's gathered rows and mode scratch, or the sort body's
    gathered labels with the segment mode's keys), and the labels of
    ``schedule``: ``replicated`` holds the full vector in, its padded copy
    and the gathered vector out; ``ring`` its chunk, the new one, the
    chunk in hand and the one in transit. A 2-D partition keeps its labels
    sharded whatever ``schedule`` says (the chunk and the new one) and
    adds its per-peer send table and received buffers. A virtual mesh puts
    every shard on one device: that device holds ``devices`` times this."""
    d, vc, v = int(sg.num_shards), int(sg.chunk_size), int(sg.padded_vertices)
    blk_w = getattr(sg, "blk_row_weight", ())
    if weighted is None:
        weighted = sg.msg_weight is not None or bool(sg.bucket_weight) or bool(blk_w)
    weighted = bool(weighted)
    inv: dict = {}
    if sg.degrees is not None:
        inv["degrees"] = _per_chip_bytes(sg.degrees)
    msgs = sum(_per_chip_bytes(a) for a in (sg.msg_recv_local, sg.msg_send) if a is not None)
    if msgs:
        inv["shard_messages"] = msgs
    if sg.msg_weight is not None:
        inv["msg_weights"] = _per_chip_bytes(sg.msg_weight)
    x2d = getattr(sg, "x2d_src_local", None)
    if x2d is not None or getattr(sg, "blk_src", None) is not None:
        family = "sharded_2d" if x2d is not None else "blocked"
        stream = x2d if x2d is not None else sg.blk_src
        inv["stream"] = _per_chip_bytes(stream) + _per_chip_bytes(sg.blk_pos)
        inv["tile"] = _I32 * int(sg.blk_tile_alloc)
        rows = sum(_per_chip_bytes(r) for r in sg.blk_row_idx)
        inv["reduce_rows"] = rows
        inv["row_vertex"] = sum(_per_chip_bytes(t) for t in sg.blk_row_target)
        if blk_w:
            inv["weight_mats"] = sum(_per_chip_bytes(w) for w in blk_w)
        shapes = [((len(r), *r[0].shape) if isinstance(r, tuple) else r.shape)
                  for r in sg.blk_row_idx]
        inv["gather_transient"] = max(
            [(_I32 + 8) * (_per_chip_bytes(stream) // _I32)]
            + [_bucket_transient(int(sh[1]), int(sh[2]), weighted) for sh in shapes])
        if family == "sharded_2d":
            inv["exchange_send_tab"] = _per_chip_bytes(sg.x2d_send_tab)
            inv["exchange_recv_bufs"] = _per_chip_bytes(sg.x2d_send_tab)
            inv["labels_sharded"] = 2 * _I32 * vc
            return MemEstimate(op=op, family=family, devices=d, weighted=weighted,
                               inventory=inv, exact=True)
    elif sg.bucket_send:
        family = "bucketed"
        inv["plan_mats"] = sum(_per_chip_bytes(b) for b in sg.bucket_send)
        inv["plan_vertex_ids"] = sum(_per_chip_bytes(t) for t in sg.bucket_target)
        if sg.bucket_weight:
            inv["weight_mats"] = sum(_per_chip_bytes(w) for w in sg.bucket_weight)
        shapes = [((len(b), *b[0].shape) if isinstance(b, tuple) else b.shape)
                  for b in sg.bucket_send]
        inv["gather_transient"] = max(
            (_bucket_transient(int(sh[1]), int(sh[2]), weighted) for sh in shapes), default=0)
    else:
        family = "sort"
        mp = _per_chip_bytes(sg.msg_send) // _I32
        inv["gather_transient"] = _I32 * mp * (2 if weighted else 1) + 3 * 8 * mp
    if schedule == "ring":
        inv["labels_sharded"] = 2 * _I32 * vc
        inv["ring_chunks"] = 2 * _I32 * vc
        if family == "sort":
            inv["ring_gathered"] = _I32 * (_per_chip_bytes(sg.msg_send) // _I32)
    else:
        inv["labels_replicated"] = 2 * _I32 * v
        inv["exchange_buffer"] = _I32 * v
    return MemEstimate(op=op, family=family, devices=d, weighted=weighted, inventory=inv,
                       exact=True)


# ---- LOF ---------------------------------------------------------------------


def ivf_model_clusters(n: int) -> int:
    """Mirror of ``ops/ann.default_n_clusters`` (~sqrt(N), a multiple of
    8, at least 8)."""
    return max(8, int(round(sqrt(max(int(n), 1)) / 8)) * 8)


def _knn_topk_scratch(n: int, f: int, k: int) -> dict:
    """The device buffers ``knn_topk`` allocates beside its outputs."""
    if f <= KNN_FAST_F and k <= KNN_FAST_K:
        tiles = -(-n // KNN_TILE_POINTS)
        return {"knn_packed": _I32 * tiles * KNN_TILE_FLOATS}
    out = {"knn_packed": _I32 * n * (-(-f // 8) * 8) + _I32 * n}
    if k >= KNN_SCRATCH_MIN_K:
        kcap = -(-k // 32) * 32
        out["knn_scratch_keys"] = 8 * (-(-n // 16) * 16) * kcap
    return out


def lof_footprint(impl: str, n: int, k: int, features: int = 8,
                  devices: int = 1) -> MemEstimate:
    """Workspace of one LOF scoring pass over ``[n, features]`` on the
    card: ``exact`` (``knn_topk``) or ``ivf`` (``ops/ann.py`` under the
    balanced-cluster model: each query's ``n_probe`` clusters are one
    sublist each, every sublist's query list is padded by half a chunk).
    On ``devices`` > 1, ``exact`` is the ring-sharded kNN per shard (its
    own and the visiting chunk, the running and the merged top-k, a
    1,024-row distance tile with its int64 keys); ``ivf`` splits its search
    but gathers the chunk results onto the first device for the merge, so
    that device's footprint is the one-device one."""
    n, k, f, d = int(n), max(int(k), 1), int(features), max(int(devices), 1)
    if impl not in ("exact", "ivf"):
        raise ValueError(f"unknown LOF impl family {impl!r}")
    if d > 1 and impl == "exact":
        chunk = -(-n // d)
        inv = {
            "features": 2 * _I32 * chunk * f,
            "knn_outputs": 3 * 2 * _I32 * chunk * k,
            "distance_tile": (_I32 + 8) * 1024 * chunk,
            "lof_transient": (8 + 4 * _I32) * n * k,
        }
        return MemEstimate(op="lof_knn", family=impl, devices=d, weighted=False,
                           inventory=inv, exact=False)
    inv: dict = {
        "features": _I32 * n * f,
        "knn_outputs": 2 * _I32 * n * k,
        # lof_from_knn: int64 indices, distances, reach distances and two
        # temporaries, all [n, k]
        "lof_transient": (8 + 4 * _I32) * n * k,
    }
    if impl == "exact":
        inv.update(_knn_topk_scratch(n, f, k))
    else:
        c = ivf_model_clusters(n)
        p = min(IVF_N_PROBE, c)
        slots = n * p + c * IVF_CHUNK_B // 2
        inv["probe"] = 2 * _I32 * n * p
        # [R, B, k] float32 + int32 results, and the flat copies the
        # merge gathers from, alive together
        inv["chunk_results"] = 2 * 2 * _I32 * slots * k
        # one batched [G, B, Lmax] block: distances, cross terms and the
        # int64 selection keys
        inv["search_block"] = (_I32 + _I32 + 8) * IVF_SEARCH_ELEMS
    return MemEstimate(op="lof_knn", family=impl, devices=d, weighted=False,
                       inventory=inv, exact=False)


# ---- plan-time pre-degrade -------------------------------------------------


def predegrade_superstep(family: str, num_vertices: int, num_messages: int,
                         num_edges: int, weighted: bool, budget_bytes: int,
                         num_devices: int = 1):
    """Walk the family ladder at plan time until the modeled footprint
    fits ``budget_bytes``: ``(family, fit_estimate, steps)`` with
    ``steps`` the ``(from, to, oversized_estimate)`` trail. The sort floor
    is returned even when it does not fit. With ``num_devices`` > 1 every
    rung is one shard's estimate on that mesh (a ``sharded_2d`` start
    walks back to the one-all-gather ``blocked`` family)."""
    steps = []
    while True:
        est = superstep_footprint("lpa_superstep", family, num_vertices, num_messages,
                                  num_edges=num_edges, weighted=weighted,
                                  num_devices=num_devices)
        nxt = FAMILY_DEGRADE.get(family)
        if est.total_bytes <= int(budget_bytes) or nxt is None:
            return family, est, steps
        steps.append((family, nxt, est))
        family = nxt


# ---- measured watermarks ---------------------------------------------------


def rss_sample() -> dict | None:
    """Host RSS as a measurement (``source: "rss"``), for runs off CUDA."""
    from graphmine_tpu_torch.obs.heartbeat import rss_mb

    rss = rss_mb()
    if rss is None:
        return None
    b = int(rss * (1 << 20))
    return {"bytes_in_use": b, "peak_bytes_in_use": b, "source": "rss"}


def device_sample(device) -> dict | None:
    """The caching allocator's ``memory_allocated`` and its peak on CUDA
    ``device`` with the card's total memory (cached for the heartbeat,
    which never queries the device itself); host RSS on any other device.
    A host-side query: no device sync."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return rss_sample()
    sample = {
        "device": dev.index if dev.index is not None else torch.cuda.current_device(),
        "bytes_in_use": int(torch.cuda.memory_allocated(dev)),
        "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(dev)),
        "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory),
    }
    from graphmine_tpu_torch.obs.heartbeat import note_device_memory

    note_device_memory([sample])
    return {**{k: sample[k] for k in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit")},
            "source": "device"}


def emit_memory_watermark(sink, op: str, est: MemEstimate | None, measured: dict | None,
                          budget_bytes: int | None = None, **kv) -> dict | None:
    """Emit one ``memory_watermark`` record: the predicted footprint beside
    the measured bytes in use, with ``headroom_frac`` of the budget left at
    the process's peak (device measurements only). No-op without a sink,
    an estimate or a measurement."""
    if sink is None or est is None or not measured:
        return None
    achieved = measured.get("bytes_in_use")
    if achieved is None:
        achieved = measured.get("peak_bytes_in_use")
    if achieved is None:
        return None
    achieved = int(achieved)
    headroom = None
    if budget_bytes and measured.get("source", "device") == "device":
        worst = int(measured.get("peak_bytes_in_use") or achieved)
        headroom = round((int(budget_bytes) - worst) / int(budget_bytes), 4)
    rec = dict(op=op, predicted_bytes=est.total_bytes, achieved_bytes=achieved,
               headroom_frac=headroom, source=measured.get("source", "device"),
               mem=est.record(), **kv)
    if budget_bytes:
        rec["budget_bytes"] = int(budget_bytes)
    for opt in ("bytes_in_use", "peak_bytes_in_use", "bytes_limit"):
        if measured.get(opt) is not None:
            rec[opt] = int(measured[opt])
    return sink.emit("memory_watermark", **rec)


# ---- serve-process accounting ---------------------------------------------


def serve_mem_budget_bytes() -> int | None:
    """The serve process's memory budget: ``GRAPHMINE_SERVE_MEM_BUDGET_BYTES``
    (a malformed value raises), else the host's ``MemTotal``, else None."""
    raw = os.environ.get("GRAPHMINE_SERVE_MEM_BUDGET_BYTES")
    if raw:
        try:
            return int(float(raw))
        except ValueError as e:
            raise ValueError(
                f"GRAPHMINE_SERVE_MEM_BUDGET_BYTES={raw!r} is not a number"
            ) from e
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return None


# The graphmine_memory_* gauges, under the JAX package's names.
MEMORY_GAUGE_HELP = {
    "graphmine_memory_rss_bytes": "resident set size of this serve process",
    "graphmine_memory_snapshot_bytes": "array bytes of the snapshot currently serving queries",
    "graphmine_memory_index_bytes": "derived query-index bytes (adjacency, census, explain)",
    "graphmine_memory_wal_segment_bytes": "bytes held by retained write-ahead-log segments",
    "graphmine_memory_headroom_frac": "fraction of the process memory budget still free",
}

_GAUGE_OF_KEY = {
    "rss_bytes": "graphmine_memory_rss_bytes",
    "snapshot_bytes": "graphmine_memory_snapshot_bytes",
    "index_bytes": "graphmine_memory_index_bytes",
    "wal_segment_bytes": "graphmine_memory_wal_segment_bytes",
    "headroom_frac": "graphmine_memory_headroom_frac",
}


def export_memory_gauges(registry, payload: dict) -> None:
    """Mirror a memory payload's present keys into the
    ``graphmine_memory_*`` gauges (absent or None keys are left alone)."""
    for key, name in _GAUGE_OF_KEY.items():
        val = payload.get(key)
        if val is not None:
            registry.gauge(name, MEMORY_GAUGE_HELP[name]).set(val)


def host_memory(budget_bytes: int | None = None) -> dict:
    """RSS and headroom of one serve process against ``budget_bytes``."""
    from graphmine_tpu_torch.obs.heartbeat import rss_mb

    rss = rss_mb()
    rss_bytes = int(rss * (1 << 20)) if rss is not None else None
    headroom = None
    if budget_bytes and rss_bytes is not None:
        headroom = round((budget_bytes - rss_bytes) / budget_bytes, 4)
    return {"rss_bytes": rss_bytes, "budget_bytes": budget_bytes, "headroom_frac": headroom}
