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

# The plan-time pre-degrade ladder: bucketed -> sort; sort is the floor.
FAMILY_DEGRADE = {"bucketed": "sort", "sort": None}


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
    """Modeled peak bytes of the LPA operating point for ``schedule``; the
    port runs ``"single"`` only."""
    if schedule != "single":
        raise ValueError(f"schedule {schedule!r} is multi-device; the port runs 'single'")
    edge = BYTES_PER_EDGE + (BYTES_PER_EDGE_WEIGHTED if weighted else 0.0)
    return int(edge * num_edges + SINGLE_BYTES_PER_VERTEX * num_vertices)


def schedule_inventory(schedule: str, num_vertices: int, num_edges: int,
                       num_devices: int = 1, weighted: bool = False) -> dict:
    """The seeds decomposed into named components; their sum is
    :func:`schedule_bytes_per_device` up to per-term rounding."""
    if schedule != "single":
        raise ValueError(f"schedule {schedule!r} is multi-device; the port runs 'single'")
    v, e = float(num_vertices), float(num_edges)
    mats = _I32 * 2 * _PAD * e
    inv = {
        "edge_endpoints": 8.0 * e,
        "message_csr": 16.0 * e + 4.0 * v,
        "plan_mats": mats,
        "plan_vertex_ids": 4.0 * v,
        "gather_transient": mats,
        "labels": 12.0 * v,
    }
    if weighted:
        inv["msg_weights"] = 8.0 * e
        inv["weight_mats"] = mats
    return {k: int(b) for k, b in inv.items()}


def schedule_footprint(schedule: str, num_vertices: int, num_edges: int,
                       num_devices: int = 1, weighted: bool = False,
                       op: str = "run_plan") -> MemEstimate:
    """The whole-run model as a :class:`MemEstimate` (the ``plan``
    record's ``mem``)."""
    return MemEstimate(op=op, family=schedule, devices=1, weighted=bool(weighted),
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
    (``"sort"`` or ``"bucketed"``; ``"auto"`` with a plan reads it off).

    With a plan the counts are exact: the graph's arrays, the plan's
    matrices and the largest per-bucket (or hub-histogram) transient.
    Without one the seeds estimate them; ``sort`` drops the plan and its
    transient is the gathered message labels with ``segment_mode``'s sort
    (two int64 keys and the permutation)."""
    if int(num_devices) != 1:
        raise ValueError("the port's superstep footprint is single-device")
    if plan is not None:
        family = _plan_family(plan)
        if weighted is None:
            weighted = _plan_weighted(plan)
    weighted = bool(weighted)
    if family not in FAMILY_DEGRADE:
        raise ValueError(
            f"superstep family {family!r} has no memory model in the port "
            "(sort and bucketed only; blocked waits for ROADMAP item A5)"
        )
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
        return MemEstimate(op=op, family=family, devices=1, weighted=weighted,
                           inventory=inv, exact=False)
    padded = _bucketed_padded_slots(plan)
    ids = sum(int(x.shape[0]) for x in plan.vertex_ids)
    hub_msgs = 0 if plan.hist_send is None else int(plan.hist_send.shape[0])
    n_hub = 0 if plan.hist_vertex_ids is None else int(plan.hist_vertex_ids.shape[0])
    inv["plan_mats"] = _I32 * padded + _I32 * hub_msgs  # + the hubs' row offsets
    inv["plan_vertex_ids"] = _I32 * (ids + n_hub)
    if weighted:
        inv["weight_mats"] = _I32 * padded
    transient = max((_bucket_transient(int(s.shape[0]), int(s.shape[1]), weighted)
                     for s in plan.send_idx), default=0)
    if n_hub:
        # the [n_hub, V] histogram, with the slot ids and ones (unweighted)
        # or the sorted int64 keys, their order and the run sums (weighted)
        per_msg = (8 + 8 + 2 * _I32) if weighted else 2 * _I32
        transient = max(transient, _I32 * n_hub * v + per_msg * hub_msgs)
    inv["gather_transient"] = transient
    return MemEstimate(op=op, family=family, devices=1, weighted=weighted,
                       inventory=inv, exact=True)


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
    sublist each, every sublist's query list is padded by half a chunk)."""
    n, k, f = int(n), max(int(k), 1), int(features)
    if impl not in ("exact", "ivf"):
        raise ValueError(f"unknown LOF impl family {impl!r}")
    if int(devices) != 1:
        raise ValueError("the port's LOF footprint is single-device")
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
    return MemEstimate(op="lof_knn", family=impl, devices=1, weighted=False,
                       inventory=inv, exact=False)


# ---- plan-time pre-degrade -------------------------------------------------


def predegrade_superstep(family: str, num_vertices: int, num_messages: int,
                         num_edges: int, weighted: bool, budget_bytes: int,
                         num_devices: int = 1):
    """Walk the family ladder at plan time until the modeled footprint
    fits ``budget_bytes``: ``(family, fit_estimate, steps)`` with
    ``steps`` the ``(from, to, oversized_estimate)`` trail. The sort floor
    is returned even when it does not fit."""
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
