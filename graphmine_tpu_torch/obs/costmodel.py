"""Analytical compute-plane cost model: what a superstep should cost.

Counterpart of the single-device part of ``graphmine_tpu/obs/costmodel.py``:

1. **Per-plan cost** (:func:`superstep_cost`, :func:`lof_cost`): message
   slots, padded gather slots, bytes gathered and scattered and padding
   overhead, read off the built plan or graph; no device work.
2. **Roofline anchors** (:func:`rooflines`): achieved rates of the H100,
   each with its provenance, overridable by a JSON file
   (``GRAPHMINE_ROOFLINE_FILE``) or one env var per anchor
   (``GRAPHMINE_ROOFLINE_<NAME>``). No anchor of the JAX package is
   carried over: its seeds were measured on a TPU. Each anchor here comes
   from a card run recorded in ``PERF.md`` (one H100 80GB HBM3 at 700 W).
   The multi-device exchange rate (:data:`EXCHANGE_SEED`) is a seed that
   was not measured: one card has no interconnect to time, and a virtual
   mesh's exchange is a copy inside the card.
3. **Predicted time** and the ``cost`` sub-record
   (:meth:`CostEstimate.record`, the shape ``obs.schema.COST_KEYS``
   checks) that rides ``plan_build`` / ``impl_selected`` /
   ``superstep_timing`` records; :func:`emit_superstep_timing` judges a
   window of supersteps against it.

Stdlib only apart from the CUDA synchronise in :func:`timed_fixpoint`.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

_I32 = 4  # bytes per int32/float32 slot

# ---- roofline anchors of the H100 (single owner) ---------------------------
#
# Work units per second per card. Each number is derived from a card run
# that PERF.md records (python3 chip_smoke.py on one H100 80GB HBM3 at
# 700 W); the slowest run of each is taken, so the model is conservative.
ROOFLINE_SEEDS: dict = {
    # Gathered label slots/s of the bucketed LPA superstep: 5 supersteps
    # over the main path's 50,015,720 messages in 0.0911 s (the slower of
    # two runs) is 2.745e9 message slots/s.
    "gather_slots_per_sec": 2.745e9,
    # Exact-kNN distance pairs/s of knn_topk's fast instance: 262,144^2
    # pairs in 70.45 ms.
    "lof_exact_pairs_per_sec": 9.754e11,
    # IVF kNN points/s end to end (index, search, merge): 262,144 points
    # in 2.93 s, the slowest of five runs (2.05-2.93 s).
    "lof_ivf_points_per_sec": 8.947e4,
    # The blocked family's bin pass (sender-major read + tile scatter),
    # slots/s: 69,625,446 slots in 6.207 ms at the com-LiveJournal scale
    # (smoke phase 10c, scale 22).
    "binned_slots_per_sec": 1.1218e10,
}

_SEED_PROVENANCE = {
    "gather_slots_per_sec": (
        "PERF.md s5: 5 bucketed LPA supersteps x 50,015,720 messages in "
        "0.0911 s (H100 80GB HBM3, 700 W)"
    ),
    "lof_exact_pairs_per_sec": (
        "PERF.md s6: knn_topk fast instance, 262,144^2 pairs in 70.45 ms "
        "(H100 80GB HBM3, 700 W)"
    ),
    "lof_ivf_points_per_sec": (
        "PERF.md s5: IVF outliers_lof, 262,144 points in 2.93 s "
        "(H100 80GB HBM3, 700 W)"
    ),
    "binned_slots_per_sec": (
        "PERF.md s6: smoke phase 10c, the bin pass at R-MAT scale 22, 69,625,446 "
        "slots in 6.207 ms (H100 80GB HBM3, 700 W)"
    ),
}

# The label exchange of a sharded superstep, bytes/s per card: NVLink 4's
# 450 GB/s a direction, from its specification. Not measured (see the
# module note); GRAPHMINE_ROOFLINE_EXCHANGE_BYTES_PER_SEC overrides it.
EXCHANGE_SEED = 4.5e11
_EXCHANGE_PROVENANCE = (
    "seed, not measured: NVLink 4's 450 GB/s a direction from its specification "
    "(one H100 has no interconnect to time; a virtual mesh's exchange is a copy "
    "inside the card)"
)


def exchange_anchor() -> dict:
    """The exchange rate ``{"v": bytes/s, "src": provenance}``: the env
    override, else the unmeasured seed."""
    env = os.environ.get("GRAPHMINE_ROOFLINE_EXCHANGE_BYTES_PER_SEC")
    if env:
        return {"v": float(env), "src": "env"}
    return {"v": EXCHANGE_SEED, "src": _EXCHANGE_PROVENANCE}


# Width-ladder padding (<= 10% a row) for estimates made before a plan
# exists to count exactly.
_EST_PAD = 1.10


def rooflines(overrides: dict | None = None) -> dict:
    """The active anchors: ``{name: {"v": rate, "src": provenance}}``.

    Precedence per anchor: ``overrides`` → ``GRAPHMINE_ROOFLINE_<NAME>``
    → ``GRAPHMINE_ROOFLINE_FILE`` (a JSON object of name → rate) → the
    committed seed. Unknown names are ignored; a malformed file or value
    raises."""
    out = {k: {"v": float(v), "src": _SEED_PROVENANCE[k]} for k, v in ROOFLINE_SEEDS.items()}
    path = os.environ.get("GRAPHMINE_ROOFLINE_FILE")
    if path:
        with open(path) as f:
            loaded = json.load(f)
        if not isinstance(loaded, dict):
            raise ValueError(
                f"GRAPHMINE_ROOFLINE_FILE {path} must hold a JSON object "
                f"of anchor -> rate, got {type(loaded).__name__}"
            )
        for k, v in loaded.items():
            if k in out:
                out[k] = {"v": float(v), "src": f"file:{path}"}
    for k in out:
        env = os.environ.get(f"GRAPHMINE_ROOFLINE_{k.upper()}")
        if env:
            out[k] = {"v": float(env), "src": "env"}
    if overrides:
        for k, v in overrides.items():
            if k in out:
                out[k] = {"v": float(v), "src": "caller"}
    return out


@dataclass(frozen=True)
class CostEstimate:
    """Predicted cost of one superstep (or one scoring pass) at one
    operating point, per card; ``predicted_per_chip`` is the model's rate
    in ``unit``."""

    op: str
    family: str
    devices: int
    slots: int               # real message slots (no padding)
    padded_slots: int        # gathered slots incl. padding
    bytes_gathered: int
    bytes_scattered: int
    padding_overhead: float  # padded_slots / slots
    exchange_bytes: int      # 0 on one device
    compute_seconds: float
    exchange_seconds: float
    predicted_seconds: float
    predicted_per_chip: float
    unit: str
    roofline: dict           # the anchors consulted (+ provenance)

    def record(self) -> dict:
        """The ``cost`` sub-record (built here and nowhere else)."""
        return {
            "family": self.family,
            "devices": self.devices,
            "slots": self.slots,
            "padded_slots": self.padded_slots,
            "bytes_gathered": self.bytes_gathered,
            "bytes_scattered": self.bytes_scattered,
            "padding_overhead": round(self.padding_overhead, 4),
            "exchange_bytes": self.exchange_bytes,
            "compute_seconds": _sig(self.compute_seconds),
            "exchange_seconds": _sig(self.exchange_seconds),
            "predicted_seconds": _sig(self.predicted_seconds),
            "predicted_per_chip": round(self.predicted_per_chip, 1),
            "unit": self.unit,
            "roofline": {k: a["v"] for k, a in self.roofline.items()} | {
                "provenance": "; ".join(
                    f"{k}: {a['src']}" for k, a in sorted(self.roofline.items()))},
        }


def _sig(x: float, digits: int = 4) -> float:
    """Round to significant digits."""
    if x == 0:
        return 0.0
    from math import floor, log10

    return round(x, digits - 1 - floor(log10(abs(x))))


# ---- plan inspection (duck-typed) ------------------------------------------


def _plan_family(plan) -> str:
    if plan is None:
        return "sort"
    if hasattr(plan, "padded_row_slots"):  # ops.blocking.BlockedPlan
        return "blocked"
    if hasattr(plan, "vertex_ids"):  # ops.bucketed_mode.BucketedModePlan
        return "bucketed"
    raise TypeError(f"unknown plan type {type(plan).__name__}")


def _bucketed_padded_slots(plan) -> int:
    mats = plan.send_idx if plan.send_idx is not None else plan.msg_idx
    slots = sum(int(m.shape[0]) * int(m.shape[1]) for m in mats)
    if plan.hist_send is not None:
        slots += int(plan.hist_send.shape[0])
    return slots


def _plan_weighted(plan) -> bool:
    return getattr(plan, "weight_mat", None) not in (None, ())


# ---- superstep families ----------------------------------------------------


def superstep_cost(op: str, family: str, num_vertices: int, num_messages: int,
                   num_edges: int, plan=None, weighted: bool | None = None,
                   anchors: dict | None = None) -> CostEstimate:
    """Cost of one single-device superstep of ``family`` (``"sort"``,
    ``"bucketed"`` or ``"blocked"``; ``"auto"`` with a plan reads the
    family off it).

    With a built plan the padded slots are exact; without one the width
    ladder's ~10% padding estimates them. ``weighted`` doubles the
    gathered bytes of the rows (``None`` infers it from the plan; CC
    passes False). Per family: ``sort`` gathers M label slots,
    ``bucketed`` the plan's padded slots, both at the gather rate;
    ``blocked`` streams M slots into the tile at the binned rate, then
    gathers its padded row slots at the gather rate. Each scatters V.
    """
    a = anchors if anchors is not None else rooflines()
    if plan is not None:
        family = _plan_family(plan)
        if weighted is None:
            weighted = _plan_weighted(plan)
    weighted = bool(weighted)
    m = max(int(num_messages), 1)
    v = int(num_vertices)
    gather = a["gather_slots_per_sec"]["v"]
    wf = 2 if weighted else 1
    if family in ("sort", "bucketed"):
        if family == "sort":
            padded = m
        else:
            padded = _bucketed_padded_slots(plan) if plan is not None else int(m * _EST_PAD)
        bytes_g, bytes_s = _I32 * padded * wf, _I32 * v
        compute = (padded * wf) / gather
    elif family == "blocked":
        rows = int(plan.padded_row_slots) if plan is not None else int(m * _EST_PAD)
        padded = m + rows
        bytes_g, bytes_s = _I32 * (m + rows * wf), _I32 * (m + v)
        compute = m / a["binned_slots_per_sec"]["v"] + (rows * wf) / gather
    else:
        raise ValueError(f"unknown superstep family {family!r}")
    return CostEstimate(
        op=op, family=family, devices=1, slots=m, padded_slots=padded,
        bytes_gathered=bytes_g, bytes_scattered=bytes_s,
        padding_overhead=padded / m, exchange_bytes=0,
        compute_seconds=compute, exchange_seconds=0.0, predicted_seconds=compute,
        predicted_per_chip=num_edges / compute if compute > 0 else 0.0,
        unit="edges/s/chip",
        roofline={k: a[k] for k in ("gather_slots_per_sec", "binned_slots_per_sec")},
    )


# ---- sharded supersteps ------------------------------------------------------


def _stack_shape(a) -> tuple:
    """``(D, ...)`` of a partition array, host-stacked or placed."""
    if isinstance(a, tuple):
        return (len(a), *a[0].shape)
    return tuple(a.shape)


def _sharded_family(sg) -> str:
    """The family a built ``ShardedGraph`` runs: ``sharded_2d`` with the
    per-peer tables, ``blocked`` with bin groups, ``bucketed`` with a
    bucket plan, else ``sort``. One owner for the cost, footprint and
    ``shard_exchange`` consumers."""
    if getattr(sg, "x2d_src_local", None) is not None:
        return "sharded_2d"
    if getattr(sg, "blk_src", None) is not None:
        return "blocked"
    return "bucketed" if sg.bucket_send else "sort"


def allgather_exchange_bytes(sg) -> int:
    """Modeled exchange bytes per shard a superstep of the one-all-gather
    families: every shard receives the other ``D - 1`` chunks of the
    padded label vector (``4*Vc*(D-1)``), whether as one all-gather
    (replicated) or D - 1 ring hops. The 2-D family's comparison ladder."""
    return _I32 * int(sg.chunk_size) * max(int(sg.num_shards) - 1, 0)


def neighbor_exchange_bytes(sg) -> int:
    """The 2-D family's wire bytes per shard a superstep: D - 1 shifts,
    each one buffer of the shared padded width B (``4*(D-1)*B``), exact
    from the partition; 0 without a 2-D partition."""
    d = max(int(sg.num_shards), 1)
    return _I32 * (d - 1) * int(getattr(sg, "x2d_boundary", 0))


def neighbor_frontier_bytes(sg) -> int:
    """The 2-D family's unpadded boundary bytes per shard, the fleet's
    total boundary slots over D (rounded up); 0 without a 2-D
    partition."""
    d = max(int(sg.num_shards), 1)
    return _I32 * -(-int(getattr(sg, "x2d_boundary_total", 0)) // d)


def sharded_superstep_cost(op: str, sg, num_edges: int, num_messages: int | None = None,
                           weighted: bool | None = None,
                           anchors: dict | None = None) -> CostEstimate:
    """Cost of one sharded superstep of a built partition (shapes only):
    per shard, the bin groups' streamed slots at the binned rate and their
    row slots at the gather rate (blocked and 2-D), the bucketed plan's
    padded slots, or the sort body's padded messages at the gather rate;
    plus the exchange at the unmeasured exchange seed: the 2-D family's
    per-peer buffers (:func:`neighbor_exchange_bytes`), else the label
    all-gather (:func:`allgather_exchange_bytes`)."""
    a = anchors if anchors is not None else rooflines()
    exch = exchange_anchor()
    d = int(sg.num_shards)
    gather = a["gather_slots_per_sec"]["v"]
    if weighted is None:  # explicit False models weight-blind ops (CC)
        weighted = (sg.msg_weight is not None or bool(sg.bucket_weight)
                    or bool(getattr(sg, "blk_row_weight", ())))
    wf = 2 if weighted else 1
    family = _sharded_family(sg)
    if family in ("sharded_2d", "blocked"):
        stream = sg.x2d_src_local if family == "sharded_2d" else sg.blk_src
        mp = _stack_shape(stream)[1]
        rows = sum(_stack_shape(r)[1] * _stack_shape(r)[2] for r in sg.blk_row_idx)
        padded = mp + rows
        bytes_g = _I32 * (mp + rows * wf)
        bytes_s = _I32 * mp + _I32 * int(sg.chunk_size)
        compute = mp / a["binned_slots_per_sec"]["v"] + (rows * wf) / gather
    else:
        if family == "bucketed":
            mp = None
            padded = sum(_stack_shape(b)[1] * _stack_shape(b)[2] for b in sg.bucket_send)
        else:
            mp = _stack_shape(sg.msg_send)[1]
            padded = mp
        bytes_g, bytes_s = _I32 * padded * wf, _I32 * int(sg.chunk_size)
        compute = (padded * wf) / gather
    m_total = int(num_messages) if num_messages is not None else \
        (mp if mp is not None else padded) * d
    m_chip = max(m_total // max(d, 1), 1)
    exchange_bytes = (neighbor_exchange_bytes(sg) if family == "sharded_2d"
                      else allgather_exchange_bytes(sg))
    exchange = exchange_bytes / exch["v"]
    predicted = compute + exchange
    return CostEstimate(
        op=op, family=family, devices=d, slots=m_chip, padded_slots=padded,
        bytes_gathered=int(bytes_g), bytes_scattered=int(bytes_s),
        padding_overhead=padded / m_chip, exchange_bytes=int(exchange_bytes),
        compute_seconds=compute, exchange_seconds=exchange, predicted_seconds=predicted,
        predicted_per_chip=num_edges / (predicted * d) if predicted > 0 else 0.0,
        unit="edges/s/chip",
        roofline={"gather_slots_per_sec": a["gather_slots_per_sec"],
                  "binned_slots_per_sec": a["binned_slots_per_sec"],
                  "exchange_bytes_per_sec": exch},
    )


def emit_shard_exchange(sink, op: str, sg, family: str | None = None, **kv) -> dict | None:
    """Emit one ``shard_exchange`` record: the modeled per-shard exchange
    bytes of the family that ran (the 2-D family's padded per-peer
    buffers, ``exchange_bytes``, and their unpadded content,
    ``frontier_bytes``) beside the one-all-gather model (``4*Vc*(D-1)``,
    ``ladder_bytes``), with ``frontier_frac`` the content's share of the
    ladder (1.0 for the one-all-gather families). ``family`` names the
    family the caller planned (default the one the partition runs; the
    one-all-gather families exchange the same bytes). ``kv`` may add
    ``virtual=True``. No-op without a sink."""
    if sink is None:
        return None
    family = family or _sharded_family(sg)
    d = int(sg.num_shards)
    ladder = allgather_exchange_bytes(sg)
    if family == "sharded_2d":
        modeled, frontier = neighbor_exchange_bytes(sg), neighbor_frontier_bytes(sg)
    else:
        modeled = frontier = ladder
    return sink.emit(
        "shard_exchange", op=op, family=family, devices=d, peers=max(d - 1, 0),
        exchange_bytes=int(modeled), frontier_bytes=int(frontier), ladder_bytes=int(ladder),
        frontier_frac=round(frontier / ladder if ladder else 1.0, 4),
        boundary_slots=int(getattr(sg, "x2d_boundary_total", 0)),
        padded_boundary=int(getattr(sg, "x2d_boundary", 0)), **kv,
    )


# ---- LOF impls -------------------------------------------------------------


def lof_cost(impl: str, n: int, k: int, features: int = 8, devices: int = 1,
             anchors: dict | None = None) -> CostEstimate:
    """Cost of one LOF scoring pass over an ``[n, features]`` cloud:
    ``exact`` as n² pairs at the kernel's pair rate (a ring over D shards
    splits the rows, so 1/D each), ``ivf`` as n points at the index's
    end-to-end rate over D shards (its candidate count depends on the
    data)."""
    a = anchors if anchors is not None else rooflines()
    n = int(n)
    d = max(int(devices), 1)
    if impl not in ("exact", "ivf"):
        raise ValueError(f"unknown LOF impl family {impl!r}")
    if impl == "exact":
        pairs = n * n // d
        compute = pairs / a["lof_exact_pairs_per_sec"]["v"]
        slots = pairs
        key = "lof_exact_pairs_per_sec"
    else:
        compute = n / (a["lof_ivf_points_per_sec"]["v"] * d)
        slots = n * max(k, 1) // d
        key = "lof_ivf_points_per_sec"
    return CostEstimate(
        op="lof_knn", family=impl, devices=d, slots=slots, padded_slots=slots,
        bytes_gathered=_I32 * features * slots, bytes_scattered=_I32 * n,
        padding_overhead=1.0, exchange_bytes=0,
        compute_seconds=compute, exchange_seconds=0.0, predicted_seconds=compute,
        predicted_per_chip=n / (compute * d) if compute > 0 else 0.0,
        unit="points/s/chip", roofline={key: a[key]},
    )


# ---- achieved-vs-model emission -------------------------------------------


def emit_superstep_timing(sink, op: str, cost: CostEstimate | None, iteration: int,
                          window: int, seconds: float, num_edges: int,
                          variant: str | None = None,
                          cold_compile: bool = False, **kv) -> dict | None:
    """Emit one ``superstep_timing`` record: the achieved rate of a window
    of ``window`` supersteps ending at ``iteration`` against ``cost``'s
    model (no-op without a sink or a cost). ``achieved_fraction`` is the
    predicted over the achieved time per superstep. The timing comes from
    the caller's existing synchronise: no extra device sync. ``kv`` adds
    keys (a virtual mesh's ``virtual=True``)."""
    if sink is None or cost is None:
        return None
    window = max(int(window), 1)
    seconds = float(seconds)
    per_step = seconds / window
    achieved = num_edges * window / seconds / max(cost.devices, 1) if seconds > 0 else 0.0
    fraction = cost.predicted_seconds / per_step if per_step > 0 else 0.0
    return sink.emit(
        "superstep_timing", op=op, family=cost.family,
        variant=variant if variant is not None else cost.family,
        iteration=int(iteration), window=window, seconds=round(seconds, 6),
        edges_per_sec_per_chip=round(achieved),
        predicted_edges_per_sec_per_chip=round(cost.predicted_per_chip),
        achieved_fraction=_sig(fraction), devices=cost.devices,
        cold_compile=bool(cold_compile), cost=cost.record(), **kv,
    )


class WindowTimer:
    """Accumulates the driver's already-measured superstep durations,
    flushed at the telemetry cadence, reset on operating-point changes."""

    def __init__(self):
        self.seconds = 0.0
        self.steps = 0

    def add(self, seconds: float) -> None:
        self.seconds += float(seconds)
        self.steps += 1

    def reset(self) -> None:
        self.seconds = 0.0
        self.steps = 0

    def flush(self, sink, op, cost, iteration, num_edges, variant=None, **kv) -> dict | None:
        """Emit the window accumulated so far (if any) and reset."""
        if not self.steps:
            return None
        rec = emit_superstep_timing(sink, op, cost, iteration, self.steps, self.seconds,
                                    num_edges, variant=variant, **kv)
        self.reset()
        return rec


def timed_fixpoint(fn):
    """``(result, seconds, cold_compile)`` with the result's device work
    completed: ``fn`` returns a tensor or a tuple whose first element is
    one, and its device is synchronised before the clock stops. Nothing
    is compiled, so ``cold_compile`` is always False."""
    t0 = time.perf_counter()
    out = fn()
    head = out[0] if isinstance(out, tuple) else out
    if getattr(head, "is_cuda", False):
        import torch

        torch.cuda.synchronize(head.device)
    return out, time.perf_counter() - t0, False
