"""Record-schema registry: every emitted phase name is declared here.

Counterpart of ``graphmine_tpu/obs/schema.py``, with the same phase names,
required keys and cross-cutting rules for every record the port emits and
every record a one-device run of the JAX package emits, so each package's
metrics stream validates against the other's registry. An unknown phase
name fails validation loudly, and so does a registered phase missing a
required key.

Required keys are the always-present set; other keys are free-form. The
cross-cutting rules:

- every record needs ``phase`` (str) and ``t`` (epoch seconds);
- trace identity is all-or-nothing: a record carrying any of
  ``run_id`` / ``trace_id`` / ``span_id`` / ``span_path`` carries all four;
- a ``tenant`` key matches the tenant-id grammar;
- the ``cost``, ``mem`` and ``*_sketch`` sub-records carry every key of
  their shape.

:data:`PORT_PHASES` lists the records only the port emits (its separate
``features`` phase, ``feature_mode``, the IVF index's ``ivf_index`` and
the publish's ``cc_summary``); a consumer of the JAX package's registry
registers them from there. Extend with :func:`register`.
"""

from __future__ import annotations

import re

_TRACE_KEYS = ("run_id", "trace_id", "span_id", "span_path")

# phase name -> frozenset of required keys (beyond phase/t).
SCHEMAS: dict = {}


def register(phase: str, *required: str) -> None:
    """Declare a phase and its always-present keys (idempotent; a
    re-registration unions the key sets)."""
    SCHEMAS[phase] = frozenset(required) | SCHEMAS.get(phase, frozenset())


# ---- run lifecycle --------------------------------------------------------
register("run_start", "pid")
register("run_end", "ok")
register("span", "name", "seconds", "status")
register("heartbeat", "uptime_s")
register("profile_capture", "dir", "ok")

# ---- pipeline phases (timed records carry `seconds`) ----------------------
register("load", "seconds")
register("counts", "rows_raw", "edges", "vertices")
register("quarantine")
register("plan", "schedule", "bytes_per_device", "hbm_budget", "reason")
register("warning", "message")
register("build_graph", "seconds")
register("lpa", "seconds")
register("lpa_iter", "iteration", "labels_changed", "seconds",
         "edges_per_sec", "edges_per_sec_per_chip")
register("superstep_telemetry", "iteration", "labels_changed", "frontier",
         "shard_changed", "imbalance", "devices", "variant")
register("census", "seconds")
register("communities", "count", "largest", "modularity")
register("outliers_recursive_lpa", "seconds")
register("outliers_lof", "seconds", "k", "devices", "features")
register("outlier_summary", "method")
register("ivf_fallback", "guard", "detail")
register("impl_selected", "op", "impl", "n", "reason")
register("plan_build", "op", "family", "seconds", "padded_slots_per_edge")
# achieved-vs-model throughput of a window of supersteps, with the cost
# model's prediction and its `cost` sub-record
register("superstep_timing", "op", "family", "variant", "iteration",
         "window", "seconds", "edges_per_sec_per_chip",
         "predicted_edges_per_sec_per_chip", "achieved_fraction",
         "devices", "cost")
# predicted-vs-measured memory of one operating point, with the `mem`
# sub-record; `source` says device allocator or host RSS
register("memory_watermark", "op", "predicted_bytes", "achieved_bytes",
         "headroom_frac", "source", "mem")

# ---- snapshot store and result quality ------------------------------------
register("snapshot_publish", "version", "snapshot_id", "path", "bytes",
         "arrays", "seconds")
register("snapshot_load", "version", "path", "seconds")
register("writer_promote", "epoch")
register("publish_fenced", "attempted_epoch", "store_epoch", "reason")
register("quality_snapshot", "version", "num_vertices", "num_communities",
         "anomaly_rate", "lof_threshold", "lof_sketch", "size_sketch",
         "seconds")
register("quality_drift", "version", "parent_version", "churn_frac",
         "new_communities", "dissolved_communities", "lof_psi",
         "size_psi", "anomaly_rate_delta")
register("canary_score", "version", "recall_at_k", "recall_k",
         "mean_rank_frac", "num_anomalies", "k")

# ---- serving: deltas, queries, the HTTP front end, admission, alerts -------
register("delta_apply", "inserts", "deletes", "method", "iterations",
         "quarantine", "version", "seconds")
register("query_batch", "endpoint", "n", "seconds")
register("repair_fallback", "stage", "reason")
register("access_log", "method", "endpoint", "status", "seconds", "request_id")
register("slo_rollup", "uptime_s", "endpoints", "repair_debt")
register("admission", "verdict", "reason", "queue_depth", "rows", "repair_debt")
register("delta_coalesce", "batches", "inserts", "deletes", "rows_in", "rows_out")
register("delta_shed", "stage", "reason", "rows", "retry_after_s")
register("delta_stages", "version", "stages")
register("alert", "name", "state", "severity", "metric", "value", "threshold")

# ---- the replicated serving plane: fleet, write-ahead log, shard plane ----
# replica_health / breaker_transition / fleet_route / fleet_degraded come
# from the fleet router (serve/fleet.py); delta_visible is one per (delta,
# replica) when a replica first serves the version that absorbed the delta.
register("replica_health", "replica", "from_state", "to_state", "reason")
register("breaker_transition", "replica", "from_state", "to_state", "reason")
register("fleet_route", "endpoint", "verdict", "attempts")
register("fleet_degraded", "reason", "read_only")
register("delta_visible", "replica", "version", "seconds")
# wal_append: one per fsync'd log append; wal_replay: one per startup or
# promotion replay; ship_lag: the standby's lag while behind (rate-limited)
register("wal_append", "seq", "rows", "bytes", "seconds")
register("wal_replay", "entries", "from_seq")
register("ship_lag", "lag_entries", "lag_s")
# shard_publish / epoch_commit / shard_degraded: built only by
# serve/shardplane.emit_shard_record
register("shard_publish", "epoch", "shard", "version", "arrays")
register("epoch_commit", "epoch", "version_vector", "shards")
register("shard_degraded", "shard", "status", "reason")

# ---- recovery / resilience records ----------------------------------------
register("retry", "stage", "attempt", "backoff_s", "error")
register("retries_exhausted", "stage", "attempts", "error")
register("degrade", "stage", "to", "depth", "error")
register("tripwire", "kind", "shard", "iteration")
register("watchdog_timeout", "stage", "timeout_s", "checkpointed")
register("resume", "iteration")
register("checkpoint_save", "iteration", "format", "path")
register("checkpoint_rollback", "path", "error")
register("checkpoint_rollback_ok", "path", "iteration")

# ---- records only the port emits -------------------------------------------
PORT_PHASES = {
    "features": ("seconds",),
    "feature_mode": ("mode", "wedges", "wedge_budget"),
    "ivf_index": ("n", "k", "n_clusters", "n_probe", "chunks"),
    "cc_summary": ("components", "largest", "iterations"),
}
for _phase, _keys in PORT_PHASES.items():
    register(_phase, *_keys)

# The tenant-id grammar of serve/tenancy.py.
_TENANT_VALUE_RE = re.compile(r"[a-z0-9_-]{1,64}")

# The sub-record shapes, each built by one function (CostEstimate.record,
# MemEstimate.record, QuantileSketch.to_state): a record carrying one
# carries every key, or report tooling would render holes.
COST_KEYS = frozenset((
    "family", "devices", "slots", "padded_slots", "bytes_gathered",
    "bytes_scattered", "padding_overhead", "exchange_bytes",
    "compute_seconds", "exchange_seconds", "predicted_seconds",
    "predicted_per_chip", "unit", "roofline",
))
MEM_KEYS = frozenset((
    "family", "devices", "weighted", "total_bytes", "inventory", "exact",
    "unit",
))
SKETCH_KEYS = frozenset(("bounds", "counts", "sum", "count"))


def _sub_record(phase: str, key: str, sub, keys: frozenset, owner: str) -> list:
    if not isinstance(sub, dict):
        return [f"{phase}: {key} sub-record is {type(sub).__name__}, not dict — "
                f"build it with {owner}"]
    missing = sorted(k for k in keys if k not in sub)
    if missing:
        return [f"{phase}: half-stamped {key} sub-record (missing {missing}) — "
                f"build it with {owner}"]
    return []


def validate_record(rec) -> list:
    """Problems with one record (empty list = valid)."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not dict"]
    phase = rec.get("phase")
    if not isinstance(phase, str) or not phase:
        return [f"missing/empty phase in {rec!r}"]
    problems = []
    if not isinstance(rec.get("t"), (int, float)):
        problems.append(f"{phase}: missing numeric t")
    required = SCHEMAS.get(phase)
    if required is None:
        problems.append(f"unknown phase {phase!r} — register it in "
                        "graphmine_tpu_torch/obs/schema.py with its required keys")
    else:
        missing = sorted(k for k in required if k not in rec)
        if missing:
            problems.append(f"{phase}: missing required keys {missing}")
    present = [k for k in _TRACE_KEYS if k in rec]
    if present and len(present) != len(_TRACE_KEYS):
        absent = sorted(set(_TRACE_KEYS) - set(present))
        problems.append(f"{phase}: partial trace identity (has {present}, lacks {absent})")
    if "tenant" in rec:
        tval = rec["tenant"]
        if not isinstance(tval, str) or not _TENANT_VALUE_RE.fullmatch(tval):
            problems.append(f"{phase}: tenant key {tval!r} does not match the tenant-id "
                            "grammar [a-z0-9_-]{1,64}")
    for key in rec:
        if key.endswith("_sketch"):
            problems += _sub_record(phase, key, rec[key], SKETCH_KEYS,
                                    "obs/sketch QuantileSketch.to_state()")
    if "mem" in rec:
        problems += _sub_record(phase, "mem", rec["mem"], MEM_KEYS,
                                "obs/memmodel MemEstimate.record()")
    if "cost" in rec:
        problems += _sub_record(phase, "cost", rec["cost"], COST_KEYS,
                                "obs/costmodel CostEstimate.record()")
    return problems


def validate_records(records) -> list:
    """Flat problem list over a record iterable, each prefixed with its
    position."""
    problems = []
    for i, rec in enumerate(records):
        problems.extend(f"record {i}: {p}" for p in validate_record(rec))
    return problems
