"""Write-path admission control: one policy owner for overload verdicts.

Counterpart of ``graphmine_tpu/serve/admission.py``, whole, with the same
bounds, verdicts, reasons and records. :class:`AdmissionController` reads
the live :class:`~graphmine_tpu_torch.serve.delta.RepairDebt` state against
:class:`AdmissionBounds` and resolves every incoming delta to one verdict:

``accept``
    the apply queue is idle: the delta applies immediately;
``queue``
    an apply is in flight but nothing else waits: the delta parks on the
    bounded apply queue;
``coalesce``
    deltas are already queued: this one is merged with them
    (:func:`coalesce_deltas`, an order-exact multiset union), so a burst
    of N batches pays one splice and one warm repair;
``shed``
    a bound saturated (queue depth, pending repair-debt rows or ingest
    lag): the delta is refused, and the HTTP layer answers 503 with
    ``Retry-After``.

Past ``defer_frac`` of the bounds, ``lof_mode`` flips to ``defer``: the
apply skips the LOF refresh and publishes with the outlier column marked
stale (``lof_stale``); labels are never deferred. Every resolution emits
one ``admission`` record. The bounds read ``GRAPHMINE_ADMIT_MAX_PENDING_ROWS``,
``GRAPHMINE_ADMIT_MAX_LAG_S``, ``GRAPHMINE_ADMIT_MAX_QUEUE_DEPTH``,
``GRAPHMINE_ADMIT_DEFER_FRAC``, ``GRAPHMINE_ADMIT_DEADLINE_S`` and
``GRAPHMINE_ADMIT_RETRY_AFTER_S``. Host-only.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import dataclass

import numpy as np

from graphmine_tpu_torch.serve.delta import EdgeDelta
from graphmine_tpu_torch.serve.tenancy import DEFAULT_TENANT

# Defaults sized for the CPU-fallback container this repo develops in; a
# real deployment tunes via env. pending-rows bounds the repair backlog
# (the staleness a balancer reads), queue depth bounds memory held by
# parked request bodies, lag bounds how old an acked-but-unpublished
# write may get before new writes are refused instead.
DEFAULT_MAX_PENDING_ROWS = 100_000
DEFAULT_MAX_INGEST_LAG_S = 60.0
DEFAULT_MAX_QUEUE_DEPTH = 16
DEFAULT_DEFER_FRAC = 0.5
DEFAULT_DEADLINE_S = 30.0
DEFAULT_RETRY_AFTER_S = 2.0

_ENV = {
    "max_pending_rows": ("GRAPHMINE_ADMIT_MAX_PENDING_ROWS", int),
    "max_ingest_lag_s": ("GRAPHMINE_ADMIT_MAX_LAG_S", float),
    "max_queue_depth": ("GRAPHMINE_ADMIT_MAX_QUEUE_DEPTH", int),
    "defer_frac": ("GRAPHMINE_ADMIT_DEFER_FRAC", float),
    "deadline_s": ("GRAPHMINE_ADMIT_DEADLINE_S", float),
    "retry_after_s": ("GRAPHMINE_ADMIT_RETRY_AFTER_S", float),
}

VERDICTS = ("accept", "queue", "coalesce", "shed")


@dataclass(frozen=True)
class AdmissionBounds:
    """The admission envelope. Immutable — policy changes are a new
    controller, not a mutated one (same contract as PipelineConfig)."""

    max_pending_rows: int = DEFAULT_MAX_PENDING_ROWS
    max_ingest_lag_s: float = DEFAULT_MAX_INGEST_LAG_S
    max_queue_depth: int = DEFAULT_MAX_QUEUE_DEPTH
    # fraction of max_pending_rows / max_ingest_lag_s past which the
    # LOF-defer rung arms (0 = always defer, >=1 = never)
    defer_frac: float = DEFAULT_DEFER_FRAC
    # default per-request deadline: a batch still QUEUED when its
    # deadline passes is shed (the client stopped waiting; applying its
    # rows anyway would spend repair budget on an answer nobody reads)
    deadline_s: float = DEFAULT_DEADLINE_S
    # Retry-After hint on sheds
    retry_after_s: float = DEFAULT_RETRY_AFTER_S

    def __post_init__(self):
        if self.max_pending_rows < 1 or self.max_queue_depth < 1:
            raise ValueError(
                "max_pending_rows and max_queue_depth must be >= 1"
            )
        if self.max_ingest_lag_s <= 0 or self.deadline_s <= 0:
            raise ValueError("max_ingest_lag_s and deadline_s must be > 0")
        if self.defer_frac < 0:
            raise ValueError("defer_frac must be >= 0")
        if self.retry_after_s < 0:
            raise ValueError("retry_after_s must be >= 0")

    @classmethod
    def from_env(cls, **overrides) -> "AdmissionBounds":
        """Bounds from ``GRAPHMINE_ADMIT_*`` env vars; explicit keyword
        overrides win over env, env over defaults. A malformed env value
        raises loudly (a typo'd bound silently falling back to the
        default is exactly how an operator 'raises' a bound to no
        effect)."""
        kv = {}
        for field, (var, parse) in _ENV.items():
            raw = os.environ.get(var)
            if raw is None or field in overrides:
                continue
            try:
                kv[field] = parse(raw)
            except ValueError as e:
                raise ValueError(
                    f"{var}={raw!r} is not a valid {parse.__name__}"
                ) from e
        kv.update(overrides)
        return cls(**kv)

    def snapshot(self) -> dict:
        return {
            "max_pending_rows": self.max_pending_rows,
            "max_ingest_lag_s": self.max_ingest_lag_s,
            "max_queue_depth": self.max_queue_depth,
            "defer_frac": self.defer_frac,
            "deadline_s": self.deadline_s,
            "retry_after_s": self.retry_after_s,
        }


@dataclass(frozen=True)
class AdmissionDecision:
    """One resolution: the verdict plus everything the caller needs to
    act on it without re-reading policy state."""

    verdict: str              # accept | queue | coalesce | shed
    reason: str               # the bound/branch that decided, with numbers
    lof_mode: str             # refresh | defer (the rung-2 degradation)
    retry_after_s: float      # the 503 hint (shed verdicts only)
    rows: int
    queue_depth: int


class AdmissionController:
    """THE policy owner for the serve write path (no scattered threshold
    checks — acceptance criterion). Host-only bookkeeping
    under one lock; nothing here touches a device.

    ``sink`` gets one ``admission`` record per :meth:`resolve` and one
    ``delta_shed`` record per :meth:`record_shed`; ``registry`` mirrors
    verdict totals into scrapeable counters and the live queue-depth /
    overloaded gauges.

    ``tenant``: a multi-tenant server runs ONE controller per
    tenant — each with its own bounds ladder (per-tenant overrides via
    the :class:`~graphmine_tpu_torch.serve.tenancy.TenantRegistry`) and its
    own verdict counters, so tenant A saturating its debt bound sheds
    only A. Records carry the tenant id (absent = default tenant); the
    shared registry gauges are exported by the DEFAULT tenant's
    controller only — per-tenant controllers writing one unlabelled
    gauge would race each other into a meaningless last-writer value,
    so per-tenant admission state lives on ``/statusz`` instead.
    """

    def __init__(
        self,
        bounds: AdmissionBounds | None = None,
        sink=None,
        registry=None,
        tenant: str = DEFAULT_TENANT,
    ):
        self.bounds = bounds if bounds is not None else AdmissionBounds.from_env()
        self.sink = sink
        self.registry = registry
        self.tenant = tenant or DEFAULT_TENANT
        self._lock = threading.Lock()
        self._verdicts = {v: 0 for v in VERDICTS}
        self._deferred_lof = 0

    def _tenant_kv(self) -> dict:
        """The record tag: present only for non-default tenants (the
        schema contract — an absent key reads as the default tenant, so
        every pre-tenancy record stays valid)."""
        if self.tenant != DEFAULT_TENANT:
            return {"tenant": self.tenant}
        return {}

    # -- the ladder --------------------------------------------------------
    def _shed_reason(self, rows: int, queue_depth: int, debt: dict) -> str | None:
        """The saturation test, shared by :meth:`resolve` and
        :meth:`overloaded` so the balancer-drain signal and the actual
        shed verdict can never disagree on where the envelope is."""
        b = self.bounds
        if queue_depth >= b.max_queue_depth:
            return (
                f"queue_depth {queue_depth} >= max_queue_depth "
                f"{b.max_queue_depth}"
            )
        pending = int(debt.get("pending_rows", 0))
        if pending + rows > b.max_pending_rows:
            return (
                f"pending_rows {pending} + {rows} > max_pending_rows "
                f"{b.max_pending_rows}"
            )
        lag = float(debt.get("ingest_lag_s", 0.0))
        if lag > b.max_ingest_lag_s:
            return (
                f"ingest_lag {lag:.1f}s > max_ingest_lag_s "
                f"{b.max_ingest_lag_s:.1f}s"
            )
        return None

    def resolve(
        self, rows: int, queue_depth: int, debt: dict,
        applying: bool = False, emit: bool = True, replay: bool = False,
    ) -> AdmissionDecision:
        """Resolve one incoming delta batch against the live debt state.

        ``debt`` is a :meth:`RepairDebt.snapshot` dict; ``queue_depth``
        counts batches already parked on the apply queue; ``applying``
        says whether an apply is in flight right now. Emits the
        ``admission`` provenance record and updates the counters on
        every call. ``emit=False`` defers just the record to a later
        :meth:`emit_admission` call — the server resolves under its
        queue lock, and a sink's disk write must not serialize every
        handler, the worker and /healthz behind one fsync (counters and
        gauges are memory-only and stay here either way).

        ``replay=True`` (WAL startup replay / promotion, serve/wal.py):
        the batch was already accepted and durably acknowledged in a
        previous life — shedding it now would un-accept acknowledged
        work, so the shed rung is skipped and the verdict records why.
        The LOF-defer rung still applies (replay pressure is pressure).
        """
        rows = int(rows)
        shed = None if replay else self._shed_reason(rows, queue_depth, debt)
        if shed is not None:
            verdict, reason, lof_mode = "shed", shed, "refresh"
        else:
            lof_mode, defer_why = self._lof_mode_reason(rows, debt)
            if queue_depth >= 1:
                verdict = "coalesce"
                reason = (
                    f"{queue_depth} batch(es) already queued: merging into "
                    "one splice + one repair"
                )
            elif applying:
                verdict = "queue"
                reason = "apply in flight; parking on the apply queue"
            else:
                verdict = "accept"
                reason = "within bounds, queue idle"
            if replay:
                reason = (
                    "WAL replay of an already-acknowledged batch "
                    f"(shed rung skipped); {reason}"
                )
            if defer_why:
                reason += f"; {defer_why}"
        decision = AdmissionDecision(
            verdict=verdict, reason=reason, lof_mode=lof_mode,
            retry_after_s=self.bounds.retry_after_s if verdict == "shed" else 0.0,
            rows=rows, queue_depth=queue_depth,
        )
        with self._lock:
            self._verdicts[verdict] += 1
            if lof_mode == "defer" and verdict != "shed":
                self._deferred_lof += 1
        self._export(queue_depth, debt)
        if emit:
            self.emit_admission(decision, debt)
        return decision

    def emit_admission(self, decision: AdmissionDecision, debt: dict) -> None:
        """The ``admission`` provenance record for one resolution —
        split out so a caller that resolved under a lock can write the
        record after releasing it."""
        if self.sink is not None:
            self.sink.emit(
                "admission",
                verdict=decision.verdict,
                reason=decision.reason,
                queue_depth=decision.queue_depth,
                rows=decision.rows,
                lof_mode=decision.lof_mode,
                repair_debt=dict(debt),
                **self._tenant_kv(),
            )

    def _lof_mode_reason(self, rows: int, debt: dict) -> tuple[str, str]:
        """Rung 2 of the ladder: defer the LOF refresh under sustained
        pressure (past ``defer_frac`` of either bound). Never defers
        label repair — only the outlier column, which the snapshot then
        marks stale."""
        b = self.bounds
        pending = int(debt.get("pending_rows", 0)) + int(rows)
        lag = float(debt.get("ingest_lag_s", 0.0))
        row_thresh = b.defer_frac * b.max_pending_rows
        lag_thresh = b.defer_frac * b.max_ingest_lag_s
        if pending > row_thresh:
            return "defer", (
                f"lof deferred: pending_rows {pending} > "
                f"{b.defer_frac:g}*max ({row_thresh:g})"
            )
        if lag > lag_thresh:
            return "defer", (
                f"lof deferred: ingest_lag {lag:.1f}s > "
                f"{b.defer_frac:g}*max ({lag_thresh:g}s)"
            )
        return "refresh", ""

    def lof_mode(self, debt: dict, rows: int = 0) -> str:
        """Re-resolve just the LOF rung at apply time (pressure may have
        changed while the batch sat on the queue)."""
        return self._lof_mode_reason(rows, debt)[0]

    def overloaded(self, queue_depth: int, debt: dict) -> tuple[bool, str]:
        """Would a minimal (1-row) delta shed right now? The
        ``/healthz`` drain signal — driven by the SAME saturation test
        as the shed verdict, so balancer drain logic needs no duplicated
        thresholds."""
        reason = self._shed_reason(1, queue_depth, debt)
        return reason is not None, reason or ""

    # -- accounting --------------------------------------------------------
    def record_shed(
        self, reason: str, rows: int, queue_depth: int, debt: dict,
        stage: str = "admission",
    ) -> None:
        """One structured ``delta_shed`` record + counter. ``stage``:
        ``admission`` (refused at the front door) or ``deadline`` /
        ``shutdown`` (accepted, then shed off the queue before apply)."""
        if self.registry is not None:
            self.registry.counter(
                "graphmine_serve_deltas_shed_total",
                "delta batches refused or dropped by admission control",
            ).inc()
        if self.sink is not None:
            self.sink.emit(
                "delta_shed",
                stage=stage,
                reason=reason,
                rows=int(rows),
                queue_depth=int(queue_depth),
                retry_after_s=self.bounds.retry_after_s,
                repair_debt=dict(debt),
                **self._tenant_kv(),
            )

    def record_coalesce(self, info: dict, debt: dict) -> None:
        """One ``delta_coalesce`` record + counter per merged group."""
        if self.registry is not None:
            self.registry.counter(
                "graphmine_serve_deltas_coalesced_total",
                "delta batches merged into a coalesced apply",
            ).inc(int(info.get("batches", 0)))
        if self.sink is not None:
            self.sink.emit(
                "delta_coalesce", repair_debt=dict(debt),
                **self._tenant_kv(), **info,
            )

    def _export(self, queue_depth: int, debt: dict) -> None:
        reg = self.registry
        if reg is None:
            return
        if self.tenant != DEFAULT_TENANT:
            # Per-tenant controllers would race each other into one
            # unlabelled gauge (last writer wins = noise); the default
            # tenant's controller keeps the fleet-facing gauges and
            # per-tenant state is served on /statusz.
            return
        with self._lock:
            counts = dict(self._verdicts)
        for verdict, n in counts.items():
            # set-on-gauge, not counter.inc: resolve() under the queue
            # lock must stay cheap, and totals are authoritative in
            # self._verdicts (one owner) — the gauge mirrors it.
            reg.gauge(
                f"graphmine_serve_admission_{verdict}_total",
                f"delta batches resolved to the {verdict} verdict",
            ).set(n)
        reg.gauge(
            "graphmine_serve_delta_queue_depth",
            "delta batches parked on the apply queue",
        ).set(queue_depth)
        over, _ = self.overloaded(queue_depth, debt)
        reg.gauge(
            "graphmine_serve_overloaded",
            "1 when a new delta would shed (the /healthz drain signal)",
        ).set(1 if over else 0)

    def snapshot(self) -> dict:
        """Admission state for ``/statusz`` — verdict totals, the bounds
        in force, and the LOF-defer count."""
        with self._lock:
            counts = dict(self._verdicts)
            deferred = self._deferred_lof
        return {
            "tenant": self.tenant,
            "verdicts": counts,
            "lof_deferred": deferred,
            "bounds": self.bounds.snapshot(),
        }


# ---- coalescing ------------------------------------------------------------


def coalesce_deltas(
    deltas, base_src, base_dst
) -> tuple[EdgeDelta, dict]:
    """Merge validated delta batches into ONE order-exact ``EdgeDelta``.

    Splicing the merged delta produces BYTE-IDENTICAL edge arrays to
    splicing the batches sequentially (pinned by
    the JAX package's ``tests/test_admission.py::test_coalesce_equals_sequential``;
    the port's merge equals the JAX one, ``tests/test_torch_serve.py``), which
    is what lets a burst pay one splice + one warm repair instead of N.
    The subtlety is insert/delete interaction ACROSS batches: a delete in
    batch *i* consumes, in order of preference,

    1. a remaining *base* occurrence of its ``(src, dst)`` key — splice
       removes earliest-position matches first, and base edges precede
       every in-window insert;
    2. the OLDEST surviving insert of that key from batches ``< i``
       (sequential appends keep batch order, so the oldest insert is the
       earliest position) — the pair cancels and never reaches splice;
    3. nothing — the delete is unmatched and dropped (counted, same
       quarantine semantics as a sequential apply).

    Within one batch, deletes resolve BEFORE that batch's inserts (splice
    processes deletes against the pre-batch arrays), so a batch can never
    delete its own inserts — exactly as sequential applies behave.

    ``base_src``/``base_dst`` are the ingestor's current edge arrays
    (occurrence counts only — O(E log d) via the same searchsorted
    prefilter as splice, never a full sort of E). Weighted deltas
    coalesce too: surviving inserts keep their weights (absent weights
    default to 1.0 when any batch in the group carries them).

    Returns ``(merged, info)`` with ``info = {batches, inserts, deletes,
    cancelled_pairs, unmatched_deletes, rows_in, rows_out}``.
    """
    deltas = list(deltas)
    if not deltas:
        raise ValueError("coalesce_deltas needs at least one delta")
    weighted = any(d.insert_weight is not None for d in deltas)
    if not any(d.num_deletes for d in deltas):
        # Insert-only fast path — the typical append-heavy burst, and
        # exactly when groups are largest: with no deletes there is
        # nothing to cancel, so the merge is a pure concatenation in
        # batch order (identical to sequential appends) and the per-row
        # cancellation walk below never runs on the overload hot path.
        rows_in = sum(d.num_inserts for d in deltas)
        merged = EdgeDelta(
            insert_src=np.concatenate([d.insert_src for d in deltas]),
            insert_dst=np.concatenate([d.insert_dst for d in deltas]),
            insert_weight=(
                np.concatenate([
                    d.insert_weight if d.insert_weight is not None
                    else np.ones(d.num_inserts, np.float32)
                    for d in deltas
                ]) if weighted else None
            ),
        )
        return merged, {
            "batches": len(deltas),
            "inserts": merged.num_inserts,
            "deletes": 0,
            "cancelled_pairs": 0,
            "unmatched_deletes": 0,
            "rows_in": rows_in,
            "rows_out": merged.num_inserts,
        }
    base_src = np.asarray(base_src, np.int64)
    base_dst = np.asarray(base_dst, np.int64)

    all_ids = [base_src, base_dst]
    for d in deltas:
        all_ids.extend(
            [d.insert_src, d.insert_dst, d.delete_src, d.delete_dst]
        )
    enc = int(max((int(a.max()) for a in all_ids if len(a)), default=0)) + 2

    # base occurrence counts, restricted to keys any delete targets
    del_keys = np.unique(
        np.concatenate(
            [d.delete_src * enc + d.delete_dst for d in deltas]
            or [np.empty(0, np.int64)]
        )
    )
    base_remaining: dict = {}
    if len(del_keys) and len(base_src):
        ekey = base_src * enc + base_dst
        pos = np.minimum(np.searchsorted(del_keys, ekey), len(del_keys) - 1)
        hit = del_keys[pos] == ekey
        counts = np.bincount(pos[hit], minlength=len(del_keys))
        base_remaining = {
            int(k): int(c) for k, c in zip(del_keys, counts) if c
        }

    pending: list = []            # [src, dst, weight, alive]
    by_key: dict = {}             # key -> deque of pending indices (oldest first)
    out_del: list = []            # surviving base-delete keys
    cancelled = unmatched = rows_in = 0

    for d in deltas:
        rows_in += d.num_inserts + d.num_deletes
        for s, t in zip(d.delete_src.tolist(), d.delete_dst.tolist()):
            k = s * enc + t
            left = base_remaining.get(k, 0)
            if left:
                base_remaining[k] = left - 1
                out_del.append((s, t))
            else:
                dq = by_key.get(k)
                if dq:
                    pending[dq.popleft()][3] = False
                    cancelled += 1
                else:
                    unmatched += 1
        w = d.insert_weight
        for i, (s, t) in enumerate(
            zip(d.insert_src.tolist(), d.insert_dst.tolist())
        ):
            idx = len(pending)
            pending.append([s, t, 1.0 if w is None else float(w[i]), True])
            by_key.setdefault(s * enc + t, deque()).append(idx)

    ins = [(p[0], p[1], p[2]) for p in pending if p[3]]
    merged = EdgeDelta(
        insert_src=np.asarray([r[0] for r in ins], np.int64),
        insert_dst=np.asarray([r[1] for r in ins], np.int64),
        delete_src=np.asarray([r[0] for r in out_del], np.int64),
        delete_dst=np.asarray([r[1] for r in out_del], np.int64),
        insert_weight=(
            np.asarray([r[2] for r in ins], np.float32) if weighted else None
        ),
    )
    info = {
        "batches": len(deltas),
        "inserts": merged.num_inserts,
        "deletes": merged.num_deletes,
        "cancelled_pairs": cancelled,
        "unmatched_deletes": unmatched,
        "rows_in": rows_in,
        "rows_out": merged.num_inserts + merged.num_deletes,
    }
    return merged, info
