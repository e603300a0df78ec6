"""Stdlib HTTP front end: JSON queries over double-buffered snapshots
(PyTorch, one device).

Counterpart of ``graphmine_tpu/serve/server.py``'s single-writer server,
with the same endpoints, bodies, headers, records and metric names. One
:class:`SnapshotServer` owns a snapshot store, serves lookups from an
immutable :class:`~graphmine_tpu_torch.serve.query.QueryEngine` (its
gather table on the server's device) and accepts delta batches. Publishes
are **double-buffered**: the apply worker builds the next engine whole,
then swaps it in with one reference assignment; in-flight requests keep
the engine they bound at entry, so a publish never drops or torn-reads a
live query.

Endpoints (JSON unless noted):

====================  =====================================================
``GET  /healthz``      liveness (``ok``), readiness (``ready``), snapshot
                       version and age, repair debt, ``overloaded``
``GET  /statusz``      uptime, in-flight count, per-endpoint latency
                       quantiles, error rates, repair debt, batched-query
                       stage split, admission, quality, memory, tenancy
``GET  /metrics``      Prometheus text exposition
``GET  /alertz``       result-quality alerts and the quality section
``GET  /snapshot``     current snapshot manifest metadata
``GET  /vertex?v=``    one vertex: label, component, LOF, size, decile
``GET  /explain?vertex=`` per-vertex outlier explanation
``GET  /neighbors?v=`` neighbour ids of one vertex
``GET  /topk?community=&k=``  top-k LOF outliers of one community
``POST /query``        ``{"vertices": [...]}``: the batched gather path
``POST /delta``        ``{"insert": [[s,d],...], "delete": [[s,d],...]}``
                       (``X-Deadline-Ms`` narrows the queued deadline)
``GET  /wal``          400: this server keeps no write-ahead log
``POST /promote``      400: promotion needs a write-ahead log
``POST /reload``       reload the store's newest snapshot and swap
``POST /drain``        flip readiness off
``POST /undrain``      restore readiness
``POST /profilez``     guarded on-demand ``torch.profiler`` capture
                       (``{"duration_ms": N}``) or, with ``"kind":
                       "memory"``, a ``torch.cuda.memory._snapshot()``
                       pickle: 403 unless the server was started with a
                       capture dir, 501 when the profiler (or CUDA, for
                       memory) is unavailable
====================  =====================================================

Read endpoints honour an ``X-Serve-Version`` pin (409 on mismatch), every
response carries ``X-Request-Id`` (the client's, or a generated one), and
one timing middleware observes every request into the per-endpoint
histogram ``graphmine_serve_request_seconds`` and an ``access_log``
record. ``POST /delta`` resolves through one
:class:`~graphmine_tpu_torch.serve.admission.AdmissionController`
(accept/queue/coalesce/shed); accepted batches park on a bounded apply
queue drained by one background worker that merges everything waiting
into one splice and one repair (:func:`~graphmine_tpu_torch.serve.admission.coalesce_deltas`);
shed verdicts answer 503 with ``Retry-After``. State is kept per tenant
(``X-Tenant-Id`` or ``?tenant=``), the default tenant included.

The durable write path (``wal=``), standbys (``standby_of=``,
``primary_wal=``) and the sharded write plane (``writer_shards > 1``,
``GRAPHMINE_WRITER_SHARDS``) are ROADMAP item A4's later batch: the
constructor raises ``NotImplementedError`` for them, and ``/wal`` and
``/promote`` answer as the JAX server does with no log attached.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import os
import pickle
import re
import secrets
import threading
import time
import warnings
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.obs.alerts import AlertManager
from graphmine_tpu_torch.obs.memmodel import (
    export_memory_gauges,
    host_memory,
    serve_mem_budget_bytes,
)
from graphmine_tpu_torch.obs.registry import Registry
from graphmine_tpu_torch.obs.spans import (
    TRACE_HEADER,
    TraceContext,
    sink_trace_header,
)
from graphmine_tpu_torch.serve.admission import (
    AdmissionController,
    coalesce_deltas,
)
from graphmine_tpu_torch.serve.delta import (
    DeltaIngestor,
    EdgeDelta,
    RepairDebt,
    validate_delta,
)
from graphmine_tpu_torch.serve.query import QueryEngine
from graphmine_tpu_torch.serve.snapshot import PublishFencedError, SnapshotStore
from graphmine_tpu_torch.serve.tenancy import (
    DEFAULT_TENANT,
    TENANT_RE,
    TenantRegistry,
    UnknownTenantError,
)

_LATER = "ROADMAP item A4 (its later batch: wal, standby and promote, shardplane)"

# Client-supplied request ids are echoed into headers, records and logs:
# constrain them so a hostile header can't smuggle newlines/quotes.
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9._:-]{1,64}$")

# One table per method, mapping path -> _Handler method name. The SAME
# table resolves the histogram/access_log endpoint label (the path minus
# its slash) and dispatches the request, so a route can never exist in
# one place and not the other; unlisted paths 404 and share one
# "unknown" metric bucket (client typos must not mint unbounded label
# cardinality).
_GET_ROUTES = {
    "/healthz": "_ep_healthz",
    "/statusz": "_ep_statusz",
    "/metrics": "_ep_metrics",
    "/alertz": "_ep_alertz",
    "/snapshot": "_ep_snapshot",
    "/vertex": "_ep_vertex",
    "/explain": "_ep_explain",
    "/neighbors": "_ep_neighbors",
    "/topk": "_ep_topk",
    "/wal": "_ep_wal",
}
_POST_ROUTES = {
    "/query": "_ep_query",
    "/delta": "_ep_delta",
    "/reload": "_ep_reload",
    "/drain": "_ep_drain",
    "/undrain": "_ep_undrain",
    "/promote": "_ep_promote",
    "/profilez": "_ep_profilez",
}


def _jsonable(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


class _PendingDelta:
    """One accepted batch parked on the apply queue. State transitions
    (always under the queue condition's lock): ``queued`` →
    ``applying`` → ``done``/``error``, or ``queued`` → ``shed``
    (deadline passed / shutdown). ``event`` fires exactly once, at the
    terminal transition."""

    __slots__ = ("delta", "rows", "deadline", "deadline_s", "status",
                 "result", "error", "event", "shed_reason", "delta_id",
                 "trace", "t_accept", "tenant")

    def __init__(
        self, delta: EdgeDelta, rows: int, deadline: float,
        deadline_s: float,
    ):
        self.delta = delta
        self.rows = rows
        self.deadline = deadline
        self.deadline_s = deadline_s  # the budget, for shed messages
        self.status = "queued"
        self.result: dict | None = None
        self.error: BaseException | None = None
        self.event = threading.Event()
        self.shed_reason = ""
        # The client's X-Delta-Id, carried into the delta_stages record.
        self.delta_id = ""
        # Trace identity and the causal-chain stamp: `trace` is the
        # accepting request's propagated traceparent header; t_accept is
        # the monotonic mark of the admission verdict, which the apply
        # worker turns into the per-stage breakdown (`delta_stages`
        # record + graphmine_serve_delta_stage_seconds histograms).
        self.trace = ""
        self.t_accept = time.monotonic()
        # Which tenant's sub-queue this batch parks on: its debt, sheds
        # and apply all charge here, never to another tenant's ledger.
        self.tenant = DEFAULT_TENANT


class _TenantSink:
    """Sink proxy for one non-default tenant's ingest/alert plane: every
    record emitted through it carries ``tenant=<id>`` (the obs-schema
    contract — an ABSENT key reads as the default tenant, so the default
    tenant's path never pays the proxy and every pre-tenancy record
    stays valid). Spans, the registry and tracer identity pass through
    to the real sink untouched."""

    __slots__ = ("_sink", "_tenant")

    def __init__(self, sink, tenant: str):
        self._sink = sink
        self._tenant = tenant

    def emit(self, phase: str, **kv):
        kv.setdefault("tenant", self._tenant)
        return self._sink.emit(phase, **kv)

    def __getattr__(self, name):
        return getattr(self._sink, name)


class _TenantState:
    """Everything ONE tenant owns on this server: its namespaced store and
    double-buffered engine, its own admission ladder and repair-debt
    ledger (a tenant saturating its bounds sheds only itself), its apply
    sub-queue with its deficit-round-robin balance, and its quality
    report and alert plane. The default tenant's state is the
    single-tenant server state, aliased through :class:`SnapshotServer`
    properties."""

    __slots__ = ("tenant", "store", "engine", "ingestor", "admission",
                 "debt", "alerts", "queue", "deficit",
                 "quality_report")

    def __init__(self, tenant: str, store: SnapshotStore):
        self.tenant = tenant
        self.store = store
        self.engine: QueryEngine | None = None
        self.ingestor: DeltaIngestor | None = None
        self.admission: AdmissionController | None = None
        self.debt: RepairDebt | None = None
        self.alerts: AlertManager | None = None
        self.queue: deque = deque()
        self.deficit = 0.0       # DRR balance, in rows
        self.quality_report = None


class SnapshotServer:
    """Query server + delta ingest endpoint over one snapshot store, on
    ``device`` (CUDA unless the caller names another device): the query
    engines' gather tables and every delta repair live there."""

    def __init__(
        self,
        store: SnapshotStore,
        host: str = "127.0.0.1",
        port: int = 0,
        sink=None,
        prom_out: str | None = None,
        num_shards: int = 1,
        slow_request_s: float = 1.0,
        admission: AdmissionController | None = None,
        ready_max_age_s: float | None = None,
        wal=None,
        writer_epoch: int | None = None,
        standby_of: str | None = None,
        primary_wal: str | None = None,
        profilez_dir: str | None = None,
        writer_shards: int | None = None,
        device=None,
    ):
        if wal is not None:
            raise NotImplementedError(f"wal= (the write-ahead log) is {_LATER}")
        if standby_of is not None or primary_wal is not None:
            raise NotImplementedError(
                f"standby_of= / primary_wal= (standby and promote) are {_LATER}"
            )
        if writer_shards is None:
            raw_ws = os.environ.get("GRAPHMINE_WRITER_SHARDS", "1")
            try:
                writer_shards = int(raw_ws)
            except ValueError as e:
                raise ValueError(
                    f"GRAPHMINE_WRITER_SHARDS={raw_ws!r} is not an int"
                ) from e
        if int(writer_shards) > 1:
            raise NotImplementedError(
                f"writer_shards={writer_shards} (the sharded write plane) is {_LATER}"
            )
        self.device = resolve_device(device)
        self.store = store
        self.sink = sink
        self.prom_out = prom_out
        self.num_shards = num_shards
        self.slow_request_s = float(slow_request_s)
        # Readiness bound (liveness vs readiness split): past this
        # snapshot age the replica reports ready: false. None (default,
        # or unset env GRAPHMINE_READY_MAX_AGE_S) = age never gates
        # readiness.
        if ready_max_age_s is None:
            raw = os.environ.get("GRAPHMINE_READY_MAX_AGE_S")
            if raw is not None:
                try:
                    ready_max_age_s = float(raw)
                except ValueError as e:
                    raise ValueError(
                        f"GRAPHMINE_READY_MAX_AGE_S={raw!r} is not a float"
                    ) from e
        self.ready_max_age_s = ready_max_age_s
        self._draining = False
        # The metric surface exists with or without a record sink: a
        # sinkless server still serves /metrics and /statusz.
        self.registry: Registry = (
            sink.registry if sink is not None else Registry()
        )
        # Multi-tenant state: one _TenantState per tenant. The default
        # tenant's is created here and the single-tenant attributes
        # (engine, admission, debt, alerts, queue) are property-aliased
        # into it. _rr is the weighted-fair dequeue's rotation of tenants
        # with queued work; the quantum is the per-visit row grant of the
        # deficit round-robin.
        self.tenancy = TenantRegistry()
        self._tenants: dict[str, _TenantState] = {
            DEFAULT_TENANT: _TenantState(DEFAULT_TENANT, store),
        }
        self._tenants_lock = threading.Lock()
        self._rr: deque = deque()
        raw_q = os.environ.get("GRAPHMINE_FAIR_QUANTUM_ROWS", "4096")
        try:
            self._fair_quantum_rows = max(1, int(raw_q))
        except ValueError as e:
            raise ValueError(
                f"GRAPHMINE_FAIR_QUANTUM_ROWS={raw_q!r} is not an int"
            ) from e
        self.debt = RepairDebt(registry=self.registry)
        # Result-quality alerting, evaluated on the existing cadences:
        # every /healthz, every /alertz or /statusz read, and after each
        # publish swap. GRAPHMINE_QUALITY=0 also stops the read-time
        # engine-state pass.
        self.quality_enabled = os.environ.get("GRAPHMINE_QUALITY", "1") != "0"
        self.alerts = AlertManager(sink=sink, registry=self.registry)
        # The single write-path policy owner. A caller-supplied
        # controller keeps its own bounds; the default reads
        # GRAPHMINE_ADMIT_* env.
        self.admission = admission if admission is not None else (
            AdmissionController(sink=sink, registry=self.registry)
        )
        if self.admission.sink is None:
            self.admission.sink = sink
        if self.admission.registry is None:
            self.admission.registry = self.registry
        # The epoch this writer stamps on publishes: the store's unless
        # told otherwise.
        self.writer_epoch = (
            store.current_epoch() if writer_epoch is None
            else int(writer_epoch)
        )
        snap = store.load(sink=sink)
        if snap is None:
            raise ValueError(
                f"snapshot store at {store.root!r} is empty; publish one "
                "first (pipeline --snapshot-out or serve_cli publish)"
            )
        # The double buffer: _engine is replaced atomically (one reference
        # assignment); handlers bind it to a local once per request.
        self._engine = QueryEngine(snap, device=self.device)
        # One publisher at a time: the store's generation rotation (and
        # the ingestor's host state) assume it. Held by the apply worker
        # around each apply+swap, and by /reload.
        self._delta_lock = threading.Lock()
        # The bounded apply queues (one sub-queue per tenant, each gated
        # by that tenant's admission bounds) + the one background worker
        # that drains them weighted-fair. ONE condition guards every
        # sub-queue.
        self._queue_cv = threading.Condition()
        self._applying = False
        self._worker: threading.Thread | None = None
        self._worker_stop = False
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # Set when a publish came back fenced (the store's epoch moved
        # past ours): this process is a deposed writer; reads keep
        # serving, writes refuse 503.
        self._fenced: str | None = None
        self._host, self._port = host, port
        self._t0_wall = time.time()
        self._t0_mono = time.perf_counter()
        self._inflight = 0
        self._req_lock = threading.Lock()
        self._endpoint_errors: dict = {}
        # On-demand profiling (POST /profilez): disabled unless a capture
        # directory is configured. One capture at a time (the profiler
        # is process-global).
        self.profilez_dir = profilez_dir or os.environ.get(
            "GRAPHMINE_PROFILEZ_DIR"
        )
        self._profilez_lock = threading.Lock()
        # Serve-process memory budget, resolved once (a malformed
        # GRAPHMINE_SERVE_MEM_BUDGET_BYTES fails here).
        self._mem_budget = serve_mem_budget_bytes()
        self._export_metrics()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> tuple[str, int]:
        """Bind and serve on a daemon thread; returns (host, port)."""
        server = self

        class Handler(_Handler):
            srv = server

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="graphmine-serve",
            daemon=True,
        )
        self._thread.start()
        return self._httpd.server_address[:2]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # Drain the apply worker: batches still queued shed with the
        # shutdown verdict (nothing is durable without a log).
        with self._queue_cv:
            self._worker_stop = True
            leftovers = []
            for ts in list(self._tenants.values()):
                leftovers.extend(ts.queue)
                ts.queue.clear()
            self._rr.clear()
            for p in leftovers:
                p.status = "shed"
                p.shed_reason = "server shutting down"
            self._queue_cv.notify_all()
        for p in leftovers:
            ts = self._tenants[p.tenant]
            ts.debt.abandoned()
            ts.debt.shed(p.rows)
            ts.admission.record_shed(
                p.shed_reason, p.rows, 0, ts.debt.snapshot(),
                stage="shutdown",
            )
            p.event.set()
        if self._worker is not None:
            self._worker.join(timeout=30)
            self._worker = None
        self._worker_stop = False

    def _ensure_worker(self) -> None:
        """Start the apply worker lazily (first delta) so in-process
        users get the full admission path without calling :meth:`start`."""
        with self._queue_cv:
            if self._worker_stop:
                # stop() is mid-shutdown and already shed everything
                # queued (including this caller's batch)
                return
            if self._worker is not None and self._worker.is_alive():
                return
            self._worker = threading.Thread(
                target=self._apply_worker, name="graphmine-delta-apply",
                daemon=True,
            )
            self._worker.start()

    # -- default-tenant aliases -------------------------------------------
    # The single-tenant attributes live on the default tenant's
    # _TenantState; these properties read and write the same objects, so
    # a single-tenant deployment never sees the tenancy layer.
    @property
    def _engine(self) -> QueryEngine:
        return self._tenants[DEFAULT_TENANT].engine

    @_engine.setter
    def _engine(self, value: QueryEngine) -> None:
        self._tenants[DEFAULT_TENANT].engine = value

    @property
    def _ingestor(self):
        return self._tenants[DEFAULT_TENANT].ingestor

    @_ingestor.setter
    def _ingestor(self, value) -> None:
        self._tenants[DEFAULT_TENANT].ingestor = value

    @property
    def admission(self) -> AdmissionController:
        return self._tenants[DEFAULT_TENANT].admission

    @admission.setter
    def admission(self, value: AdmissionController) -> None:
        self._tenants[DEFAULT_TENANT].admission = value

    @property
    def debt(self) -> RepairDebt:
        return self._tenants[DEFAULT_TENANT].debt

    @debt.setter
    def debt(self, value: RepairDebt) -> None:
        self._tenants[DEFAULT_TENANT].debt = value

    @property
    def alerts(self) -> AlertManager:
        return self._tenants[DEFAULT_TENANT].alerts

    @alerts.setter
    def alerts(self, value: AlertManager) -> None:
        self._tenants[DEFAULT_TENANT].alerts = value

    # -- tenant plumbing ---------------------------------------------------
    def _tenant_state(self, tenant: str, create: bool = True) -> _TenantState:
        """The tenant's state, admitting it lazily on first touch when
        its store namespace already holds a published snapshot. A
        malformed id raises ``ValueError`` (HTTP 400, before any path is
        built); a valid id with no namespace behind it raises
        :class:`UnknownTenantError` (HTTP 404)."""
        ts = self._tenants.get(tenant)
        if ts is not None:
            return ts
        # validates the id (ValueError -> 400) before touching the disk
        store = self.store.for_tenant(tenant)
        if not create:
            raise UnknownTenantError(tenant)
        snap = store.load(sink=self.sink)
        if snap is None:
            raise UnknownTenantError(tenant)
        ts = self._make_tenant_state(tenant, store, snap)
        with self._tenants_lock:
            registered = self._tenants.setdefault(tenant, ts)
        self.tenancy.note(tenant)
        self.tenancy.note_bytes(tenant, registered.engine.snapshot.nbytes)
        return registered

    def _make_tenant_state(
        self, tenant: str, store: SnapshotStore, snap,
    ) -> _TenantState:
        ts = _TenantState(tenant, store)
        sink = self._tenant_sink(tenant)
        # registry=None on the ledger and the alert manager: per-tenant
        # instances writing the one unlabelled gauge each would race
        # last-writer-wins; the default tenant keeps the fleet-facing
        # gauges, per-tenant state is served on /statusz and /alertz.
        ts.debt = RepairDebt()
        ts.admission = AdmissionController(
            bounds=self.tenancy.bounds_for(tenant), sink=self.sink,
            registry=self.registry, tenant=tenant,
        )
        ts.alerts = AlertManager(sink=sink, tenant=tenant)
        ts.engine = QueryEngine(snap, device=self.device)
        # A writer's lazily-admitted namespace inherits the process
        # fence, so a deposed writer cannot keep publishing there.
        try:
            store.fence_epoch(self.writer_epoch)
        except (OSError, ValueError):
            pass  # equal/lower epochs are already fenced
        return ts

    def _tenant_sink(self, tenant: str):
        """The sink a tenant's ingest/alert plane emits through: the
        real sink for the default tenant, the tagging proxy otherwise."""
        if self.sink is None or tenant == DEFAULT_TENANT:
            return self.sink
        return _TenantSink(self.sink, tenant)

    def engine_for(self, tenant: str) -> QueryEngine:
        """The tenant's double-buffered engine — the read path's router.
        Every handler binds it ONCE per request, so a concurrent swap
        (of any tenant) never mixes two versions inside one response."""
        if not tenant or tenant == DEFAULT_TENANT:
            return self._engine
        return self._tenant_state(tenant).engine

    # -- snapshot swap ----------------------------------------------------
    @property
    def engine(self) -> QueryEngine:
        return self._engine

    def _swap(self, engine: QueryEngine, tenant: str = DEFAULT_TENANT) -> None:
        self._tenants[tenant].engine = engine  # atomic ref: the flip
        self.tenancy.note_bytes(tenant, engine.snapshot.nbytes)
        if tenant != DEFAULT_TENANT:
            # the fleet-facing gauges track the default tenant's chain;
            # per-tenant versions and bytes are served on /healthz +
            # /statusz
            return
        self._export_metrics()

    def _current_trace_header(self) -> str:
        """The emitting thread's current span as a propagatable header
        ("" without a tracer). Inside the request middleware this is the
        ADOPTED span of an inherited traceparent, so a delta's
        worker-side records stay in the originating request's trace."""
        return sink_trace_header(self.sink)

    def _run_labels(self) -> dict | None:
        """The run_id label BOTH exposition paths attach — the textfile
        and the live scrape must emit the same series, or a deployment
        scraping both double-counts every sample."""
        tracer = getattr(self.sink, "tracer", None)
        return {"run_id": tracer.run_id} if tracer is not None else None

    def _export_metrics(self) -> None:
        self.registry.gauge(
            "graphmine_serve_snapshot_version",
            "snapshot version currently serving queries",
        ).set(self._engine.version)
        if self.prom_out:
            try:
                self.registry.write_textfile(
                    self.prom_out, labels=self._run_labels()
                )
            except OSError:
                pass  # metrics export must never take queries down

    def reload(self, tenant: str = DEFAULT_TENANT) -> dict:
        """Load the tenant's newest store snapshot; swap if it is newer
        than the one serving (another process may have published).
        Serialized with delta ingest, and a swap drops the ingestor: its
        host edge/label state derives from the snapshot it last
        published, and applying a delta on top of the STALE state would
        silently discard the externally published snapshot's edges (its
        next publish would still chain version numbers from the store's
        manifest)."""
        ts = self._tenant_state(tenant)
        with self._delta_lock:
            snap = ts.store.load(sink=self.sink)
            swapped = snap is not None and snap.version != ts.engine.version
            if swapped:
                self._swap(QueryEngine(snap, device=self.device), tenant=ts.tenant)
                ts.ingestor = None
            return {"version": ts.engine.version, "swapped": swapped}

    def apply_delta(
        self, payload: dict, deadline_s: float | None = None,
        delta_id: str | None = None, ack: str | None = None,
        tenant: str = DEFAULT_TENANT,
    ) -> dict:
        """Ingest one delta batch (the POST /delta body) through
        admission control. Returns the publish result, or, on a shed, a
        structured refusal dict (``verdict: "shed"``) the HTTP layer
        turns into 503 + Retry-After.

        The caller blocks until its batch publishes (possibly coalesced
        with others: ``coalesced`` in the result says how many batches
        the publish carried) or until its deadline passes while still
        queued, in which case it is shed. ``deadline_s`` (the
        ``X-Deadline-Ms`` header) narrows the queued-batch deadline
        below the admission default, never widens it. ``delta_id`` (the
        ``X-Delta-Id`` header) is carried into the ``delta_stages``
        record; ``ack="wal"`` needs a write-ahead log, which this server
        does not keep (ValueError, the JAX server's answer without one).
        The batch charges ``tenant``'s ledger end to end: its admission
        bounds, its queue, its debt.
        """
        # Resolve the tenant FIRST: an unknown tenant must 404 before
        # any admission side effect, and a malformed id must 400.
        ts = self._tenant_state(tenant)
        tenant = ts.tenant
        if self._fenced is not None:
            # Deposed writer: a publish already refused with
            # publish_fenced, so every future apply here would too.
            return self._shed_payload(
                f"writer fenced ({self._fenced}): a newer writer owns "
                "the store; send writes to the promoted writer",
                ts.admission.bounds.retry_after_s,
            )
        if ack not in (None, "wal"):
            raise ValueError(f"unknown ack mode {ack!r} (use 'wal')")
        if ack == "wal":
            raise ValueError(
                "X-Delta-Ack: wal needs a server running with a "
                "write-ahead log (serve --wal or --writer-shards)"
            )
        bound = ts.admission.bounds.deadline_s
        deadline_s = bound if deadline_s is None else max(
            0.001, min(float(deadline_s), bound)
        )
        delta = EdgeDelta.from_pairs(
            insert=payload.get("insert", ()), delete=payload.get("delete", ())
        )
        if (
            delta.insert_weight is not None
            and ts.engine.snapshot.get("weights") is None
        ):
            # Refuse HERE, before the batch can queue: merged into a
            # coalesced group, this splice-time error would fail every
            # innocent batch in the group with it.
            raise ValueError(
                "delta carries insert weights but the served snapshot is "
                "unweighted; drop the weight column or republish a "
                "weighted snapshot"
            )
        rows = delta.num_inserts + delta.num_deletes
        # Only memory-cheap work happens under the queue lock (the
        # worker, /healthz and every other handler contend on it); the
        # sink's record writes happen after release.
        with self._queue_cv:
            if self._worker_stop:
                # stop() already drained the queue; parking here would
                # wait on a worker that is exiting
                return self._shed_payload(
                    "server shutting down",
                    ts.admission.bounds.retry_after_s,
                )
            debt_at_resolve = ts.debt.snapshot()
            decision = ts.admission.resolve(
                rows=rows, queue_depth=len(ts.queue),
                debt=debt_at_resolve, applying=self._applying, emit=False,
            )
            pending = None
            if decision.verdict != "shed":
                pending = _PendingDelta(
                    delta, rows, time.monotonic() + deadline_s, deadline_s,
                )
                pending.delta_id = delta_id or ""
                pending.trace = self._current_trace_header()
                pending.tenant = tenant
                # Debt accrues at ACCEPTANCE: batches parked on the
                # apply queue are pending work the ledger (and /healthz)
                # must already see; it is exactly what the shed bound
                # reads.
                ts.debt.submitted(rows)
                ts.queue.append(pending)
                if tenant not in self._rr:
                    self._rr.append(tenant)
                self._queue_cv.notify_all()
        ts.admission.emit_admission(decision, debt_at_resolve)
        if pending is None:
            ts.debt.shed(rows)
            ts.admission.record_shed(
                decision.reason, rows, decision.queue_depth,
                ts.debt.snapshot(),
            )
            return self._shed_payload(decision.reason, decision.retry_after_s)
        self._ensure_worker()

        # Wait for a terminal state. First leg: bounded by the deadline;
        # a batch STILL QUEUED past it is shed here (the worker's pop
        # applies the same rule, whichever side gets there first).
        pending.event.wait(
            max(0.0, pending.deadline - time.monotonic()) + 0.05
        )
        shed_now = False
        with self._queue_cv:
            if pending.status == "queued" and pending.deadline <= time.monotonic():
                try:
                    ts.queue.remove(pending)
                except ValueError:
                    pass  # the worker popped it between wait and lock
                else:
                    pending.status = "shed"
                    pending.shed_reason = (
                        f"deadline {pending.deadline_s:g}s passed while "
                        "queued"
                    )
                    shed_now = True
        if shed_now:
            ts.debt.abandoned()
            ts.debt.shed(pending.rows)
            ts.admission.record_shed(
                pending.shed_reason, pending.rows, len(ts.queue),
                ts.debt.snapshot(), stage="deadline",
            )
            pending.event.set()
        # Second leg: once APPLYING, the apply finishes (its runtime is
        # bounded by the repair budget) and the client gets the real
        # outcome, never a 503 for published work.
        pending.event.wait()
        if pending.status == "done":
            return pending.result
        if pending.status == "shed":
            return self._shed_payload(
                pending.shed_reason, ts.admission.bounds.retry_after_s
            )
        raise pending.error

    def _shed_payload(self, reason: str, retry_after_s: float) -> dict:
        return {
            "verdict": "shed",
            "error": "overloaded: delta shed by admission control",
            "reason": reason,
            "retry_after_s": float(retry_after_s),
        }

    # -- WAL replay / log shipping / promotion ----------------------------
    def wal_entries(self, from_seq: int, limit: int = 512) -> dict:
        """The ``GET /wal`` body. This server keeps no write-ahead log, so
        it answers as the JAX server does without one (HTTP 400)."""
        raise ValueError(
            "this server runs without a write-ahead log (serve --wal)"
        )

    def wait_applied(self, timeout: float = 60.0) -> bool:
        """Block until the apply queue is drained and nothing is
        applying — the promotion path's (and tests') 'is every durable
        acknowledgement published' barrier."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._queue_cv:
                idle = not self._any_queued_locked() and not self._applying
            if idle:
                return True
            time.sleep(0.02)
        return False

    def _any_queued_locked(self) -> bool:
        """Under the queue condition's lock: is ANY tenant's sub-queue
        non-empty? (The worker's wake predicate.)"""
        return any(ts.queue for ts in list(self._tenants.values()))

    def _warn(self, message: str) -> None:
        """Loud in both channels: a ``warnings.warn`` AND a ``warning``
        record when a sink is attached."""
        warnings.warn(message)
        if self.sink is not None:
            self.sink.emit("warning", message=message)

    def promote(self) -> dict:
        """Standby → writer. Promotion replays a write-ahead log, which
        this server does not keep, so it answers as the JAX server does
        without one (HTTP 400); standbys are ROADMAP item A4's later
        batch."""
        raise ValueError(
            "promote needs a write-ahead log (serve --wal)"
        )

    # -- the apply worker --------------------------------------------------
    def _pop_group(self) -> tuple[str, list, list]:
        """Under the queue lock: pick the next tenant by deficit
        round-robin and pop ITS waiting batches (coalescing never
        crosses a tenant — one publish builds on exactly one tenant's
        store and ingestor), splitting expired-deadline batches out for
        shedding (all tenants — a deadline is a deadline regardless of
        whose turn it is). Returns ``(tenant, group, expired)``.

        **Weighted fairness:** each tenant in the rotation
        earns ``_fair_quantum_rows`` of deficit per visit and spends it
        on its queued rows; leftover deficit carries to its next turn,
        so a tenant of many small batches and a tenant of few huge ones
        converge on the same row share. A group always carries at least
        one batch (a batch larger than the quantum must still make
        progress). With at most ONE tenant holding queued work the
        quantum is infinite — the pre-tenancy pop-everything behavior,
        coalescing counts and all."""
        group, expired = [], []
        now = time.monotonic()
        # list(): a lazy tenant admit can grow the dict mid-iteration
        for ts in list(self._tenants.values()):
            n = len(ts.queue)
            for _ in range(n):
                p = ts.queue.popleft()
                if p.status != "queued":
                    continue  # a handler-side deadline shed won the race
                if p.deadline <= now:
                    p.status = "shed"
                    p.shed_reason = (
                        f"deadline {p.deadline_s:g}s passed while queued"
                    )
                    expired.append(p)
                else:
                    ts.queue.append(p)
        active = sum(1 for ts in self._tenants.values() if ts.queue)
        quantum = (
            math.inf if active <= 1 else float(self._fair_quantum_rows)
        )
        tenant = DEFAULT_TENANT
        for _ in range(len(self._rr)):
            tid = self._rr[0]
            ts = self._tenants.get(tid)
            if ts is None or not ts.queue:
                # drained (or shed empty) since it joined the rotation:
                # a fresh enqueue re-adds it with a clean balance
                self._rr.popleft()
                if ts is not None:
                    ts.deficit = 0.0
                continue
            tenant = tid
            ts.deficit += quantum
            rows = 0
            while ts.queue and (
                not group or rows + ts.queue[0].rows <= ts.deficit
            ):
                p = ts.queue.popleft()
                p.status = "applying"
                group.append(p)
                rows += p.rows
            self._rr.popleft()
            if ts.queue:
                # unfinished backlog: spend the popped rows, keep the
                # remainder, go to the back of the rotation
                ts.deficit = max(0.0, ts.deficit - rows)
                self._rr.append(tid)
            else:
                ts.deficit = 0.0
            break
        return tenant, group, expired

    def _apply_worker(self) -> None:
        """Drain the apply queue: one iteration = one coalesced publish.

        Every popped batch is ALWAYS resolved (done/shed/error) — the
        ``finally`` discipline below is what lets handlers block on
        ``pending.event`` without a liveness caveat."""
        while True:
            with self._queue_cv:
                while not self._any_queued_locked() and not self._worker_stop:
                    self._queue_cv.wait(timeout=0.5)
                if self._worker_stop and not self._any_queued_locked():
                    return
                tenant, group, expired = self._pop_group()
                self._applying = bool(group)
            for p in expired:
                try:
                    # Telemetry must never take the worker down: a full
                    # disk killing the sink's JSONL write would strand
                    # every already-popped 'applying' batch on an event
                    # that nobody will ever set.
                    pts = self._tenants[p.tenant]
                    pts.debt.abandoned()
                    pts.debt.shed(p.rows)
                    pts.admission.record_shed(
                        p.shed_reason, p.rows, len(pts.queue),
                        pts.debt.snapshot(), stage="deadline",
                    )
                except Exception:  # noqa: BLE001 — bookkeeping only
                    pass
                finally:
                    p.event.set()
            if not group:
                continue
            try:
                result = self._apply_group(tenant, group)
                for p in group:
                    p.status, p.result = "done", result
            except BaseException as e:  # resolve, then keep serving
                # The ingestor's host state may have run ahead of the
                # served snapshot (e.g. a torch.cuda.OutOfMemoryError in
                # the LOF pass after the repair): drop it, so the next
                # apply rebuilds from the snapshot readers see.
                self._tenants[tenant].ingestor = None
                if isinstance(e, PublishFencedError) and self._fenced is None:
                    # Deposed: flip the write path closed (reads keep
                    # serving).
                    self._fenced = str(e)
                    self._warn(
                        "publish fenced by a newer writer epoch — this "
                        "process is deposed and now refuses new deltas "
                        f"(503): {e}"
                    )
                for p in group:
                    p.status, p.error = "error", e
            finally:
                with self._queue_cv:
                    self._applying = False
                for p in group:
                    p.event.set()

    def _apply_group(self, tenant: str, group: list) -> dict:
        """Apply one popped group — all batches of ONE tenant — as a
        single publish: validate each batch, coalesce when more than one
        waited, re-resolve the LOF rung at apply time (pressure may have
        moved while they sat queued), swap the tenant's fresh engine in.

        REBASE GUARD (the /reload-vs-inflight-delta contract): before
        building on the served engine, peek the store's newest
        version. An external publish the server hasn't reloaded yet —
        a /reload racing this apply, or a prober cadence that hasn't
        fired — means applying on the served snapshot would chain a new
        version number from the store's manifest while silently
        DISCARDING the external snapshot's edges. Reload-in-place first
        (swap + drop the stale ingestor), then apply on top: the delta
        rebases instead of clobbering.

        TRACE ADOPTION: the worker thread has no request
        span, so without help the `delta_apply`/`snapshot_publish`
        records it emits would land in the server's run trace instead of
        the delta's. The whole apply runs under a span adopted from the
        group LEADER's propagated context (the first batch with one),
        and each batch additionally gets its own `delta_stages` record
        in its OWN trace — so a coalesced group's non-leader batches
        still stitch end-to-end."""
        t_apply_start = time.monotonic()
        ts = self._tenants[tenant]
        leader_ctx = None
        if self.sink is not None:
            for p in group:
                leader_ctx = TraceContext.from_header(p.trace)
                if leader_ctx is not None:
                    break
        span = (
            self.sink.span(
                "delta_publish", emit=False, annotate=False,
                remote=leader_ctx,
            )
            if self.sink is not None and leader_ctx is not None
            else contextlib.nullcontext()
        )
        with span, self._delta_lock:
            newest = ts.store.peek_version()
            if newest is not None and newest != ts.engine.version:
                fresh = ts.store.load(sink=self.sink)
                if fresh is not None and fresh.version != ts.engine.version:
                    self._swap(QueryEngine(fresh, device=self.device), tenant=tenant)
                    ts.ingestor = None
            # Applies settle the ledger inside apply(); the worker is the
            # only applier, so an unchanged applies_total at a raise
            # means THIS group never settled — drop its pending entries.
            # The guard covers the whole group path (ingestor build,
            # validation, coalesce, apply): any of them failing means
            # these batches will never publish. (An apply that raised
            # after settling — or a failing engine build on the
            # already-published snapshot — must NOT drain entries
            # belonging to batches queued behind us.)
            settled_before = ts.debt.applies_total
            try:
                if ts.ingestor is None:
                    ts.ingestor = DeltaIngestor(
                        ts.store, sink=self._tenant_sink(tenant),
                        num_shards=self.num_shards,
                        snapshot=ts.engine.snapshot, debt=ts.debt,
                        epoch=self.writer_epoch, device=self.device,
                    )
                ing = ts.ingestor
                if len(group) > 1:
                    cleans, quarantined = [], 0
                    # Validate each batch against the vertex space AS
                    # GROWN by the batches before it — exactly what
                    # sequential applies would see. Against the fixed
                    # base count, a delete referencing a vertex an
                    # earlier batch in the group created would be
                    # quarantined here and the coalesced apply would
                    # serve an edge the sequential applies delete.
                    v_cur = ing.num_vertices
                    for p in group:
                        clean, q = validate_delta(p.delta, v_cur)
                        cleans.append(clean)
                        quarantined += sum(q.values())
                        if clean.num_inserts:
                            v_cur = max(
                                v_cur,
                                int(clean.insert_src.max()) + 1,
                                int(clean.insert_dst.max()) + 1,
                            )
                    merged, info = coalesce_deltas(cleans, ing.src, ing.dst)
                    info["quarantined_rows"] = quarantined
                    ts.admission.record_coalesce(info, ts.debt.snapshot())
                else:
                    merged = group[0].delta
                lof_mode = ts.admission.lof_mode(ts.debt.snapshot())
                snap = ing.apply(merged, lof_mode=lof_mode, batches=len(group))
            except BaseException:
                if ts.debt.applies_total == settled_before:
                    for _ in group:
                        ts.debt.abandoned()
                raise
            # The next engine is built whole (its device table copied
            # and synchronized) before the one-reference swap.
            self._swap(QueryEngine(snap, device=self.device), tenant=tenant)
            # Adopt the ingestor's quality pass (drift + canary) for
            # /statusz, /alertz and the alert rules — the served engine
            # and the report now describe the same version.
            ts.quality_report = ing.last_quality
        self._emit_delta_stages(group, snap, t_apply_start)
        # Publish-time alert evaluation (outside the delta lock — a
        # record fsync must not serialize handlers): a quality or canary
        # regression this publish introduced fires NOW, not at the next
        # prober pass.
        self.evaluate_alerts()
        self.registry.counter(
            "graphmine_serve_deltas_total", "delta batches ingested"
        ).inc(len(group))
        return {
            "version": snap.version,
            "snapshot_id": snap.snapshot_id,
            "num_vertices": int(len(snap["labels"])),
            "num_edges": int(len(snap["src"])),
            "coalesced": len(group),
            "lof_stale": bool(snap.meta.get("lof_stale", False)),
        }

    # -- per-delta time-to-visible stages ---------------------------------
    def _emit_delta_stages(self, group: list, snap, t_apply_start: float):
        """The writer-side causal chain of every batch this publish
        absorbed: admission accept → queued → apply → published (no WAL
        fsync stage: this server keeps no log), observed into per-stage histograms
        (``graphmine_serve_delta_stage_seconds{stage=...}``, the
        ``/statusz`` breakdown) and emitted as one ``delta_stages``
        record per batch IN THAT BATCH's trace — telemetry only, so a
        failure here must never fail a publish that already landed."""
        t_done = time.monotonic()
        try:
            for p in group:
                stages = {}
                stages["queued_s"] = round(
                    max(0.0, t_apply_start - p.t_accept), 6
                )
                stages["apply_s"] = round(
                    max(0.0, t_done - t_apply_start), 6
                )
                stages["total_s"] = round(
                    max(0.0, t_done - p.t_accept), 6
                )
                for stage, seconds in stages.items():
                    self.registry.histogram(
                        "graphmine_serve_delta_stage_seconds",
                        "per-stage delta latency: accept to queryable "
                        "on this writer",
                        stage=stage[:-2],  # queued_s -> queued
                    ).observe(seconds)
                if self.sink is None:
                    continue
                ctx = TraceContext.from_header(p.trace) if p.trace else None
                span = (
                    self.sink.span(
                        "delta_stages", emit=False, annotate=False,
                        remote=ctx,
                    )
                    if ctx is not None else contextlib.nullcontext()
                )
                with span:
                    self.sink.emit(
                        "delta_stages",
                        version=snap.version,
                        seq=None,
                        delta_id=p.delta_id,
                        rows=p.rows,
                        coalesced=len(group),
                        stages=stages,
                    )
        except Exception:  # noqa: BLE001 — bookkeeping only
            pass

    def delta_stage_latency(self) -> dict:
        """Per-stage p50/p99 of the delta causal chain — the
        ``/statusz`` time-to-visible breakdown (the router adds the
        read-side tail: each replica's reload-to-queryable)."""
        fam = self.registry.histogram_family(
            "graphmine_serve_delta_stage_seconds"
        )
        out: dict = {}
        if fam is None:
            return out
        for child in fam.children():
            s = child.snapshot()
            if not s.count:
                continue
            out[child.labels.get("stage", "?")] = s.summary()
        return out

    # -- on-demand device profiling (POST /profilez) ----------------------
    def profilez(
        self, duration_ms: int = 1000, kind: str = "trace",
    ) -> tuple[int, dict]:
        """Capture a ``torch.profiler`` trace (CPU and, on CUDA, the card's
        activity) of this live replica, or, with ``kind="memory"``, one
        ``torch.cuda.memory._snapshot()`` of the caching allocator,
        tagged with the requesting trace. Returns ``(http_status,
        body)``: 403 when no capture directory is configured, 501 when
        the profiler (or, for memory, CUDA) is unavailable, 409 when a
        capture is already running (both kinds share one single-flight
        lock), 200 with the capture path otherwise. The profiler's start
        (CUPTI's, on the card) is outside ``duration_ms``."""
        if not self.profilez_dir:
            return 403, {
                "error": "profilez disabled: start the server with "
                "profilez_dir= (serve_cli --profilez-dir) to allow "
                "on-demand captures",
            }
        duration_ms = max(1, min(int(duration_ms), 30_000))
        trace_header = self._current_trace_header()
        ctx = TraceContext.from_header(trace_header)
        tag = ctx.trace_id if ctx is not None else secrets.token_hex(4)
        if kind == "memory":
            return self._profilez_memory(tag, ctx)
        out_dir = os.path.join(
            self.profilez_dir, f"profile-{int(time.time())}-{tag}"
        )
        if not self._profilez_lock.acquire(blocking=False):
            return 409, {"error": "a profile capture is already running"}
        try:
            try:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if self.device.type == "cuda":
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.__enter__()
            except Exception as e:  # noqa: BLE001 — no profiler here
                if self.sink is not None:
                    self.sink.emit(
                        "profile_capture", dir=out_dir, ok=False,
                        error=repr(e),
                    )
                return 501, {
                    "error": "torch profiler unavailable on this replica",
                    "detail": repr(e),
                }
            try:
                time.sleep(duration_ms / 1000.0)
            finally:
                try:
                    prof.__exit__(None, None, None)
                    os.makedirs(out_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
                except Exception as e:  # noqa: BLE001 — trace incomplete
                    if self.sink is not None:
                        self.sink.emit(
                            "profile_capture", dir=out_dir, ok=False,
                            error=repr(e),
                        )
                    return 500, {
                        "error": "profiler stop failed; the trace "
                        "directory may be incomplete",
                        "dir": out_dir,
                        "detail": repr(e),
                    }
        finally:
            self._profilez_lock.release()
        if self.sink is not None:
            self.sink.emit(
                "profile_capture", dir=out_dir, ok=True,
                duration_ms=duration_ms,
            )
        return 200, {
            "ok": True,
            "dir": out_dir,
            "duration_ms": duration_ms,
            "trace_id": ctx.trace_id if ctx is not None else "",
        }

    def _profilez_memory(self, tag: str, ctx) -> tuple[int, dict]:
        """``kind="memory"``: one ``torch.cuda.memory._snapshot()`` of the
        caching allocator (live segments and blocks), pickled next to the
        trace captures under the same single-flight lock. 501 off CUDA,
        where there is no device allocator to read."""
        os.makedirs(self.profilez_dir, exist_ok=True)
        path = os.path.join(
            self.profilez_dir, f"memprof-{int(time.time())}-{tag}.pickle"
        )
        if not self._profilez_lock.acquire(blocking=False):
            return 409, {"error": "a profile capture is already running"}
        try:
            try:
                if self.device.type != "cuda":
                    raise RuntimeError(
                        f"the server's device is {self.device}, not CUDA"
                    )
                import torch

                blob = pickle.dumps(torch.cuda.memory._snapshot(self.device))
            except Exception as e:  # noqa: BLE001 — no CUDA allocator
                if self.sink is not None:
                    self.sink.emit(
                        "profile_capture", dir=path, ok=False,
                        kind="memory", error=repr(e),
                    )
                return 501, {
                    "error": "torch.cuda.memory._snapshot unavailable on "
                    "this replica",
                    "detail": repr(e),
                }
            with open(path, "wb") as f:
                f.write(blob)
        finally:
            self._profilez_lock.release()
        if self.sink is not None:
            self.sink.emit(
                "profile_capture", dir=path, ok=True, kind="memory",
                bytes=len(blob),
            )
        return 200, {
            "ok": True,
            "path": path,
            "kind": "memory",
            "bytes": len(blob),
            "trace_id": ctx.trace_id if ctx is not None else "",
        }

    # -- liveness vs readiness --------------------------------------------
    def drain(self) -> dict:
        """Flip readiness off (``ready: false``) while keeping the
        process fully alive — the balancer/fleet-prober contract for
        taking a replica out of rotation without killing in-flight
        work. Idempotent; :meth:`undrain` restores."""
        self._draining = True
        return self.healthz()

    def undrain(self) -> dict:
        self._draining = False
        return self.healthz()

    def _ready(self, eng) -> tuple[bool, str]:
        """The readiness verdict (``/healthz`` ``ready``): false while
        draining or while the served snapshot is stale beyond the
        configured age bound. Liveness (``ok``) is separate — a
        draining or stale replica is alive, just not routable."""
        if self._draining:
            return False, "draining"
        age = self._snapshot_age_s(eng)
        if self.ready_max_age_s is not None and age > self.ready_max_age_s:
            return False, (
                f"snapshot_age {age:.1f}s > ready_max_age_s "
                f"{self.ready_max_age_s:g}s"
            )
        return True, ""

    # -- SLO surfaces -----------------------------------------------------
    def healthz(self) -> dict:
        """Liveness + readiness + staleness: version, snapshot age,
        repair debt, the ``overloaded`` drain signal, and ``ready`` —
        the one documented contract (docs/SERVING.md "healthz schema")
        the fleet prober and external balancers key off. ``ok`` is
        liveness (the process answers); ``ready`` is routability (false
        while draining or stale-beyond-bound); ``overloaded`` is the
        write-path drain signal, driven by the same admission bounds
        that decide the shed verdict."""
        eng = self._engine
        debt = self.debt.snapshot()
        tenants = list(self._tenants.values())
        with self._queue_cv:
            depths = {ts.tenant: len(ts.queue) for ts in tenants}
        depth = sum(depths.values())
        overloaded, why = self.admission.overloaded(
            depths.get(DEFAULT_TENANT, 0), debt
        )
        if not overloaded:
            # any tenant saturating ITS OWN bounds flips the fleet-level
            # drain signal (the replica is a shared process), with the
            # culprit named — the per-tenant sections say who
            for ts in tenants:
                if ts.tenant == DEFAULT_TENANT:
                    continue
                over_t, why_t = ts.admission.overloaded(
                    depths.get(ts.tenant, 0), ts.debt.snapshot()
                )
                if over_t:
                    overloaded, why = True, f"tenant {ts.tenant}: {why_t}"
                    break
        ready, not_ready_why = self._ready(eng)
        # The prober cadence IS the alert-evaluation cadence:
        # the fleet prober polls /healthz, so firing→resolved transitions
        # happen fleet-wide without a new timer thread.
        self.evaluate_alerts()
        out = {
            "ok": True,
            "alerts_firing": sum(len(ts.alerts.firing()) for ts in tenants),
            "ready": ready,
            "draining": self._draining,
            "version": eng.version,
            "snapshot_id": eng.snapshot.snapshot_id,
            "num_vertices": eng.num_vertices,
            "snapshot_age_s": self._snapshot_age_s(eng),
            "repair_debt_rows": debt["pending_rows"],
            "ingest_lag_s": debt["ingest_lag_s"],
            "overloaded": overloaded,
            "delta_queue_depth": depth,
            "lof_stale": eng.lof_stale,
            "writer_epoch": self.writer_epoch,
            # Tenancy: count + per-tenant snapshot age and
            # version maps. The fleet router's rolling reload reads
            # tenant_versions to call a replica caught up only when it
            # is caught up on EVERY tenant, and serve_cli --tenant
            # health checks read tenant_snapshot_age_s.
            "tenants": len(tenants),
            "tenant_snapshot_age_s": {
                ts.tenant: self._snapshot_age_s(ts.engine) for ts in tenants
            },
            "tenant_versions": {
                ts.tenant: ts.engine.version for ts in tenants
            },
        }
        if self._fenced is not None:
            # deposed writer: reads serve, writes refuse 503 — the
            # balancer/operator signal that this process lost ownership
            out["fenced"] = self._fenced
        if not ready:
            out["not_ready_reason"] = not_ready_why
        if overloaded:
            out["overload_reason"] = why
        return out

    def _snapshot_age_s(self, eng: QueryEngine) -> float:
        created = eng.snapshot.meta.get("created")
        base = float(created) if created else self._t0_wall
        return round(max(0.0, time.time() - base), 3)

    # -- memory plane ------------------------------------------------------
    def memory_payload(self) -> dict:
        """The ``/statusz`` "memory" section + ``graphmine_memory_*``
        gauges (docs/OBSERVABILITY.md "Memory plane"): host
        RSS and headroom against the process budget, the served
        snapshot's array bytes vs the derived query index — byte
        accounting for everything this process deliberately holds, so "RSS grew" decomposes into WHICH
        plane grew. Updated on the cadences that already read it
        (/statusz, and /healthz through the alert values — the prober
        cadence); no new threads."""
        out = host_memory(self._mem_budget)
        eng = self._engine
        out.update(eng.memory_bytes())
        export_memory_gauges(self.registry, out)
        return out

    # -- result quality & alerts ------------------------------------------
    def quality_payload(self, tenant: str = DEFAULT_TENANT) -> dict:
        """The "quality" section /statusz and /alertz serve: the
        writer's last full pass (state + drift + canary) when it is
        still the served version, else the engine's own lazily-built
        state — a replica that only reloads still exposes its sketches
        for the router's fleet merge. Tenant-scoped: each tenant's
        sketches and canary describe ITS graph only."""
        ts = self._tenant_state(tenant)
        eng = ts.engine
        rep = ts.quality_report
        if rep is not None and rep.state.version == eng.version:
            return rep.payload()
        if not self.quality_enabled:
            return {"disabled": True}
        from graphmine_tpu_torch.obs.quality import export_gauges

        state = eng.quality_state()
        if tenant == DEFAULT_TENANT:
            # unlabelled quality gauges track the default tenant only
            # (the per-tenant race rule — see _make_tenant_state)
            export_gauges(self.registry, state)
        return {"state": state.payload()}

    def _alert_values(self, tenant: str = DEFAULT_TENANT) -> dict:
        """The flat metric dict the alert rules evaluate over: quality
        numbers from the freshest source plus the serving-side gauges
        the default ingest-lag rule reads. Per tenant — a canary
        regression in tenant A's graph must page naming A and never
        trip B's rules."""
        ts = self._tenant_state(tenant)
        debt = ts.debt.snapshot()
        eng = ts.engine
        values = {
            "ingest_lag_s": debt["ingest_lag_s"],
            "repair_debt_rows": debt["pending_rows"],
            "snapshot_age_s": self._snapshot_age_s(eng),
        }
        if tenant == DEFAULT_TENANT:
            # Memory headroom rides the same evaluation: the
            # prober's /healthz cadence drives the low-headroom rule
            # fleet-wide, and the read refreshes the graphmine_memory_*
            # gauges as a side effect. Metric absent when no budget is
            # resolvable — the rule then simply never fires. The budget
            # (and RSS) is the PROCESS's, so only the default tenant's
            # rule set carries it — one page per replica, not one per
            # tenant.
            headroom = self.memory_payload().get("headroom_frac")
            if headroom is not None:
                values["memory_headroom_frac"] = headroom
        rep = ts.quality_report
        if rep is not None and rep.state.version == eng.version:
            values.update(rep.values())
        elif self.quality_enabled:
            # cached-only (build=False): /healthz drives this path at
            # probe cadence, and a liveness probe must not pay the O(V)
            # state build after every swap — the quality rules simply
            # don't evaluate until an /alertz or /statusz read (or the
            # router's fan-out) builds the state explicitly.
            state = eng.quality_state(build=False)
            if state is not None:
                values["quality_anomaly_rate"] = state.anomaly_rate
                values["quality_num_communities"] = state.num_communities
        return values

    def evaluate_alerts(self) -> list:
        """One alert-rule evaluation pass over EVERY tenant's rule set;
        returns the transitions. Never raises into a caller — /healthz
        answering 500 because a quality pass hiccuped would fail the
        prober over telemetry."""
        out = []
        for ts in list(self._tenants.values()):
            try:
                out.extend(ts.alerts.evaluate(self._alert_values(ts.tenant)))
            except Exception:  # noqa: BLE001 — alerting must not break serving
                pass
        return out

    def alertz(self, tenant: str = DEFAULT_TENANT) -> dict:
        """The ``/alertz`` body: alert level state + the quality section
        (evaluated at read time, so a drained-and-idle server still
        transitions rules whose conditions cleared). ``?tenant=`` or
        ``X-Tenant-Id`` scopes the page to that tenant's rule set."""
        self.evaluate_alerts()
        ts = self._tenant_state(tenant)
        out = {
            "version": ts.engine.version,
            **ts.alerts.snapshot(),
            "quality": self.quality_payload(tenant),
        }
        if tenant != DEFAULT_TENANT:
            out["tenant"] = tenant
        return out

    def endpoint_latency(self) -> dict:
        """Per-endpoint latency/error summary from the request histogram
        family: count, errors, error_rate, p50/p95/p99 (bucket-estimated
        — within one bucket of the exact offline quantiles from the
        ``access_log`` JSONL, the ``tests/test_slo.py`` acceptance)."""
        fam = self.registry.histogram_family("graphmine_serve_request_seconds")
        out: dict = {}
        if fam is None:
            return out
        with self._req_lock:
            errors = dict(self._endpoint_errors)
        for child in fam.children():
            ep = child.labels.get("endpoint", "?")
            snap = child.snapshot()
            if not snap.count:
                continue
            err = errors.get(ep, 0)
            out[ep] = {
                **snap.summary(),
                "errors": err,
                "error_rate": round(err / snap.count, 4),
                "mean_s": round(snap.sum / snap.count, 6),
                "p95_s": round(snap.quantile(0.95), 6),
            }
        return out

    def statusz(self) -> dict:
        """The SLO page — and, when a sink is attached, one
        ``slo_rollup`` record per read, so the offline JSONL carries
        periodic rollup checkpoints a scrape-less run can still plot."""
        eng = self._engine
        tenants = list(self._tenants.values())
        with self._req_lock:
            inflight = self._inflight
        with self._queue_cv:
            depths = {ts.tenant: len(ts.queue) for ts in tenants}
            depth, applying = sum(depths.values()), self._applying
        payload = {
            "version": eng.version,
            "snapshot_id": eng.snapshot.snapshot_id,
            "snapshot_age_s": self._snapshot_age_s(eng),
            "uptime_s": round(time.perf_counter() - self._t0_mono, 3),
            "inflight": inflight,
            "endpoints": self.endpoint_latency(),
            "repair_debt": self.debt.snapshot(),
            "query_stages": eng.stage_snapshot(),
            "admission": {
                **self.admission.snapshot(),
                "queue_depth": depth,
                "applying": applying,
                "lof_stale": eng.lof_stale,
            },
            "writer_epoch": self.writer_epoch,
            "delta_stages": self.delta_stage_latency(),
            # result-quality section: the served snapshot's
            # sketches/anomaly rate (+ drift/canary on the writer) and
            # the alert level view — the same payloads /alertz serves
            "quality": self.quality_payload(),
            "alerts": self.alerts.snapshot(),
            # memory plane: RSS + headroom, snapshot vs index
            # byte accounting — the serve-side mirror of the
            # driver's memory_watermark records
            "memory": self.memory_payload(),
            # tenancy: registry view (known tenants +
            # overrides), the packing-oracle memory map (per-tenant
            # snapshot bytes vs the ONE fleet-wide budget), and each
            # tenant's own admission/queue/debt section — the page that
            # names the noisy neighbor
            "tenancy": {
                **self.tenancy.snapshot(),
                "memory": self.tenancy.memory_payload(self._mem_budget),
                "fair_quantum_rows": self._fair_quantum_rows,
                "per_tenant": {
                    ts.tenant: {
                        **ts.admission.snapshot(),
                        "queue_depth": depths.get(ts.tenant, 0),
                        "repair_debt": ts.debt.snapshot(),
                        "version": ts.engine.version,
                    }
                    for ts in tenants
                },
            },
        }
        if self.sink is not None:
            self.sink.emit(
                "slo_rollup",
                uptime_s=payload["uptime_s"],
                endpoints=payload["endpoints"],
                repair_debt=payload["repair_debt"],
                version=payload["version"],
                inflight=inflight,
            )
        return payload

    def metrics_text(self) -> str:
        """Live Prometheus exposition — the same deterministic rendering
        (and the same run_id labels) as the textfile path, served hot.
        Refreshes the graphmine_memory_* gauges on the scrape itself: a
        deployment that only reads /metrics (no prober, nobody on
        /statusz) must not see absent or stale memory accounting."""
        self.memory_payload()
        return self.registry.render_textfile(labels=self._run_labels())

    # -- request middleware hooks -----------------------------------------
    def _inflight_gauge(self):
        return self.registry.gauge(
            "graphmine_serve_inflight_requests",
            "requests currently being handled",
        )

    def request_started(self) -> None:
        # The gauge set stays under _req_lock: two racing updates setting
        # out of order would park the gauge on a stale value forever.
        gauge = self._inflight_gauge()
        with self._req_lock:
            self._inflight += 1
            gauge.set(self._inflight)

    def request_finished(
        self, method: str, endpoint: str, status: int, seconds: float,
        request_id: str, body: bytes = b"", tenant: str = "",
    ) -> None:
        """The middleware tail: histogram observe + counters +
        ``access_log`` record. Runs on every request, including errored
        ones — an SLO page that only counts successes is lying about the
        tail."""
        gauge = self._inflight_gauge()
        with self._req_lock:
            self._inflight -= 1
            gauge.set(self._inflight)
            if status >= 400:
                self._endpoint_errors[endpoint] = (
                    self._endpoint_errors.get(endpoint, 0) + 1
                )
        reg = self.registry
        reg.histogram(
            "graphmine_serve_request_seconds",
            "HTTP request wall time by endpoint",
            endpoint=endpoint,
        ).observe(seconds)
        reg.counter(
            "graphmine_serve_http_requests_total", "HTTP requests handled"
        ).inc()
        if status >= 400:
            reg.counter(
                "graphmine_serve_http_errors_total",
                "HTTP requests answered with a 4xx/5xx status",
            ).inc()
        if self.sink is None:
            return
        kv = {
            "method": method,
            "endpoint": endpoint,
            "status": int(status),
            "seconds": round(seconds, 6),
            "request_id": request_id,
        }
        if tenant and tenant != DEFAULT_TENANT and TENANT_RE.fullmatch(tenant):
            # explicit non-default routing only, and only a well-formed
            # id: a malformed one (answered 400) would make the record
            # fail the schema's tenant grammar
            kv["tenant"] = tenant
        if seconds >= self.slow_request_s:
            # Identify the offending payload without logging it: the
            # digest joins a client-side replay to this exact request.
            kv["slow"] = True
            if body:
                kv["body_sha256"] = hashlib.sha256(body).hexdigest()
                kv["body_bytes"] = len(body)
        self.sink.emit("access_log", **kv)

    # -- query plumbing (shared with serve_cli's in-process mode) ---------
    def vertex_row(self, engine: QueryEngine, v: int) -> dict:
        row = {
            "vertex": int(v),
            "label": engine.membership(v),
            "component": engine.component(v),
            "lof": engine.score(v),
            "community_size": engine.community_size(v),
            "community_decile": engine.community_decile(v),
        }
        if engine.lof_stale:
            # deferred-refresh staleness flag (admission rung 2): the
            # label/component columns are verified-fresh, the LOF score
            # may predate the last few deltas
            row["lof_stale"] = True
        return row

    def record_batch(self, endpoint: str, n: int, seconds: float) -> None:
        if self.sink is not None:
            self.sink.emit(
                "query_batch", endpoint=endpoint, n=int(n),
                seconds=round(seconds, 6),
            )
        self.registry.counter(
            "graphmine_serve_queries_total", "vertex lookups served"
        ).inc(n)


class _Handler(BaseHTTPRequestHandler):
    srv: SnapshotServer  # bound by SnapshotServer.start

    # stdlib default logs every request to stderr; the metrics stream is
    # the intended record of serving traffic (access_log records).
    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def _reply(self, code: int, payload: dict, headers: dict | None = None) -> None:
        body = json.dumps(_jsonable(payload)).encode()
        self._send(code, body, "application/json", headers=headers)

    def _reply_text(self, code: int, text: str, content_type: str) -> None:
        self._send(code, text.encode(), content_type)

    def _send(
        self, code: int, body: bytes, content_type: str,
        headers: dict | None = None,
    ) -> None:
        self._status = code
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        rid = getattr(self, "_request_id", None)
        if rid:
            self.send_header("X-Request-Id", rid)
        self.end_headers()
        self.wfile.write(body)

    def _error(self, code: int, message: str) -> None:
        self._reply(code, {"error": message})

    def _body(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        if length <= 0:
            return {}
        self._raw_body = self.rfile.read(length)
        data = json.loads(self._raw_body.decode())
        if not isinstance(data, dict):
            raise ValueError("request body must be a JSON object")
        return data

    # -- the timing middleware --------------------------------------------
    def _serve(self, method: str, routes: dict) -> None:
        """One wrapper around every request: resolve the handler AND the
        endpoint label from the same route table, stamp/propagate the
        trace id, time the full handle, and ALWAYS run the middleware
        tail — histogram + counters + access_log — even when the handler
        errored (a narrow catch turns bad input into a 400; anything
        else still records as the in-flight 500 before propagating)."""
        url = urlparse(self.path)
        handler = routes.get(url.path)
        endpoint = url.path.lstrip("/") if handler else "unknown"
        rid = self.headers.get("X-Request-Id", "")
        # fullmatch, not match: `$` would accept a trailing newline,
        # and the id is echoed into a response header verbatim.
        if not _REQUEST_ID_RE.fullmatch(rid or ""):
            rid = secrets.token_hex(8)
        self._request_id = rid
        self._status = 500
        self._raw_body = b""
        self._tenant = ""
        self._tenant_explicit = False
        self.srv.request_started()
        # Inherited trace identity (docs/OBSERVABILITY.md "Fleet
        # tracing"): a propagated traceparent header makes this whole
        # request — access_log, admission, wal_append, query_batch,
        # everything emitted on this thread — land in the SENDER's
        # trace (the fleet router's per-request root span). No header,
        # or a malformed one: records stay in this server's run trace,
        # exactly as before.
        ctx = TraceContext.from_header(self.headers.get(TRACE_HEADER, ""))
        span = (
            self.srv.sink.span(
                f"http:{endpoint}", emit=False, annotate=False, remote=ctx,
            )
            if ctx is not None and self.srv.sink is not None
            else contextlib.nullcontext()
        )
        t0 = time.perf_counter()
        with span:
            try:
                if handler is None:
                    self._error(404, f"unknown path {url.path!r}")
                else:
                    getattr(self, handler)(url)
            except UnknownTenantError:
                # valid-but-unknown tenant id: 404, with the SAME body a
                # wrong-tenant vertex miss gets below — the existence of
                # other tenants' data must not be probeable from status
                # or message differences (malformed ids stay 400 via
                # the ValueError arm).
                try:
                    self._error(404, "not found")
                except OSError:
                    self._status = 499
            except (KeyError, ValueError, IndexError) as e:
                code = 400
                if self._tenant_explicit and isinstance(
                    e, (KeyError, IndexError)
                ):
                    # Explicitly tenant-routed lookup miss (a vertex id
                    # that exists in another tenant's graph, or in
                    # none): 404 "not found", indistinguishable from an
                    # unknown tenant. Bad input (ValueError) keeps 400.
                    code = 404
                try:
                    # KeyError.__str__ repr-quotes its message; unwrap it
                    msg = (
                        "not found" if code == 404
                        else (str(e.args[0]) if e.args else str(e))
                    )
                    self._error(code, msg)
                except OSError:
                    self._status = 499  # socket died while sending the 400
            except OSError:
                # The connection died under us (client disconnect
                # mid-write): nothing more can be sent, but the SLO
                # surface must not count an unreceived reply as a served
                # 2xx — record 499 (client closed request), the signal a
                # tail of impatient clients actually leaves.
                self._status = 499
            finally:
                self.srv.request_finished(
                    method, endpoint, self._status,
                    time.perf_counter() - t0, rid, body=self._raw_body,
                    tenant=self._tenant,
                )

    def do_GET(self) -> None:  # noqa: N802
        self._serve("GET", _GET_ROUTES)

    def do_POST(self) -> None:  # noqa: N802
        self._serve("POST", _POST_ROUTES)

    # -- GET routes --------------------------------------------------------
    # Handlers that read result state bind `eng = ...` ONCE: a
    # concurrent snapshot swap must not mix two versions inside one
    # response.

    def _tenant_of(self, url) -> str:
        """The request's tenant routing: ``X-Tenant-Id`` header first
        (what the fleet router forwards), ``?tenant=`` as the curl-able
        fallback. Absent = the default tenant — the pre-tenancy
        contract. The raw value is NOT validated here: the server's
        tenant resolution 400s malformed ids and 404s unknown ones."""
        raw = self.headers.get("X-Tenant-Id", "").strip()
        if not raw:
            vals = parse_qs(url.query).get("tenant")
            raw = vals[0].strip() if vals else ""
        if raw:
            self._tenant_explicit = True
            self._tenant = raw
            return raw
        return DEFAULT_TENANT

    def _pin_ok(self, eng) -> bool:
        """The fleet router's consistency pin: an ``X-Serve-Version``
        header demands the response come from exactly that snapshot
        version. A replica that swapped between the router's pick and
        this handler answers 409 and the router retries elsewhere —
        the mixed-version window closes at the replica, where the swap
        actually happens (the engine is already bound, so the check and
        the response read one version)."""
        want = self.headers.get("X-Serve-Version", "")
        if not want:
            return True
        try:
            want_v = int(want)
        except ValueError:
            return True
        if want_v == eng.version:
            return True
        self._reply(409, {
            "error": "version mismatch",
            "version": eng.version,
            "requested": want_v,
        })
        return False

    def _ep_healthz(self, url) -> None:
        self._reply(200, self.srv.healthz())

    def _ep_statusz(self, url) -> None:
        self._reply(200, self.srv.statusz())

    def _ep_metrics(self, url) -> None:
        self._reply_text(
            200, self.srv.metrics_text(),
            "text/plain; version=0.0.4; charset=utf-8",
        )

    def _ep_snapshot(self, url) -> None:
        eng = self.srv.engine_for(self._tenant_of(url))
        if not self._pin_ok(eng):
            return
        self._reply(200, eng.snapshot.meta)

    def _ep_vertex(self, url) -> None:
        eng = self.srv.engine_for(self._tenant_of(url))
        if not self._pin_ok(eng):
            return
        t0 = time.perf_counter()
        v = int(parse_qs(url.query)["v"][0])
        row = self.srv.vertex_row(eng, v)
        self.srv.record_batch("vertex", 1, time.perf_counter() - t0)
        self._reply(200, row)

    def _ep_explain(self, url) -> None:
        eng = self.srv.engine_for(self._tenant_of(url))
        if not self._pin_ok(eng):
            return
        t0 = time.perf_counter()
        qs = parse_qs(url.query)
        vals = qs.get("vertex") or qs.get("v")
        if not vals:
            raise ValueError("explain needs ?vertex=<id>")
        row = eng.explain(int(vals[0]))
        self.srv.record_batch("explain", 1, time.perf_counter() - t0)
        self._reply(200, row)

    def _ep_alertz(self, url) -> None:
        self._reply(200, self.srv.alertz(self._tenant_of(url)))

    def _ep_neighbors(self, url) -> None:
        eng = self.srv.engine_for(self._tenant_of(url))
        if not self._pin_ok(eng):
            return
        t0 = time.perf_counter()
        v = int(parse_qs(url.query)["v"][0])
        nbrs = eng.neighbors(v)
        self.srv.record_batch("neighbors", 1, time.perf_counter() - t0)
        self._reply(200, {"vertex": v, "neighbors": nbrs})

    def _ep_topk(self, url) -> None:
        eng = self.srv.engine_for(self._tenant_of(url))
        if not self._pin_ok(eng):
            return
        t0 = time.perf_counter()
        qs = parse_qs(url.query)
        community = int(qs["community"][0])
        k = int(qs.get("k", ["10"])[0])
        top = eng.top_outliers(community, k)
        self.srv.record_batch("topk", len(top), time.perf_counter() - t0)
        self._reply(200, {
            "community": community,
            "top": [{"vertex": v, "lof": s} for v, s in top],
        })

    # -- POST routes -------------------------------------------------------
    def _ep_query(self, url) -> None:
        eng = self.srv.engine_for(self._tenant_of(url))
        if not self._pin_ok(eng):
            return
        t0 = time.perf_counter()
        body = self._body()
        out = eng.query_batch(body.get("vertices", []))
        self.srv.record_batch(
            "query", len(out["vertex"]), time.perf_counter() - t0
        )
        payload = {**out, "version": eng.version}
        if eng.lof_stale:
            payload["lof_stale"] = True
        self._reply(200, payload)

    def _ep_delta(self, url) -> None:
        # X-Deadline-Ms: the client's remaining budget narrows the
        # queued-batch deadline.
        deadline_s = None
        raw_ms = self.headers.get("X-Deadline-Ms", "")
        if raw_ms:
            try:
                deadline_s = max(1, int(raw_ms)) / 1000.0
            except ValueError:
                deadline_s = None
        # X-Delta-Id: the client's idempotency key (the JAX server's WAL
        # dedupes on it; here it rides the delta_stages record) — same
        # constrained alphabet as request ids.
        delta_id = self.headers.get("X-Delta-Id", "")
        if delta_id and not _REQUEST_ID_RE.fullmatch(delta_id):
            self._error(
                400, "X-Delta-Id must match [A-Za-z0-9._:-]{1,64}"
            )
            return
        raw_ack = self.headers.get("X-Delta-Ack", "").strip().lower()
        if raw_ack and raw_ack != "wal":
            # an unknown mode must not silently downgrade to the
            # blocking path — the client believes it asked for a fast
            # durable 202 and would block to the full deadline instead
            self._error(
                400, f"unknown X-Delta-Ack mode {raw_ack!r} (use 'wal')"
            )
            return
        ack = raw_ack or None
        tenant = self._tenant_of(url)
        try:
            out = self.srv.apply_delta(
                self._body(), deadline_s=deadline_s,
                delta_id=delta_id or None, ack=ack, tenant=tenant,
            )
        except PublishFencedError as e:
            # The FIRST fenced sync publish surfaces here (the worker
            # latches the write path closed as it raises — every later
            # write gets the front-door shed). Answer the same
            # structured 503 instead of dying with a dropped socket.
            out = self.srv._shed_payload(
                f"writer fenced ({e}): a newer writer owns the store",
                self.srv.admission.bounds.retry_after_s,
            )
        verdict = out.get("verdict")
        if verdict == "shed":
            # the structured refusal: 503 + a Retry-After the client's
            # backoff can obey without parsing the body
            self._reply(503, out, headers={
                "Retry-After": str(
                    max(1, math.ceil(out.get("retry_after_s", 1.0)))
                ),
            })
        else:
            self._reply(200, out)

    def _ep_wal(self, url) -> None:
        qs = parse_qs(url.query)
        from_seq = int(qs.get("from", ["1"])[0])
        limit = min(4096, int(qs.get("limit", ["512"])[0]))
        self._reply(200, self.srv.wal_entries(from_seq, limit=limit))

    def _ep_promote(self, url) -> None:
        self._reply(200, self.srv.promote())

    def _ep_profilez(self, url) -> None:
        body = self._body()
        try:
            duration_ms = int(body.get("duration_ms", 1000))
        except TypeError as e:  # JSON null/list/object: bad input, not 500
            raise ValueError(f"duration_ms must be an integer: {e}") from e
        kind = body.get("kind", "trace")
        if kind not in ("trace", "memory"):
            raise ValueError(f"unknown profilez kind {kind!r} "
                             "(use 'trace' or 'memory')")
        status, payload = self.srv.profilez(
            duration_ms=duration_ms, kind=kind,
        )
        self._reply(status, payload)

    def _ep_reload(self, url) -> None:
        self._reply(200, self.srv.reload(self._tenant_of(url)))

    def _ep_drain(self, url) -> None:
        self._reply(200, self.srv.drain())

    def _ep_undrain(self, url) -> None:
        self._reply(200, self.srv.undrain())
