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
                       (``X-Deadline-Ms`` narrows the queued deadline;
                       ``X-Delta-Id`` is the idempotency key the log
                       dedupes retries on; ``X-Delta-Ack: wal`` answers
                       **202** once the batch is durable in the log
                       instead of blocking to the publish)
``GET  /wal``          ``?from=SEQ&limit=N``: write-ahead-log entries for
                       log shipping (the standby's tail; serve/wal.py);
                       400 without a log
``POST /promote``      standby → writer: fence the store epoch, adopt the
                       newest snapshot, replay the log tail, resume
                       writes
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

Durability and replicated writers: with a
:class:`~graphmine_tpu_torch.serve.wal.WriteAheadLog` attached (``wal=``),
every admission-accepted batch is append-fsync'd before it is acknowledged
or queued, and no CUDA work happens on that path: the apply worker alone
touches the card. Startup replays the accepted-but-unapplied tail through
admission (deduped by ``X-Delta-Id``), and a clean :meth:`stop` resolves
durable queued batches as **202 accepted** (they replay on restart).
Publishes carry ``writer_epoch``; a deposed writer's publish is refused at
the store (``publish_fenced``). A server started with ``standby_of=``
refuses client writes and tails the primary's log instead (a
:class:`~graphmine_tpu_torch.serve.wal.LogShipper` thread on the host);
``/promote`` makes it the writer. ``writer_shards > 1`` (or
``GRAPHMINE_WRITER_SHARDS``) splits the log, admission and repair debt by
vertex range (:mod:`~graphmine_tpu_torch.serve.shardplane`) and publishes
through a two-phase epoch commit; the apply still runs once, on the whole
batch, on the one device.
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
from graphmine_tpu_torch.serve.shardplane import (
    ShardPlan,
    ShardRangeUnavailableError,
    ShardedWritePlane,
    writer_shards_from_env,
)
from graphmine_tpu_torch.serve.snapshot import PublishFencedError, SnapshotStore
from graphmine_tpu_torch.serve.tenancy import (
    DEFAULT_TENANT,
    TENANT_RE,
    TenantRegistry,
    UnknownTenantError,
)
from graphmine_tpu_torch.serve.wal import LogShipper, WriteAheadLog

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
                 "result", "error", "event", "shed_reason", "seq",
                 "delta_id", "async_ack", "trace", "t_accept",
                 "t_durable", "tenant", "shard_seqs")

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
        # Trace identity and the causal-chain stamps: `trace` is the
        # accepting request's propagated traceparent header (durable in
        # the log, so it survives kill/replay and shipping); t_accept and
        # t_durable are monotonic marks of the admission verdict and the
        # log fsync, which the apply worker turns into the per-stage
        # breakdown (`delta_stages` record +
        # graphmine_serve_delta_stage_seconds histograms).
        self.trace = ""
        self.t_accept = time.monotonic()
        self.t_durable: float | None = None
        # Log identity: seq is the batch's durable log position (None = no
        # log on this server), delta_id the client's idempotency key.
        # async_ack batches were answered 202 at append time: nobody
        # waits on the event, and the deadline is inf (a durable
        # acknowledgement is never deadline-shed).
        self.seq: int | None = None
        self.delta_id = ""
        self.async_ack = False
        # Which tenant's sub-queue this batch parks on: its debt, sheds
        # and apply all charge here, never to another tenant's ledger.
        self.tenant = DEFAULT_TENANT
        # Sharded write plane: the {shard: seq} map of every per-range
        # log frame this batch is durable in. None on the single-log (or
        # log-less) path.
        self.shard_seqs: dict | None = None


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
                 "debt", "alerts", "queue", "reserved", "deficit",
                 "quality_report", "plane")

    def __init__(self, tenant: str, store: SnapshotStore):
        self.tenant = tenant
        self.store = store
        self.engine: QueryEngine | None = None
        self.ingestor: DeltaIngestor | None = None
        self.admission: AdmissionController | None = None
        self.debt: RepairDebt | None = None
        self.alerts: AlertManager | None = None
        self.queue: deque = deque()
        self.reserved = 0        # queue slots promised mid-log-append
        self.deficit = 0.0       # DRR balance, in rows
        self.quality_report = None
        # This tenant's vertex-range writer shards and epoch coordinator
        # (serve/shardplane.py); None below writer_shards=2.
        self.plane: ShardedWritePlane | None = None


class SnapshotServer:
    """Query server + delta ingest endpoint over one snapshot store, on
    ``device`` (CUDA unless the caller names another device): the query
    engines' gather tables and every delta repair live there.
    ``num_shards`` > 1 repairs deltas on a mesh of that many shards on
    ``device``; one device holds several only on a virtual mesh
    (``GRAPHMINE_VIRTUAL_DEVICES``), and the mesh is checked here, before
    the server starts."""

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
        ship_interval_s: float = 0.2,
        writer_shards: int | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if int(num_shards) > 1:
            # the sharded repair's mesh (not the sharded write plane):
            # refused here when the device cannot hold that many shards
            from graphmine_tpu_torch.parallel.mesh import device_mesh

            device_mesh(int(num_shards), self.device)
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
        # Chaos seams (testing/faults.py replica_slow / replica_stale):
        # per instance, so one replica of an in-process fleet can be
        # slowed or version-pinned without touching its peers. Production
        # value is the zero/False no-op.
        self.chaos_delay_s = 0.0
        self.chaos_hold_version = False
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
        # The durable write-ahead log. ``wal`` may be a WriteAheadLog, a
        # directory path, or True (= <store>/wal). None keeps the
        # in-memory-only write path.
        if wal is True:
            wal = os.path.join(store.root, "wal")
        if isinstance(wal, str):
            wal = WriteAheadLog(wal, sink=sink, registry=self.registry)
        self.wal: WriteAheadLog | None = wal
        if self.wal is not None:
            if self.wal.sink is None:
                self.wal.sink = sink
            if self.wal.registry is None:
                self.wal.registry = self.registry
        # Vertex-range writer sharding. writer_shards=1 (the default, env
        # GRAPHMINE_WRITER_SHARDS) is the unsharded write path: no plane
        # object exists, every branch below keys off `ts.plane is None`.
        # Above 1, each tenant's namespace gets its own ShardedWritePlane
        # (per-range log + admission + debt) and epoch coordinator; the
        # whole-graph `wal=` and `standby_of=` knobs are mutually
        # exclusive with it (double-logging every batch would make
        # neither log authoritative).
        if writer_shards is None:
            writer_shards = writer_shards_from_env(1)
        self.writer_shards = int(writer_shards)
        if self.writer_shards > 1:
            if self.wal is not None:
                raise ValueError(
                    "writer_shards > 1 owns per-range WALs under "
                    f"{store.root}/shards; drop wal= (the plane logs "
                    "every sub-batch itself)"
                )
            if standby_of is not None:
                raise ValueError(
                    "writer_shards > 1 replicates per range "
                    "(plane.attach_standby), not per process; drop "
                    "standby_of="
                )
        # The epoch this writer stamps on publishes: the store's unless
        # told otherwise (a promotion bumps it via promote()).
        self.writer_epoch = (
            store.current_epoch() if writer_epoch is None
            else int(writer_epoch)
        )
        self.standby_of = standby_of.rstrip("/") if standby_of else None
        self.primary_wal = primary_wal
        self._shipper: LogShipper | None = None
        if self.standby_of is not None:
            if self.wal is None:
                raise ValueError(
                    "a standby needs its own WAL directory to ship the "
                    "primary's log into (pass wal=...)"
                )
            self._shipper = LogShipper(
                self.wal, self.standby_of,
                poll_interval_s=ship_interval_s, sink=sink,
                registry=self.registry,
            )
            # Compaction guard: the shipped watermark describes the
            # primary's store; this standby's own store (a bootstrap
            # copy, possibly old) pins what its log may prune, or a
            # separate-store promotion would rewind into pruned entries.
            self.wal.protect_version = None  # set after the store loads
        snap = store.load(sink=sink)
        if snap is None:
            raise ValueError(
                f"snapshot store at {store.root!r} is empty; publish one "
                "first (pipeline --snapshot-out or serve_cli publish)"
            )
        # The double buffer: _engine is replaced atomically (one reference
        # assignment); handlers bind it to a local once per request.
        self._engine = QueryEngine(snap, device=self.device)
        if self._shipper is not None:
            self.wal.protect_version = snap.version
        if self.writer_shards > 1:
            self._attach_plane(self._tenants[DEFAULT_TENANT], snap)
        # One publisher at a time: the store's generation rotation (and
        # the ingestor's host state) assume it. Held by the apply worker
        # around each apply+swap, and by /reload.
        self._delta_lock = threading.Lock()
        # The bounded apply queues (one sub-queue per tenant, each gated
        # by that tenant's admission bounds) + the one background worker
        # that drains them weighted-fair. Each tenant's `reserved` counts
        # slots promised to batches that are mid-log-append (between the
        # admission verdict and the enqueue) so concurrent submitters
        # can't overshoot max_queue_depth through that window. ONE
        # condition guards every sub-queue.
        self._queue_cv = threading.Condition()
        self._applying = False
        self._worker: threading.Thread | None = None
        self._worker_stop = False
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        # Serializes promote(): a router retry racing a slow promotion
        # (or two operators) must not fence twice and re-enqueue the
        # same pending entries (deltas are not idempotent). _promoted
        # marks a completed promotion so the retry short-circuits.
        self._promote_lock = threading.Lock()
        self._promoted = False
        # Set when a publish came back fenced (the store's epoch moved
        # past ours): this process is a deposed writer. Its publishes
        # refuse forever, so it must stop answering 202 for new deltas;
        # reads keep serving, writes refuse 503 until a later /promote
        # re-fences in this process's favour.
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
        # Startup replay: accepted-but-unapplied log entries re-enqueue
        # through the admission path (replay never sheds: the work was
        # already acknowledged), so a killed writer's restart publishes
        # everything it ever answered 202. Standbys skip it: the primary
        # owns applies until /promote.
        if self.wal is not None and self.standby_of is None:
            # A fresh primary log records its store's current version as
            # the (0, version) baseline pair: the voucher that lets a
            # standby bootstrapped from a copy of this version replay from
            # seq 0 exactly at promotion. Standbys never write it.
            self.wal.note_baseline(snap.version)
            # Reconcile before replaying: a crash between publish and
            # wal.commit leaves the watermark behind the store (replay
            # would double-apply the absorbed entries); a store rollback
            # to .prev leaves it ahead (replay would skip acknowledged
            # work the rollback evicted).
            self._reconcile_wal_cursor(snap, "startup")
            self._replay_wal(source="startup")
        # Sharded-plane startup: converge the epoch store first (a
        # coordinator crash between stage and commit left either a
        # finishable generation or a torn one), then replay each range's
        # accepted-but-unapplied log tail.
        if self.writer_shards > 1:
            self._replay_plane(
                self._tenants[DEFAULT_TENANT], source="startup"
            )

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
        if self._shipper is not None:
            self._shipper.start()
        return self._httpd.server_address[:2]

    def stop(self) -> None:
        if self._shipper is not None:
            self._shipper.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # Drain the apply worker. Durable queued batches are not shed:
        # their acceptance is on disk and they replay on restart, so a
        # clean stop resolves them as **accepted** (202); a 503 here would
        # tell the client to resubmit work the server still owns. Only
        # never-durable entries (no log) shed with the shutdown verdict.
        with self._queue_cv:
            self._worker_stop = True
            leftovers = []
            for ts in list(self._tenants.values()):
                leftovers.extend(ts.queue)
                ts.queue.clear()
            self._rr.clear()
            for p in leftovers:
                if p.seq is not None or p.shard_seqs:
                    p.status = "accepted"
                    p.result = self._accepted_payload(
                        p, note="server stopping; replays on restart",
                    )
                else:
                    p.status = "shed"
                    p.shed_reason = "server shutting down"
            self._queue_cv.notify_all()
        for p in leftovers:
            ts = self._tenants[p.tenant]
            ts.debt.abandoned()
            if p.status == "shed":
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
        if self.wal is not None:
            self.wal.close()
        for ts in list(self._tenants.values()):
            if ts.plane is not None:
                ts.plane.close()

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
        if registered is ts and ts.plane is not None:
            # Replay only after the state is registered: replayed batches
            # park on ts.queue and the worker resolves the tenant through
            # self._tenants. (A lost setdefault race closes the plane we
            # built for nothing.)
            self._replay_plane(ts, source="tenant_admit")
        elif registered is not ts and ts.plane is not None:
            ts.plane.close()
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
        if self.standby_of is None:
            # A writer's lazily-admitted namespace inherits the process
            # fence, so a deposed writer cannot keep publishing there.
            try:
                store.fence_epoch(self.writer_epoch)
            except (OSError, ValueError):
                pass  # equal/lower epochs are already fenced
        if self.writer_shards > 1:
            # Tenancy splits by namespace, the plane splits each
            # namespace's range space: a lazily-admitted tenant gets its
            # own full set of range writers and its own epoch chain.
            self._attach_plane(ts, snap)
        return ts

    def _attach_plane(self, ts: _TenantState, snap) -> None:
        """Build one tenant's sharded write plane over its namespace
        store and converge its epoch directory (finish or sweep a torn
        publish) before anything can read or append. Non-default tenants
        pass registry=None, the rule of their alert manager: the
        per-shard gauge children are keyed by shard alone."""
        plan = ShardPlan.build(
            self.writer_shards, int(len(snap["labels"]))
        )
        ts.plane = ShardedWritePlane(
            ts.store, plan, sink=self._tenant_sink(ts.tenant),
            registry=(
                self.registry if ts.tenant == DEFAULT_TENANT else None
            ),
            tenant=ts.tenant,
            # per-shard ladders inherit the server's envelope: a batch
            # the front ladder admitted must not be re-shed by a shard
            # ladder running tighter defaults than the operator set
            admission_bounds=self.admission.bounds,
        )
        ts.plane.coordinator.recover()
        ts.plane.note_versions(ts.plane.coordinator.version_vector())

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
            # the fleet-facing gauges and the standby compaction guard
            # track the default tenant's chain; per-tenant versions and
            # bytes are served on /healthz + /statusz
            return
        if self.standby_of is not None and self.wal is not None:
            # a standby that reload-followed to a newer store version may
            # release its log retention up to that version's floor
            self.wal.protect_version = engine.version
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
        if self.chaos_hold_version:
            # replica_stale injector: this replica never advances
            return {
                "version": ts.engine.version, "swapped": False,
                "held": True,
            }
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
        below the admission default, never widens it.

        **Durability**: with a log attached, an accepted batch is
        append-fsync'd before it can queue or be acknowledged.
        ``delta_id`` (the ``X-Delta-Id`` header) is the idempotency key:
        a retry of a logged id returns ``verdict: "duplicate"`` instead
        of a second apply. ``ack="wal"`` (the ``X-Delta-Ack: wal``
        header) returns ``verdict: "accepted"`` (HTTP **202**) right
        after the fsync: the batch applies in the background and survives
        a writer kill via startup replay; durable acknowledgements are
        never deadline-shed. Nothing on this path touches the device.

        The batch charges ``tenant``'s ledger end to end: its admission
        bounds, its queue, its debt; the log frame carries the tenant id,
        so replay and the dedupe stay tenant-scoped.
        """
        # Resolve the tenant FIRST: an unknown tenant must 404 before
        # any admission/log side effect, and a malformed id must 400.
        ts = self._tenant_state(tenant)
        tenant = ts.tenant
        if self.standby_of is not None:
            # A standby is not a writer: it tails the primary's log and
            # waits for /promote. Accepting a delta here would be the
            # split-brain the epoch fence exists to prevent.
            return self._shed_payload(
                f"standby of {self.standby_of}: writes go to the primary "
                "(or POST /promote to make this replica the writer)",
                ts.admission.bounds.retry_after_s,
            )
        if self._fenced is not None:
            # Deposed writer: a publish already refused with
            # publish_fenced, so every future apply here would too.
            # Accepting (and fsyncing) more deltas would acknowledge work
            # that can never publish on this store.
            return self._shed_payload(
                f"writer fenced ({self._fenced}): a newer writer owns "
                "the store; send writes to the promoted writer or POST "
                "/promote here to take ownership back",
                ts.admission.bounds.retry_after_s,
            )
        if ack not in (None, "wal"):
            raise ValueError(f"unknown ack mode {ack!r} (use 'wal')")
        if ack == "wal" and self.wal is None and ts.plane is None:
            raise ValueError(
                "X-Delta-Ack: wal needs a server running with a "
                "write-ahead log (serve --wal or --writer-shards)"
            )
        bound = ts.admission.bounds.deadline_s
        deadline_s = bound if deadline_s is None else max(
            0.001, min(float(deadline_s), bound)
        )
        # Fast-path dedupe: a retry of an id this log already holds maps
        # onto the original accept (applied or still pending), never a
        # second apply. Tenant-scoped: two tenants reusing one id are
        # distinct batches.
        if delta_id and self.wal is not None:
            seq = self.wal.lookup(delta_id, tenant=tenant)
            if seq is not None:
                return self._duplicate_payload(delta_id, seq, tenant=tenant)
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
        # sink's record writes (potentially a disk fsync each) happen
        # after release. `reserved` holds this batch's queue slot across
        # the out-of-lock log fsync below, so concurrent submitters can't
        # resolve their way past max_queue_depth through that window.
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
                rows=rows, queue_depth=len(ts.queue) + ts.reserved,
                debt=debt_at_resolve, applying=self._applying, emit=False,
            )
            if decision.verdict != "shed":
                ts.reserved += 1
        if decision.verdict == "shed":
            ts.admission.emit_admission(decision, debt_at_resolve)
            ts.debt.shed(rows)
            ts.admission.record_shed(
                decision.reason, rows, decision.queue_depth,
                ts.debt.snapshot(),
            )
            return self._shed_payload(decision.reason, decision.retry_after_s)
        # Durability point: the fsync'd append happens before the batch
        # can queue, so from here on a kill replays it on restart and the
        # acknowledgement below never lies.
        pending = _PendingDelta(delta, rows, 0.0, deadline_s)
        pending.delta_id = delta_id or ""
        pending.async_ack = ack == "wal"
        pending.trace = self._current_trace_header()
        pending.tenant = tenant
        try:
            if ts.plane is not None:
                # Sharded plane: the plane splits the batch by dst-range
                # ownership, runs each owner shard's admission ladder,
                # dedupes (delta_id, shard) per shard, and fsyncs one
                # sub-batch per touched range. The batch queues with the
                # original unsplit delta: the apply splices exactly what
                # a single-log server would.
                try:
                    sub = ts.plane.submit(
                        delta, delta_id=delta_id or "",
                        deadline_s=deadline_s,
                        queue_depth=decision.queue_depth,
                        applying=self._applying, trace=pending.trace,
                    )
                except ShardRangeUnavailableError as exc:
                    ts.admission.emit_admission(decision, debt_at_resolve)
                    ts.debt.shed(rows)
                    ts.admission.record_shed(
                        str(exc), rows, decision.queue_depth,
                        ts.debt.snapshot(),
                    )
                    return self._shed_payload(
                        str(exc), ts.admission.bounds.retry_after_s
                    )
                if sub["verdict"] == "duplicate":
                    ts.admission.emit_admission(decision, debt_at_resolve)
                    return self._duplicate_plane_payload(
                        ts, delta_id or "", sub
                    )
                if sub["verdict"] == "shed":
                    ts.admission.emit_admission(decision, debt_at_resolve)
                    ts.debt.shed(rows)
                    return self._shed_payload(
                        sub["reason"], sub["retry_after_s"]
                    )
                pending.shard_seqs = sub["shard_seqs"]
                pending.t_durable = time.monotonic()
            elif self.wal is not None:
                seq, dup = self.wal.append(
                    payload, delta_id=delta_id or "", deadline_s=deadline_s,
                    trace=pending.trace, tenant=tenant,
                )
                if dup:
                    # one admission record per resolve, duplicate or not
                    # (the finally below releases the reserved slot)
                    ts.admission.emit_admission(decision, debt_at_resolve)
                    return self._duplicate_payload(
                        delta_id or "", seq, tenant=tenant,
                    )
                pending.seq = seq
                pending.t_durable = time.monotonic()
        finally:
            enqueued = False
            with self._queue_cv:
                ts.reserved = max(0, ts.reserved - 1)
                # In plane mode, only a plane-accepted batch (shard_seqs
                # set) may queue: a plane shed/duplicate/refusal
                # returning through this finally must not enqueue work
                # the client was just told is not pending.
                durable_ok = (
                    pending.shard_seqs is not None
                    if ts.plane is not None
                    else (pending.seq is not None or self.wal is None)
                )
                if not self._worker_stop and durable_ok:
                    if pending.status == "queued":
                        # durable acknowledgements never deadline-shed;
                        # sync callers keep the client's budget
                        pending.deadline = (
                            math.inf if pending.async_ack
                            else time.monotonic() + deadline_s
                        )
                        # Debt accrues at ACCEPTANCE: batches parked on
                        # the apply queue are pending work the ledger
                        # (and /healthz) must already see; it is exactly
                        # what the shed bound reads.
                        ts.debt.submitted(rows)
                        ts.queue.append(pending)
                        if tenant not in self._rr:
                            self._rr.append(tenant)
                        self._queue_cv.notify_all()
                        enqueued = True
                elif self._worker_stop and (
                    pending.seq is not None or pending.shard_seqs
                ):
                    # stop() won the race after the append: the batch is
                    # durable and replays on restart (acknowledged, not
                    # shed)
                    pending.status = "accepted"
                    pending.result = self._accepted_payload(
                        pending,
                        note="server stopping; replays on restart",
                    )
        ts.admission.emit_admission(decision, debt_at_resolve)
        if not enqueued:
            if pending.status == "accepted":
                return pending.result
            return self._shed_payload(
                "server shutting down", ts.admission.bounds.retry_after_s
            )
        self._ensure_worker()
        if pending.async_ack:
            # the 202 path: durable in the log IS the acknowledgement
            return self._accepted_payload(pending)

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
            self._skip_walled(pending)
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
        if pending.status in ("done", "accepted"):
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

    def _accepted_payload(self, pending: _PendingDelta, note: str = "") -> dict:
        """The 202 body: durable in the log, not yet in a published
        snapshot."""
        out = {
            "verdict": "accepted",
            "applied": False,
            "durable": (
                pending.seq is not None or bool(pending.shard_seqs)
            ),
            "seq": pending.seq,
            "delta_id": pending.delta_id,
        }
        if pending.shard_seqs:
            out["shard_seqs"] = {
                str(k): int(v) for k, v in pending.shard_seqs.items()
            }
        if note:
            out["note"] = note
        return out

    def _duplicate_plane_payload(
        self, ts: _TenantState, delta_id: str, sub: dict,
    ) -> dict:
        """A retried key every touched shard already holds maps onto the
        original accept (the per-shard twin of _duplicate_payload)."""
        applied = bool(sub.get("applied"))
        out = {
            "verdict": "duplicate",
            "delta_id": delta_id,
            "shard_seqs": {
                str(k): int(v) for k, v in sub["shard_seqs"].items()
            },
            "applied": applied,
        }
        if applied:
            out["version"] = ts.engine.version
        return out

    def _duplicate_payload(
        self, delta_id: str, seq: int, tenant: str = DEFAULT_TENANT,
    ) -> dict:
        """A retried idempotency key maps onto its original accept."""
        applied = self.wal.seq_applied(seq)
        out = {
            "verdict": "duplicate",
            "delta_id": delta_id,
            "seq": int(seq),
            "applied": applied,
        }
        if applied:
            out["version"] = self.engine_for(tenant).version
            out["applied_version"] = self.wal.applied_version
        return out

    def _skip_walled(self, pending: _PendingDelta) -> None:
        """Tombstone a durable batch that was shed off the queue so a
        later replay can't resurrect work the client was told is NOT
        applied (its retry still dedupes-by-id into a fresh accept)."""
        if pending.shard_seqs:
            ts = self._tenants.get(pending.tenant)
            if ts is not None and ts.plane is not None:
                ts.plane.skip(pending.shard_seqs)
            return
        if pending.seq is None or self.wal is None:
            return
        try:
            self.wal.skip(pending.seq)
        except OSError:
            pass  # tombstone is best-effort; dedupe bounds the damage

    # -- WAL replay / log shipping / promotion ----------------------------
    def _replay_wal(self, source: str = "startup") -> int:
        """Re-enqueue every accepted-but-unapplied log entry through the
        admission path (``replay=True``: acknowledged work is never
        shed), as async batches nobody waits on. The pending entries
        coalesce into the apply worker's next group, so a replay is one
        real apply on the device. Returns the count."""
        entries = self.wal.pending()
        if not entries:
            return 0
        n = 0
        for e in entries:
            payload = e.get("payload") or {}
            try:
                delta = EdgeDelta.from_pairs(
                    insert=payload.get("insert", ()),
                    delete=payload.get("delete", ()),
                )
            except ValueError:
                continue  # the accept path parsed it once; be defensive
            # Route the entry back to the tenant whose frame it is; a
            # frame naming a tenant whose namespace vanished is skipped
            # loudly rather than misapplied.
            entry_tenant = e.get("tenant") or DEFAULT_TENANT
            try:
                ts = self._tenant_state(entry_tenant)
            except (UnknownTenantError, ValueError):
                self._warn(
                    f"wal replay ({source}): seq {e.get('seq')} names "
                    f"tenant {entry_tenant!r} with no store namespace — "
                    "skipping (the tenant's snapshot chain is gone)"
                )
                continue
            rows = delta.num_inserts + delta.num_deletes
            with self._queue_cv:
                if self._worker_stop:
                    break
                debt_at = ts.debt.snapshot()
                decision = ts.admission.resolve(
                    rows=rows,
                    queue_depth=len(ts.queue) + ts.reserved,
                    debt=debt_at, applying=self._applying, emit=False,
                    replay=True,
                )
                ts.debt.submitted(rows)
                p = _PendingDelta(delta, rows, math.inf, float(
                    e.get("deadline_s") or ts.admission.bounds.deadline_s
                ))
                p.seq = int(e["seq"])
                p.delta_id = e.get("id", "")
                p.async_ack = True
                p.tenant = ts.tenant
                # replayed entries keep their originating request's
                # trace: the durable header re-adopts across the kill
                # (or across a promotion, via the shipped copy)
                p.trace = e.get("trace", "")
                p.t_durable = p.t_accept
                ts.queue.append(p)
                if ts.tenant not in self._rr:
                    self._rr.append(ts.tenant)
                self._queue_cv.notify_all()
            ts.admission.emit_admission(decision, debt_at)
            n += 1
        if self.sink is not None:
            self.sink.emit(
                "wal_replay", entries=n, from_seq=int(entries[0]["seq"]),
                to_seq=int(entries[-1]["seq"]), source=source,
            )
        if n:
            self._ensure_worker()
        return n

    def _replay_plane(self, ts: _TenantState, source: str = "startup") -> int:
        """Per-range log replay: each shard's accepted-but-unapplied
        sub-batches re-enqueue as independent async batches. Applying
        the sub-batches separately equals the original whole-batch apply
        (disjoint dst ranges mean disjoint delete keys, so the per-shard
        applies commute). Each replayed batch carries exactly its own
        ``{shard: seq}`` pair, so the commit after its publish advances
        only that range's log."""
        n, lo_seq, hi_seq = 0, None, 0
        for ws in ts.plane.shards:
            if ws.read_only:
                continue
            for e in ws.wal.pending():
                payload = e.get("payload") or {}
                try:
                    delta = EdgeDelta.from_pairs(
                        insert=payload.get("insert", ()),
                        delete=payload.get("delete", ()),
                    )
                except ValueError:
                    continue  # the accept path parsed it once
                rows = delta.num_inserts + delta.num_deletes
                with self._queue_cv:
                    if self._worker_stop:
                        break
                    debt_at = ws.debt.snapshot()
                    decision = ws.admission.resolve(
                        rows=rows,
                        queue_depth=len(ts.queue) + ts.reserved,
                        debt=debt_at, applying=self._applying,
                        emit=False, replay=True,
                    )
                    ws.debt.submitted(rows)
                    ts.debt.submitted(rows)
                    p = _PendingDelta(delta, rows, math.inf, float(
                        e.get("deadline_s")
                        or ts.admission.bounds.deadline_s
                    ))
                    p.shard_seqs = {ws.shard: int(e["seq"])}
                    p.delta_id = e.get("id", "")
                    p.async_ack = True
                    p.tenant = ts.tenant
                    p.trace = e.get("trace", "")
                    p.t_durable = p.t_accept
                    ts.queue.append(p)
                    if ts.tenant not in self._rr:
                        self._rr.append(ts.tenant)
                    self._queue_cv.notify_all()
                ws.admission.emit_admission(decision, debt_at)
                seq = int(e["seq"])
                lo_seq = seq if lo_seq is None else min(lo_seq, seq)
                hi_seq = max(hi_seq, seq)
                n += 1
        if n and self.sink is not None:
            self.sink.emit(
                "wal_replay", entries=n, from_seq=int(lo_seq),
                to_seq=int(hi_seq), source=source, tenant=ts.tenant,
                shards=ts.plane.plan.num_shards,
            )
        if n:
            self._ensure_worker()
        return n

    def wal_entries(self, from_seq: int, limit: int = 512) -> dict:
        """The ``GET /wal`` body: the log-shipping feed the standby's
        :class:`~graphmine_tpu_torch.serve.wal.LogShipper` tails."""
        if self.wal is None:
            raise ValueError(
                "this server runs without a write-ahead log (serve --wal)"
            )
        return {
            "entries": self.wal.entries(max(0, int(from_seq)),
                                        limit=max(1, int(limit))),
            "last_seq": self.wal.last_seq,
            "applied_seq": self.wal.applied_seq,
            "applied_version": self.wal.applied_version,
            "history": self.wal.commit_history(),
            "epoch": self.writer_epoch,
        }

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

    def _rewind_wal(self, floor: int, snap, context: str) -> None:
        oldest = self.wal.oldest_retained_seq()
        if oldest is not None and floor + 1 < oldest:
            self._warn(
                f"{context}: rewind to seq {floor} reaches below the "
                f"compaction horizon (oldest retained seq {oldest}): "
                f"entries {floor + 1}..{oldest - 1} were pruned here "
                "and cannot replay — acknowledged-delta loss past the "
                "shipped lag"
            )
        self._warn(
            f"{context}: adopted snapshot v{snap.version} is behind the "
            f"WAL watermark (seq {self.wal.applied_seq}, "
            f"v{self.wal.applied_version}): rewinding the replay cursor "
            f"to seq {floor} so durable-but-unapplied entries replay"
        )
        self.wal.rewind(floor, snap.version)

    def _reconcile_wal_cursor(self, snap, context: str) -> None:
        """Place the log's replay cursor to match the store state
        actually adopted. The watermark is a claim about this store, and
        three windows can break it: a crash between publish and commit
        (store ahead), a store rollback to ``.prev`` (store behind), and
        a separate-store standby whose mirrored watermark describes the
        primary's store. Voucher priority: the manifest's own
        ``wal_applied_seq`` (stamped at publish, exact), then the
        watermark-history pair recorded at the adopted version, then a
        loud refusal to guess (deltas are not idempotent). An entry-less
        log skips: there is nothing to replay."""
        if self.wal.last_seq == 0:
            return
        # Publish-time vouchers from every tenant namespace: the
        # watermark is one cursor over an interleaved multi-tenant log,
        # advanced by whichever tenant published last, so the default
        # manifest's voucher alone can lag a later non-default publish.
        # The max voucher wins; every manifest's absorbed-above list is
        # excluded from replay.
        vouchers = []  # (seq, version-at-that-publish, absorbed-above)
        voucher = snap.meta.get("wal_applied_seq")
        if voucher is not None:
            vouchers.append((
                int(voucher), snap.version,
                tuple(snap.meta.get("wal_applied_above") or ()),
            ))
        for tid in self.store.list_tenants():
            if tid == self.store.tenant:
                continue  # the adopted snap already vouched above
            man = self.store.for_tenant(tid)._peek_manifest()
            if not man:
                continue
            mv = man.get("wal_applied_seq")
            if mv is None:
                continue
            try:
                ver = int(man.get("version", 0))
            except (TypeError, ValueError):
                ver = 0
            vouchers.append((
                int(mv), ver, tuple(man.get("wal_applied_above") or ()),
            ))
        if vouchers:
            best_seq, best_ver, _ = max(vouchers)
            if best_seq > self.wal.applied_seq:
                # publish landed, its wal.commit was lost to the crash:
                # move the cursor forward so replay can't double-apply
                self.wal.commit(best_seq, best_ver)
            elif best_seq < self.wal.applied_seq:
                self._rewind_wal(best_seq, snap, context)
            for _, ver, above in vouchers:
                if above:
                    # entries a snapshot absorbed above the contiguous
                    # floor (published over a then-unresolved gap):
                    # exclude them from replay the same crash-safe way
                    self.wal.commit_applied(above, ver)
            return
        if self.wal.applied_version > snap.version:
            floor = self.wal.replay_floor(snap.version)
            if floor is not None:
                self._rewind_wal(floor, snap, context)
            else:
                self._warn(
                    f"{context}: adopted snapshot v{snap.version} is "
                    "behind the WAL watermark "
                    f"(v{self.wal.applied_version}) and no retained "
                    "watermark pair vouches for it — the replay cursor "
                    "cannot be placed exactly; continuing from the "
                    "watermark. Loss bound exceeds the shipped lag: "
                    "re-bootstrap this standby from a fresher copy (or "
                    "run the shared-store deployment)"
                )

    def promote(self) -> dict:
        """Standby → writer: (1) a final ship pass, catching up from the
        primary's ``/wal`` if it still answers, then copying the
        un-shipped tail straight from its log directory when reachable
        (the shared-store deployment: a same-filesystem writer kill loses
        nothing; without shared storage the loss bound is the shipped
        lag); (2) **fence the epoch** durably at the store, so the
        deposed writer's publishes refuse with ``publish_fenced``; (3)
        adopt the newest published snapshot; (4) replay the log tail
        through admission (one apply on the device); (5) resume writes.
        Emits one ``writer_promote`` record.

        Serialized and idempotent: concurrent calls queue on the lock,
        and a call landing after the promotion completed answers
        ``promoted: false, already_writer: true`` with the live epoch
        instead of fencing again and re-enqueuing the same entries."""
        if self.wal is None:
            raise ValueError(
                "promote needs a write-ahead log (serve --wal)"
            )
        with self._promote_lock:
            return self._promote_locked()

    def _promote_locked(self) -> dict:
        if self._promoted:
            # This process already completed a promotion: the caller is
            # a retry of it. A plain writer that never promoted does not
            # short-circuit: an explicit /promote on it is a fence
            # request (the epoch bump cuts off a suspected zombie).
            return {
                "promoted": False,
                "already_writer": True,
                "epoch": self.writer_epoch,
                "version": self._engine.version,
                "replayed": 0,
                "copied_tail": 0,
            }
        t0 = time.perf_counter()
        if self._shipper is not None:
            try:
                self._shipper.poll_once()  # final catch-up, best effort
            except Exception:  # noqa: BLE001 — primary usually dead here
                pass
            self._shipper.stop()
        copied = 0
        if self.primary_wal and os.path.isdir(self.primary_wal):
            try:
                # read_only: the primary may be a partitioned-but-alive
                # zombie sharing this storage; a writable open's scan
                # would truncate its in-flight append as a torn tail.
                foreign = WriteAheadLog(self.primary_wal, read_only=True)
                copied = self.wal.copy_from(
                    foreign.entries(self.wal.last_seq + 1)
                )
                self.wal.merge_history(foreign.commit_history())
                foreign.close()
            except Exception as e:  # noqa: BLE001 — promote must proceed
                self._warn(
                    "promotion could not read the deposed "
                    f"primary's WAL at {self.primary_wal!r}: {e!r}"
                    " — continuing from the shipped copy (loss "
                    "bound = replication lag)"
                )
        # Mint-and-fence atomically: composing current_epoch() + 1 with
        # fence_epoch would let two concurrent promotions fence the same
        # epoch and both pass the store's fence.
        new_epoch = self.store.advance_epoch(
            sink=None,
            reason=f"standby promotion (was standby of {self.standby_of})",
        )
        was = self.standby_of or ""
        self.standby_of = None
        self.writer_epoch = new_epoch
        # The fence is now in our favour: a previously-deposed writer
        # taking ownership back resumes accepting writes.
        self._fenced = None
        # Every tenant namespace inherits the new fence and adopts its
        # newest published snapshot: the deposed writer loses all
        # tenants at once. Namespaces this process never served are
        # fenced lazily on first touch (_make_tenant_state).
        with self._delta_lock:
            for ts in list(self._tenants.values()):
                if ts.tenant != DEFAULT_TENANT:
                    try:
                        ts.store.fence_epoch(new_epoch)
                    except (OSError, ValueError):
                        pass  # already at/above: fence holds
                fresh_t = ts.store.load(sink=self.sink)
                if fresh_t is not None and fresh_t.version != ts.engine.version:
                    self._swap(
                        QueryEngine(fresh_t, device=self.device),
                        tenant=ts.tenant,
                    )
                ts.ingestor = None
            fresh = self._engine.snapshot
        self._reconcile_wal_cursor(fresh, "promotion")
        replayed = self._replay_wal(source="promotion")
        # Now the primary: local commits describe this store, so the
        # standby-era compaction guard lifts.
        self.wal.protect_version = None
        self._promoted = True
        seconds = round(time.perf_counter() - t0, 3)
        if self.sink is not None:
            self.sink.emit(
                "writer_promote", epoch=new_epoch, replayed=replayed,
                copied_tail=copied, version=self._engine.version,
                was_standby_of=was, seconds=seconds,
            )
        return {
            "promoted": True,
            "epoch": new_epoch,
            "replayed": replayed,
            "copied_tail": copied,
            "version": self._engine.version,
            "was_standby_of": was,
            "seconds": seconds,
        }

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
                    self._skip_walled(p)
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
                    # serving). Latched until a /promote re-fences the
                    # epoch in this process's favour.
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
                # The manifest voucher must survive a crash between this
                # publish and the wal.commit below (restart replay of
                # absorbed entries would double-apply). It cannot be the
                # group's max seq: appends fsync outside the queue lock,
                # so an acked lower seq can still be racing toward the
                # queue while this group publishes. Stamp the contiguous
                # floor the log would reach plus the resolved seqs parked
                # above it (wal_applied_above); replay excludes exactly
                # those.
                seqs = [p.seq for p in group if p.seq is not None]
                if seqs and self.wal is not None:
                    floor, above = self.wal.preview_commit(seqs)
                    extra = {
                        "wal_applied_seq": floor,
                        "wal_applied_above": above,
                    }
                else:
                    extra = None
                snap = ing.apply(
                    merged, lof_mode=lof_mode, batches=len(group),
                    extra_meta=extra,
                )
            except BaseException:
                if ts.debt.applies_total == settled_before:
                    for _ in group:
                        ts.debt.abandoned()
                raise
            # The next engine is built whole (its device table copied
            # and synchronized) before the one-reference swap.
            self._swap(QueryEngine(snap, device=self.device), tenant=tenant)
            if self.wal is not None and seqs:
                # Compaction keyed to the published snapshot version:
                # commit_applied advances the watermark only over the
                # contiguous resolved run.
                self.wal.commit_applied(seqs, snap.version)
            if ts.plane is not None:
                # Sharded plane: advance each touched range's log
                # watermark, then two-phase-publish the epoch (stage
                # every range's arrays, durably commit epoch → version
                # vector). A multi-range group becomes visible whole or,
                # on a torn commit, not at all.
                merged_seqs: dict[int, list] = {}
                for p in group:
                    for s, q in (p.shard_seqs or {}).items():
                        merged_seqs.setdefault(int(s), []).append(int(q))
                if merged_seqs:
                    ts.plane.commit_applied(merged_seqs, snap.version)
                self._publish_epoch(ts, snap)
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

    def _publish_epoch(self, ts: _TenantState, snap) -> int:
        """Stage and commit the next publish epoch (two-phase): each
        range's slice of the per-vertex result arrays lands in its own
        shard directory, then the coordinator durably commits epoch →
        version vector under the store's fence lock. Growth rows
        (vertices born past the plan) ride with the last range, the
        splitter's ownership rule."""
        plane = ts.plane
        labels = np.asarray(snap["labels"])
        lof = snap.get("lof")
        n = len(labels)
        shard_arrays: dict[int, dict] = {}
        versions: dict[int, int] = {}
        last = plane.plan.num_shards - 1
        for ws in plane.shards:
            lo = min(ws.lo, n)
            hi = n if ws.shard == last else min(ws.hi, n)
            arrs = {"labels": labels[lo:hi]}
            if lof is not None:
                arrs["lof"] = np.asarray(lof)[lo:hi]
            shard_arrays[ws.shard] = arrs
            versions[ws.shard] = int(ws.version)
        epoch = plane.coordinator.committed_epoch() + 1
        plane.coordinator.stage(epoch, shard_arrays, versions=versions)
        plane.coordinator.commit(epoch, plane.version_vector())
        return epoch

    # -- per-delta time-to-visible stages ---------------------------------
    def _emit_delta_stages(self, group: list, snap, t_apply_start: float):
        """The writer-side causal chain of every batch this publish
        absorbed: admission accept → log fsync → queued → apply →
        published, observed into per-stage histograms
        (``graphmine_serve_delta_stage_seconds{stage=...}``, the
        ``/statusz`` breakdown) and emitted as one ``delta_stages``
        record per batch IN THAT BATCH's trace — telemetry only, so a
        failure here must never fail a publish that already landed."""
        t_done = time.monotonic()
        try:
            for p in group:
                stages = {}
                if p.t_durable is not None:
                    stages["wal_fsync_s"] = round(
                        max(0.0, p.t_durable - p.t_accept), 6
                    )
                stages["queued_s"] = round(
                    max(0.0, t_apply_start - (p.t_durable or p.t_accept)), 6
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
                        stage=stage[:-2],  # wal_fsync_s -> wal_fsync
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
                        seq=p.seq,
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
        if self.standby_of is not None:
            out["standby"] = True
            out["standby_of"] = self.standby_of
            if self._shipper is not None:
                ship = self._shipper.snapshot()
                # the replication-lag pair: entries behind, seconds behind
                out["replication_lag_entries"] = ship["lag_entries"]
                out["replication_lag_s"] = ship["lag_s"]
        if self.wal is not None:
            out["wal"] = self.wal.snapshot()
        dts = self._tenants[DEFAULT_TENANT]
        if dts.plane is not None:
            # Sharded-plane probe surface: the committed epoch and the
            # per-range version vector (the router's /healthz aggregates
            # these, and the prober's mixed-epoch guard keys off them).
            out["writer_shards"] = self.writer_shards
            out["epoch"] = dts.plane.coordinator.committed_epoch()
            out["shard_versions"] = {
                str(k): int(v)
                for k, v in dts.plane.version_vector().items()
            }
            degraded = [
                ws.shard for ws in dts.plane.shards if ws.read_only
            ]
            if degraded:
                out["degraded_shards"] = degraded
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
        snapshot's array bytes vs the derived query index, and the
        retained log segment bytes: byte accounting for everything this
        process deliberately holds, so "RSS grew" decomposes into which
        plane grew. Updated on the cadences that already read it
        (/statusz, and /healthz through the alert values — the prober
        cadence); no new threads."""
        out = host_memory(self._mem_budget)
        eng = self._engine
        out.update(eng.memory_bytes())
        if self.wal is not None:
            out["wal_segment_bytes"] = int(
                self.wal.snapshot().get("segment_bytes", 0)
            )
        if self.device.type == "cuda":
            # the caching allocator's counters (host-side, no sync): what
            # this process holds on the card, beside nvidia-smi's view
            import torch

            out["device_bytes_in_use"] = int(
                torch.cuda.memory_allocated(self.device)
            )
            out["device_peak_bytes"] = int(
                torch.cuda.max_memory_allocated(self.device)
            )
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
        if self.wal is not None:
            payload["wal"] = self.wal.snapshot()
        dts = self._tenants[DEFAULT_TENANT]
        if dts.plane is not None:
            # per-shard log/admission/debt children: one entry per
            # shard, mirroring the per-shard gauge children on /metrics
            payload["shardplane"] = dts.plane.snapshot()
        if self._shipper is not None:
            payload["replication"] = self._shipper.snapshot()
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
        chaos = self.srv.chaos_delay_s
        if chaos > 0:
            time.sleep(chaos)  # replica_slow injector (testing/faults.py)
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
        # X-Delta-Id: the client's idempotency key, the same constrained
        # alphabet as request ids (it lands in records and response
        # bodies verbatim).
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
        elif verdict == "accepted":
            # durable in the log, not yet published: the honest 202
            self._reply(202, out)
        elif verdict == "duplicate":
            self._reply(200 if out.get("applied") else 202, out)
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
