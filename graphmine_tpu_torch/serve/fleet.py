"""Replicated serving fleet: a front-tier router over N snapshot replicas.

Counterpart of ``graphmine_tpu/serve/fleet.py``, whole, with the same
replica states, breaker states, headers, status codes, records and metric
names. On one card every replica is its own process with its own CUDA
context; the router is host code and never initialises CUDA, so a router
process on the card's host holds no device context.

- :class:`ReplicaSet`: per-replica state machine (``joining`` →
  ``healthy`` → ``degraded`` → ``draining`` → ``down``) driven by a
  background prober reading the replicas' ``/healthz`` fields (``ready``,
  ``version``, ``overloaded``, ``snapshot_age_s``, ``lof_stale``), plus
  the fleet's **committed version**: the max snapshot version held by a
  read quorum, monotonic by construction.
- **Consistent-version routing**: reads route only to replicas at the
  committed version. Every response echoes ``X-Pinned-Version``; a
  replica that swapped mid-flight answers 409 to the router's
  ``X-Serve-Version`` pin and the router retries elsewhere, so one
  request never observes mixed versions.
- **Per-replica circuit breakers**: an error/timeout-rate threshold opens
  the breaker, a decorrelated-jitter backoff
  (:func:`~graphmine_tpu_torch.pipeline.resilience.backoff_s`) schedules a
  half-open single probe, and one clean probe closes it. Cross-replica
  retry is bounded by the propagated request deadline (``X-Deadline-Ms``);
  when no replica is eligible the router answers **503 + Retry-After**.
- **Single-writer forwarding**: POST ``/delta`` and ``/reload`` forward
  to the designated writer replica. Writer loss degrades the fleet to
  read-only with a loud ``fleet_degraded`` record, never a second
  concurrent writer; the same writer coming back restores writes.
- **Fenced failover onto a log-shipped standby**: with a ``standby``
  replica configured (one running ``standby_of=<writer url>``), the
  prober detects writer DOWN, POSTs the standby's ``/promote`` (fence the
  store epoch, replay the log tail, resume writes) and re-points write
  forwarding at it, every step a ``writer_promote`` record. The deposed
  writer's comeback publish is refused at the store by the epoch fence.
- **Zero-downtime rolling reload**: :meth:`FleetRouter.rolling_reload`
  drains one replica at a time, POSTs ``/reload``, re-probes until it is
  ready at the new version and rejoins it, aborting if draining would
  drop the fleet below ``min_healthy``. The writer rolls last.

Every router decision emits a schema-registered record
(``replica_health``, ``breaker_transition``, ``fleet_route``,
``fleet_degraded``). The chaos injectors of ``testing/faults.py``
(``replica_kill``, ``replica_slow``, ``replica_stale``) drive it in tests.
All router logic is stdlib plus the port's host-side modules: no device
work on any router path.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib import error as urlerror
from urllib import request as urlrequest
from urllib.parse import urlparse

from graphmine_tpu_torch.obs.histogram import Histogram
from graphmine_tpu_torch.obs.memmodel import (
    export_memory_gauges,
    host_memory,
    serve_mem_budget_bytes,
)
from graphmine_tpu_torch.obs.registry import Registry
from graphmine_tpu_torch.obs.sketch import QuantileSketch
from graphmine_tpu_torch.obs.spans import (
    TRACE_HEADER,
    TraceContext,
    sink_trace_header,
)
from graphmine_tpu_torch.pipeline.resilience import ResilienceConfig, backoff_s

# Replica states (the per-replica machine the prober drives).
JOINING = "joining"      # known but not yet confirmed ready at a version
HEALTHY = "healthy"      # probed ok, ready, read-eligible
DEGRADED = "degraded"    # probed ok but flagged (not ready / overloaded /
#                          breaker open) — still read-eligible as a last
#                          resort, preferred below healthy replicas
DRAINING = "draining"    # receiving no new reads (rolling reload owns it)
DOWN = "down"            # consecutive probe failures; not routable

# Breaker states.
BREAKER_CLOSED = "closed"
BREAKER_OPEN = "open"
BREAKER_HALF_OPEN = "half_open"

_ENV = {
    "probe_interval_s": ("GRAPHMINE_FLEET_PROBE_INTERVAL_S", float),
    "probe_timeout_s": ("GRAPHMINE_FLEET_PROBE_TIMEOUT_S", float),
    "read_timeout_s": ("GRAPHMINE_FLEET_READ_TIMEOUT_S", float),
    "write_timeout_s": ("GRAPHMINE_FLEET_WRITE_TIMEOUT_S", float),
    "default_deadline_ms": ("GRAPHMINE_FLEET_DEFAULT_DEADLINE_MS", int),
    "retry_after_s": ("GRAPHMINE_FLEET_RETRY_AFTER_S", float),
    "down_after_probes": ("GRAPHMINE_FLEET_DOWN_AFTER_PROBES", int),
    "min_healthy": ("GRAPHMINE_FLEET_MIN_HEALTHY", int),
    "quorum": ("GRAPHMINE_FLEET_QUORUM", int),
    "reload_cadence_s": ("GRAPHMINE_FLEET_RELOAD_CADENCE_S", float),
    "reload_timeout_s": ("GRAPHMINE_FLEET_RELOAD_TIMEOUT_S", float),
    "rejoin_timeout_s": ("GRAPHMINE_FLEET_REJOIN_TIMEOUT_S", float),
    "drain_grace_s": ("GRAPHMINE_FLEET_DRAIN_GRACE_S", float),
    "breaker_window": ("GRAPHMINE_FLEET_BREAKER_WINDOW", int),
    "breaker_open_failures": ("GRAPHMINE_FLEET_BREAKER_OPEN_FAILURES", int),
    "breaker_open_rate": ("GRAPHMINE_FLEET_BREAKER_OPEN_RATE", float),
    "breaker_backoff_base_s": ("GRAPHMINE_FLEET_BREAKER_BACKOFF_BASE_S", float),
    "breaker_backoff_max_s": ("GRAPHMINE_FLEET_BREAKER_BACKOFF_MAX_S", float),
    "promote_timeout_s": ("GRAPHMINE_FLEET_PROMOTE_TIMEOUT_S", float),
}


@dataclass(frozen=True)
class FleetConfig:
    """The fleet envelope. Immutable — policy changes are a new config,
    not a mutated one (the AdmissionBounds contract). Every field is
    ``GRAPHMINE_FLEET_*`` env-overridable via :meth:`from_env`."""

    probe_interval_s: float = 0.25
    # The health probe is deliberately GENEROUS next to the data-plane
    # timeout: a slow replica still answers /healthz (alive), while its
    # data-plane timeouts open the breaker (unusable) — two different
    # verdicts, two different mechanisms.
    probe_timeout_s: float = 5.0
    read_timeout_s: float = 0.5       # per-attempt data-plane timeout
    write_timeout_s: float = 120.0    # forwarded /delta and /reload
    default_deadline_ms: int = 2000   # when the client sends no X-Deadline-Ms
    retry_after_s: float = 1.0        # the 503 hint when no replica is eligible
    down_after_probes: int = 2        # consecutive probe failures -> DOWN
    min_healthy: int = 1              # rolling reload aborts below this
    quorum: int = 0                   # 0 = majority of configured replicas
    reload_cadence_s: float = 0.25    # min gap between prober catch-up reloads
    reload_timeout_s: float = 30.0    # one forwarded/rolling /reload
    rejoin_timeout_s: float = 30.0    # rolled replica must re-probe ready
    drain_grace_s: float = 0.05       # in-flight settle before a rolled reload
    breaker_window: int = 8           # outcomes in the rolling window
    breaker_open_failures: int = 3    # min failures in window to open
    breaker_open_rate: float = 0.5    # min failure rate in window to open
    breaker_backoff_base_s: float = 0.5
    breaker_backoff_max_s: float = 8.0
    promote_timeout_s: float = 60.0   # one standby /promote exchange

    def __post_init__(self):
        if self.probe_interval_s <= 0 or self.probe_timeout_s <= 0:
            raise ValueError("probe interval/timeout must be > 0")
        if self.read_timeout_s <= 0 or self.write_timeout_s <= 0:
            raise ValueError("read/write timeouts must be > 0")
        if self.down_after_probes < 1 or self.min_healthy < 0:
            raise ValueError("down_after_probes >= 1, min_healthy >= 0")
        if self.quorum < 0:
            raise ValueError("quorum must be >= 0 (0 = majority)")
        if self.breaker_window < 1 or self.breaker_open_failures < 1:
            raise ValueError("breaker window/open_failures must be >= 1")
        if not 0 < self.breaker_open_rate <= 1:
            raise ValueError("breaker_open_rate must be in (0, 1]")

    @classmethod
    def from_env(cls, **overrides) -> "FleetConfig":
        """``GRAPHMINE_FLEET_*`` env; explicit kwargs beat env; malformed
        env raises loudly (the AdmissionBounds rule)."""
        kv = {}
        for field_name, (var, parse) in _ENV.items():
            raw = os.environ.get(var)
            if raw is None or field_name in overrides:
                continue
            try:
                kv[field_name] = parse(raw)
            except ValueError as e:
                raise ValueError(
                    f"{var}={raw!r} is not a valid {parse.__name__}"
                ) from e
        kv.update(overrides)
        return cls(**kv)

    def snapshot(self) -> dict:
        return {k: getattr(self, k) for k in _ENV}


@dataclass(frozen=True)
class ReplicaSpec:
    """One replica's identity and address."""

    id: str
    host: str
    port: int


class CircuitBreaker:
    """Per-replica data-plane circuit breaker.

    ``closed``: requests flow; outcomes fill a rolling window, and a
    failure count + rate past the policy thresholds opens it.
    ``open``: no requests; a decorrelated-jitter backoff (the
    :func:`~graphmine_tpu_torch.pipeline.resilience.backoff_s` policy, attempt
    = consecutive open episodes — seeded per replica+process so a fleet
    of breakers never re-probes in lockstep) schedules the half-open
    transition. ``half_open``: exactly one probe decides — success
    closes and resets, failure re-opens with a longer backoff.

    The data plane calls :meth:`allow_request` / :meth:`record_success`
    / :meth:`record_failure`; the prober calls :meth:`probe_due` and
    :meth:`probe_result` (the half-open single probe is out-of-band, so
    client traffic is never spent discovering that a replica is still
    bad). ``on_transition(from_state, to_state, reason)`` fires on every
    state change, outside the lock.
    """

    def __init__(
        self,
        replica_id: str,
        window: int = 8,
        open_failures: int = 3,
        open_rate: float = 0.5,
        backoff: ResilienceConfig | None = None,
        on_transition=None,
        clock=time.monotonic,
    ):
        self.replica_id = replica_id
        self.window = int(window)
        self.open_failures = int(open_failures)
        self.open_rate = float(open_rate)
        self.backoff = backoff if backoff is not None else ResilienceConfig()
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._outcomes: deque = deque(maxlen=self.window)
        self._state = BREAKER_CLOSED
        self._opens = 0            # consecutive open episodes (backoff attempt)
        self._open_until = 0.0
        self._last_reason = ""     # why the last transition fired
        self._rng = random.Random(f"breaker:{replica_id}:{os.getpid()}")

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow_request(self) -> bool:
        """May the data plane route to this replica right now? Half-open
        admits nothing — the recovery probe is the prober's, not a
        client's."""
        with self._lock:
            return self._state == BREAKER_CLOSED

    def record_success(self) -> None:
        with self._lock:
            self._outcomes.append(True)
            # The open-episode counter (the backoff attempt) fully
            # resets only after a sustained clean window — a replica
            # that flaps closed/open keeps an ESCALATING backoff
            # instead of re-entering rotation at base cadence forever.
            if (
                self._state == BREAKER_CLOSED
                and len(self._outcomes) == self.window
                and all(self._outcomes)
            ):
                self._opens = 0

    def record_failure(self, reason: str = "") -> None:
        fired = None
        with self._lock:
            self._outcomes.append(False)
            if self._state != BREAKER_CLOSED:
                return
            failures = sum(1 for ok in self._outcomes if not ok)
            rate = failures / len(self._outcomes)
            if failures >= self.open_failures and rate >= self.open_rate:
                fired = self._open_locked(
                    f"{failures} failures in last {len(self._outcomes)} "
                    f"(rate {rate:.2f}); last: {reason}"
                )
        self._fire(fired)

    def _open_locked(self, reason: str):
        self._opens += 1
        delay = backoff_s(self.backoff, self._opens, self._rng)
        self._open_until = self._clock() + delay
        prev, self._state = self._state, BREAKER_OPEN
        return (prev, BREAKER_OPEN,
                f"{reason}; half-open probe in {delay:.2f}s")

    def probe_due(self) -> bool:
        """Open and past its backoff? Transitions to half-open and
        returns True exactly once per episode — the caller owns the one
        probe it was just granted."""
        fired = None
        with self._lock:
            if self._state == BREAKER_OPEN and self._clock() >= self._open_until:
                self._state = BREAKER_HALF_OPEN
                fired = (BREAKER_OPEN, BREAKER_HALF_OPEN, "backoff elapsed")
        self._fire(fired)
        return fired is not None

    def probe_result(self, ok: bool, reason: str = "") -> None:
        """The half-open single probe's verdict: close on success,
        re-open (longer backoff) on failure."""
        fired = None
        with self._lock:
            if self._state != BREAKER_HALF_OPEN:
                return
            if ok:
                self._outcomes.clear()
                # decay, don't zero: a follow-up failure burst re-opens
                # with a longer backoff than the last episode's start
                # (record_success resets fully after a clean window)
                self._opens = max(0, self._opens - 1)
                self._state = BREAKER_CLOSED
                fired = (BREAKER_HALF_OPEN, BREAKER_CLOSED,
                         reason or "probe succeeded")
            else:
                self._state = BREAKER_OPEN  # _open_locked re-sets it; keep tidy
                fired = self._open_locked(reason or "probe failed")
                fired = (BREAKER_HALF_OPEN, BREAKER_OPEN, fired[2])
        self._fire(fired)

    def _fire(self, transition) -> None:
        if transition is None:
            return
        with self._lock:
            self._last_reason = transition[2]
        if self.on_transition is not None:
            self.on_transition(*transition)

    def snapshot(self) -> dict:
        with self._lock:
            failures = sum(1 for ok in self._outcomes if not ok)
            return {
                "state": self._state,
                "window": len(self._outcomes),
                "failures_in_window": failures,
                "open_episodes": self._opens,
                "last_transition_reason": self._last_reason,
                "reopen_in_s": round(max(0.0, self._open_until - self._clock()), 3)
                if self._state == BREAKER_OPEN else 0.0,
            }


class _Replica:
    """Mutable per-replica record inside a ReplicaSet (internal)."""

    def __init__(self, spec: ReplicaSpec, breaker: CircuitBreaker):
        self.spec = spec
        self.breaker = breaker
        self.state = JOINING
        self.state_since = time.monotonic()
        self.state_reason = ""         # why the last transition fired
        self.version: int | None = None
        self.last_health: dict = {}
        self.probe_failures = 0
        self.last_reload_post = 0.0
        self.reload_inflight = False   # one async catch-up POST at a time
        self.self_drained = False      # DRAINING came from its own /drain


class ReplicaSet:
    """The fleet's state: per-replica machines, breakers, the committed
    version, and the writer/read-only verdict. Pure host bookkeeping —
    all HTTP lives in :class:`FleetRouter`; every mutation here emits
    its provenance record (``replica_health`` / ``breaker_transition``
    / ``fleet_degraded``)."""

    def __init__(
        self,
        replicas,
        writer: str | None = None,
        config: FleetConfig | None = None,
        sink=None,
        registry: Registry | None = None,
        standby: str | None = None,
    ):
        specs = [
            r if isinstance(r, ReplicaSpec) else ReplicaSpec(*r)
            for r in replicas
        ]
        if not specs:
            raise ValueError("a fleet needs at least one replica")
        ids = [s.id for s in specs]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate replica ids in {ids}")
        self.config = config if config is not None else FleetConfig.from_env()
        self.sink = sink
        self.registry = registry if registry is not None else Registry()
        self.writer_id = writer if writer is not None else specs[0].id
        if self.writer_id not in ids:
            raise ValueError(
                f"writer {self.writer_id!r} is not a replica ({ids})"
            )
        # The log-shipped standby: the replica the router promotes
        # on writer loss. None = writer loss is a
        # permanent read-only degradation until the same writer returns).
        self.standby_id = standby
        if standby is not None:
            if standby not in ids:
                raise ValueError(
                    f"standby {standby!r} is not a replica ({ids})"
                )
            if standby == self.writer_id:
                raise ValueError("the standby cannot be the writer")
        self.writer_epoch: int | None = None
        self._lock = threading.RLock()
        bk = ResilienceConfig(
            backoff_base_s=self.config.breaker_backoff_base_s,
            backoff_max_s=self.config.breaker_backoff_max_s,
        )
        self._replicas = {}
        for s in specs:
            breaker = CircuitBreaker(
                s.id,
                window=self.config.breaker_window,
                open_failures=self.config.breaker_open_failures,
                open_rate=self.config.breaker_open_rate,
                backoff=bk,
                on_transition=self._breaker_transition(s.id),
            )
            self._replicas[s.id] = _Replica(s, breaker)
        self._order = ids
        self._committed: int | None = None
        self._read_only = False
        self._rr = 0

    # -- provenance --------------------------------------------------------
    def _emit(self, phase: str, **kv) -> None:
        if self.sink is not None:
            self.sink.emit(phase, **kv)

    def _breaker_transition(self, replica_id: str):
        def on_transition(from_state: str, to_state: str, reason: str):
            if to_state == BREAKER_OPEN:
                self.registry.counter(
                    "graphmine_fleet_breaker_opens_total",
                    "circuit-breaker open transitions across the fleet",
                ).inc()
            self._emit(
                "breaker_transition", replica=replica_id,
                from_state=from_state, to_state=to_state, reason=reason,
            )
        return on_transition

    # -- accessors ---------------------------------------------------------
    def replica(self, replica_id: str) -> _Replica:
        return self._replicas[replica_id]

    def replicas(self) -> list:
        return [self._replicas[i] for i in self._order]

    @property
    def quorum(self) -> int:
        return self.config.quorum or (len(self._order) // 2 + 1)

    @property
    def read_only(self) -> bool:
        with self._lock:
            return self._read_only

    def committed_version(self) -> int | None:
        with self._lock:
            return self._committed

    # -- the state machine -------------------------------------------------
    def transition(self, rep: _Replica, to_state: str, reason: str) -> None:
        """One replica state change, with its ``replica_health`` record.
        Idempotent on no-op transitions (no record spam from steady
        probes)."""
        with self._lock:
            if rep.state == to_state:
                return
            from_state, rep.state = rep.state, to_state
            rep.state_since = time.monotonic()
            rep.state_reason = reason
        self._emit(
            "replica_health", replica=rep.spec.id, from_state=from_state,
            to_state=to_state, reason=reason, version=rep.version,
        )
        self._export()

    def apply_probe(self, rep: _Replica, health: dict | None, error: str = "") -> None:
        """Fold one health-probe outcome into the machine. ``health`` is
        the replica's ``/healthz`` body (None = probe failed). DRAINING
        is sticky for successes — the rolling reload owns that state —
        but a DRAINING replica that stops answering still goes DOWN."""
        if health is None:
            rep.probe_failures += 1
            if (
                rep.probe_failures >= self.config.down_after_probes
                and rep.state != DOWN
            ):
                self.transition(
                    rep, DOWN,
                    f"{rep.probe_failures} consecutive probe failures "
                    f"({error})",
                )
            self._recompute()
            return
        rep.probe_failures = 0
        rep.version = int(health.get("version", 0)) or rep.version
        rep.last_health = health
        ready = bool(health.get("ready", True))
        flagged = (
            not ready
            or bool(health.get("overloaded", False))
            or not rep.breaker.allow_request()
        )
        why = []
        if not ready:
            why.append("not ready")
        if health.get("overloaded"):
            why.append(f"overloaded: {health.get('overload_reason', '')}")
        if not rep.breaker.allow_request():
            why.append(f"breaker {rep.breaker.state}")
        if rep.state == DRAINING:
            # Router-initiated drains (rolling reload) are sticky — the
            # roll owns the rejoin. A SELF-drained replica (its own
            # POST /drain) rejoins when it stops reporting draining.
            if rep.self_drained and not health.get("draining", False):
                rep.self_drained = False
                self.transition(rep, JOINING, "replica undrained")
        elif health.get("draining", False):
            # The operator took it out of rotation at the replica
            # (POST /drain): honor it — a drained replica must receive
            # NO reads, not linger as a degraded last resort.
            rep.self_drained = True
            self.transition(
                rep, DRAINING, "replica reports draining (its /drain)"
            )
        elif rep.state == DOWN:
            self.transition(rep, JOINING, "probe succeeded; rejoining")
        elif rep.state == JOINING:
            if ready:
                self.transition(
                    rep, HEALTHY, f"ready at v{rep.version}"
                )
        elif flagged and rep.state == HEALTHY:
            self.transition(rep, DEGRADED, "; ".join(why))
        elif not flagged and rep.state == DEGRADED:
            self.transition(rep, HEALTHY, f"recovered at v{rep.version}")
        self._recompute()

    # -- committed version -------------------------------------------------
    def _recompute(self) -> None:
        """Committed = max version held by a read quorum of configured
        replicas (DOWN replicas hold nothing routable), MONOTONIC: once
        the fleet has served v, it never commits backwards — losing
        quorum makes the fleet unavailable-consistent (503s), never
        time-traveling."""
        with self._lock:
            versions = sorted(
                (
                    r.version for r in self._replicas.values()
                    if r.version is not None and r.state != DOWN
                ),
                reverse=True,
            )
            q = self.quorum
            if len(versions) >= q:
                cand = int(versions[q - 1])
                if self._committed is None or cand > self._committed:
                    self._committed = cand
        self._export()

    def update_read_only(self) -> None:
        """The writer-liveness verdict: writer DOWN → read-only fleet
        (loud ``fleet_degraded`` record). With no standby that is where
        it stays until the SAME writer returns (same identity is not an
        election); with a standby configured the router's prober
        follows up with the fenced promotion, so read-only is the
        bounded transient between loss and time-to-writable."""
        with self._lock:
            # writer_id must resolve under the lock: a concurrent
            # promote_writer() re-points it, and judging the DEPOSED
            # replica's state here would flip the just-promoted fleet
            # back to read-only with a spurious fleet_degraded record
            writer_id = self.writer_id
            lost = self._replicas[writer_id].state == DOWN
            flip = lost != self._read_only
            if flip:
                self._read_only = lost
            standby = self.standby_id
        if flip:
            self._emit(
                "fleet_degraded", read_only=lost,
                reason=(
                    (
                        f"writer {writer_id} is down: fleet is "
                        "read-only "
                        + (
                            f"(standby {standby} promotion pending — "
                            "writes resume at the new epoch)"
                            if standby is not None else
                            "(writes 503 until the writer returns; no "
                            "failover without a standby — a second "
                            "unfenced writer on one store is split-brain)"
                        )
                    )
                    if lost else
                    f"writer {writer_id} recovered: writes restored"
                ),
                writer=writer_id,
            )
            self._export()

    def promote_writer(self, new_writer: str, epoch: int | None,
                       reason: str = "") -> None:
        """Re-point the fleet at the promoted standby: it becomes THE
        writer, the deposed writer becomes the standby candidate for
        the next failover, and writes reopen. The epoch fence at the
        store is what makes this safe — the deposed writer's comeback
        publish refuses regardless of what this router believes."""
        with self._lock:
            deposed = self.writer_id
            self.writer_id = new_writer
            self.standby_id = deposed
            self.writer_epoch = epoch
            self._read_only = False
        self._emit(
            "writer_promote",
            epoch=epoch,
            replica=new_writer,
            deposed=deposed,
            reason=reason or (
                f"standby {new_writer} promoted to writer at epoch "
                f"{epoch}; deposed {deposed} is fenced at the store and "
                "rejoins as the standby CANDIDATE — it is NOT "
                "log-shipping from the new writer until relaunched "
                f"with standby_of={new_writer}; until then a second "
                "failover's loss bound is the unapplied tail at the "
                "new writer's death, not the shipped lag (RUNBOOKS §10)"
            ),
        )
        self._emit(
            "fleet_degraded", read_only=False,
            reason=(
                f"writes restored on promoted writer {new_writer} "
                f"(epoch {epoch}); deposed {deposed} fenced"
            ),
            writer=new_writer,
        )
        self._export()

    # -- routing -----------------------------------------------------------
    def pick(self, version: int, exclude=()) -> _Replica | None:
        """One read-eligible replica at exactly ``version`` (round-robin,
        HEALTHY preferred over DEGRADED, open breakers and ``exclude``d
        ids skipped). Exact-version match is the consistency rule: a
        replica already past the committed version serves the NEWER
        snapshot, and routing to it would hand one client two versions
        across a retry."""
        with self._lock:
            eligible = [
                r for r in (self._replicas[i] for i in self._order)
                if r.state in (HEALTHY, DEGRADED)
                and r.version == version
                and r.spec.id not in exclude
                and r.breaker.allow_request()
            ]
            if not eligible:
                return None
            preferred = [r for r in eligible if r.state == HEALTHY] or eligible
            self._rr += 1
            return preferred[self._rr % len(preferred)]

    def healthy_count(self) -> int:
        with self._lock:
            return sum(
                1 for r in self._replicas.values()
                if r.state in (HEALTHY, DEGRADED)
            )

    # -- surfaces ----------------------------------------------------------
    def _export(self) -> None:
        reg = self.registry
        with self._lock:
            committed = self._committed
            read_only = self._read_only
        reg.gauge(
            "graphmine_fleet_committed_version",
            "snapshot version the fleet routes reads at",
        ).set(committed if committed is not None else 0)
        reg.gauge(
            "graphmine_fleet_replicas_healthy",
            "replicas currently read-eligible (healthy or degraded)",
        ).set(self.healthy_count())
        reg.gauge(
            "graphmine_fleet_read_only",
            "1 while the writer is down and the fleet refuses writes",
        ).set(1 if read_only else 0)

    def snapshot(self) -> dict:
        """The ``/fleetz`` body: every replica's state/version/breaker
        plus the fleet verdicts."""
        with self._lock:
            committed = self._committed
            read_only = self._read_only
        return {
            "committed_version": committed,
            "quorum": self.quorum,
            "writer": self.writer_id,
            "standby": self.standby_id,
            "writer_epoch": self.writer_epoch,
            "read_only": read_only,
            "replicas": [
                {
                    "id": r.spec.id,
                    "host": r.spec.host,
                    "port": r.spec.port,
                    "state": r.state,
                    "state_reason": r.state_reason,
                    "version": r.version,
                    "writer": r.spec.id == self.writer_id,
                    "standby": r.spec.id == self.standby_id,
                    "writer_epoch": r.last_health.get("writer_epoch"),
                    "replication_lag_s": r.last_health.get(
                        "replication_lag_s"
                    ),
                    "breaker": r.breaker.snapshot(),
                    "state_age_s": round(
                        time.monotonic() - r.state_since, 3
                    ),
                    "snapshot_age_s": r.last_health.get("snapshot_age_s"),
                    "overloaded": r.last_health.get("overloaded"),
                    "lof_stale": r.last_health.get("lof_stale"),
                    "tenants": r.last_health.get("tenants"),
                    "tenant_versions": r.last_health.get("tenant_versions"),
                    # sharded write plane: committed publish epoch
                    # + per-range version vector — fleet_cli status
                    # --shards collapses these into the range table
                    "epoch": r.last_health.get("epoch"),
                    "shard_versions": r.last_health.get("shard_versions"),
                    "writer_shards": r.last_health.get("writer_shards"),
                    "degraded_shards": r.last_health.get(
                        "degraded_shards"
                    ),
                }
                for r in self.replicas()
            ],
        }


# One route table per method (the serve/server.py discipline): the same
# table resolves the histogram endpoint label and dispatches, so a route
# can never exist in one place and not the other.
_PROXY_GET = ("/vertex", "/explain", "/neighbors", "/topk", "/snapshot")
_GET_ROUTES = {
    "/healthz": "_ep_healthz",
    "/fleetz": "_ep_fleetz",
    "/statusz": "_ep_statusz",
    "/metrics": "_ep_metrics",
    "/alertz": "_ep_alertz",
    **{p: "_ep_read" for p in _PROXY_GET},
}
_POST_ROUTES = {
    "/query": "_ep_read",
    "/delta": "_ep_write",
    "/reload": "_ep_write",
    "/roll": "_ep_roll",
    "/promote": "_ep_promote",
}


class FleetRouter:
    """The stdlib front tier: ThreadingHTTPServer (the serve/server.py
    idioms) routing reads across a :class:`ReplicaSet` and forwarding
    writes to the single writer. See the module docstring for the
    contract."""

    def __init__(
        self,
        replicas,
        writer: str | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        sink=None,
        config: FleetConfig | None = None,
        registry: Registry | None = None,
        standby: str | None = None,
    ):
        self.config = config if config is not None else FleetConfig.from_env()
        self.sink = sink
        self.registry = registry if registry is not None else (
            sink.registry if sink is not None else Registry()
        )
        # Memory budget: resolved ONCE at construction — the
        # SnapshotServer discipline — so a malformed env override fails
        # loudly here instead of 500ing every later /statusz scrape
        # (and /proc/meminfo is not re-parsed per scrape).
        self._mem_budget = serve_mem_budget_bytes()
        self.replica_set = ReplicaSet(
            replicas, writer=writer, config=self.config, sink=sink,
            registry=self.registry, standby=standby,
        )
        self._host, self._port = host, port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._prober: threading.Thread | None = None
        self._stop = threading.Event()
        self._roll_lock = threading.Lock()
        self._promote_lock = threading.Lock()
        # Per-delta time-to-visible tracking: version ->
        # {t0, trace, seen replicas, wall-clock created}. A forwarded
        # /delta that published version v starts an entry; the prober
        # marks each replica visible the first time it reports >= v,
        # observing graphmine_fleet_time_to_visible_seconds{replica=..}
        # and emitting a delta_visible record in the DELTA's trace.
        self._vis_lock = threading.Lock()
        self._visibility: dict = {}
        self._vis_max = 256            # bounded: old entries expire
        self._vis_expire_s = 600.0
        # TTL cache of the /alertz quality fan-out: one pass
        # serves /alertz + /statusz + /metrics reads within the window,
        # and the lock keeps a scrape burst from stampeding replicas.
        self._alertz_cache: tuple = (-1e9, {})
        self._alertz_cache_lock = threading.Lock()
        self._alertz_refreshing = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> tuple[str, int]:
        """Bind, serve on a daemon thread, start the health prober;
        returns (host, port)."""
        router = self

        class Handler(_FleetHandler):
            rtr = router

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="graphmine-fleet-router",
            daemon=True,
        )
        self._thread.start()
        self._stop.clear()
        self._prober = threading.Thread(
            target=self._probe_loop, name="graphmine-fleet-prober",
            daemon=True,
        )
        self._prober.start()
        return self._httpd.server_address[:2]

    def stop(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=30)
            self._prober = None
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    # -- replica HTTP ------------------------------------------------------
    def _replica_call(
        self, rep: _Replica, method: str, path: str,
        body: bytes | None = None, timeout: float = 1.0,
        headers: dict | None = None,
    ) -> tuple[int, bytes, dict]:
        """One HTTP exchange with a replica -> (status, body, headers).
        4xx/5xx return their status; transport failures raise (the
        caller's breaker/retry logic classifies them)."""
        req = urlrequest.Request(
            f"http://{rep.spec.host}:{rep.spec.port}{path}",
            data=body, method=method,
        )
        if body is not None:
            req.add_header("Content-Type", "application/json")
        headers = dict(headers or {})
        # Trace propagation on EVERY replica exchange — data-plane
        # reads, writer forwards, probes, reloads, promotions: the
        # replica adopts this header and its records land in the same
        # trace (the per-request root span for client traffic, the
        # router's run trace for prober housekeeping).
        if TRACE_HEADER not in headers:
            th = self._trace_header()
            if th:
                headers[TRACE_HEADER] = th
        for name, value in headers.items():
            req.add_header(name, value)
        try:
            with urlrequest.urlopen(req, timeout=timeout) as resp:
                return resp.status, resp.read(), dict(resp.headers)
        except urlerror.HTTPError as e:
            return e.code, e.read(), dict(e.headers)

    def _trace_header(self) -> str:
        """The calling thread's current span as a propagatable header
        ("" without a sink/tracer) — inside the request middleware this
        is the per-request root span."""
        return sink_trace_header(self.sink)

    def _probe_replica(self, rep: _Replica, timeout: float) -> dict | None:
        try:
            status, body, _ = self._replica_call(
                rep, "GET", "/healthz", timeout=timeout
            )
            if status != 200:
                return None
            return json.loads(body.decode())
        except Exception:  # noqa: BLE001 — any transport failure is a miss
            return None

    # -- the prober --------------------------------------------------------
    def _probe_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 — the prober must never die
                pass
            self._stop.wait(self.config.probe_interval_s)

    def probe_once(self) -> None:
        """One full prober pass (public so tests drive the machine
        deterministically): half-open breaker probes, health probes +
        state transitions, the writer catch-up reload cadence, the
        writer-liveness/read-only verdict, committed recompute.
        Replicas are probed CONCURRENTLY — one hung replica eating its
        whole probe_timeout must not stall DOWN detection, half-open
        probes or the read-only verdict for the rest of the fleet."""
        cfg = self.config
        rs = self.replica_set

        def probe_one(rep: _Replica) -> None:
            # The half-open single probe: a DATA-PLANE read (/snapshot,
            # the cheapest proxied read endpoint) at the data-plane
            # timeout — a replica that answers health but serves reads
            # slowly OR erroringly stays open; /healthz alone would
            # miss the fast-500 failure shape.
            if rep.breaker.probe_due():
                try:
                    status, _, _ = self._replica_call(
                        rep, "GET", "/snapshot",
                        timeout=cfg.read_timeout_s,
                    )
                    ok = status < 500
                except Exception:  # noqa: BLE001 — timeout/refused
                    ok = False
                rep.breaker.probe_result(
                    ok,
                    f"half-open read probe "
                    f"{'served' if ok else 'failed'} within "
                    f"{cfg.read_timeout_s:g}s",
                )
            health = self._probe_replica(rep, cfg.probe_timeout_s)
            rs.apply_probe(
                rep, health,
                error="probe timed out or connection failed",
            )

        probers = [
            threading.Thread(
                target=probe_one, args=(rep,),
                name=f"graphmine-fleet-probe-{rep.spec.id}", daemon=True,
            )
            for rep in rs.replicas()
        ]
        for t in probers:
            t.start()
        for t in probers:
            t.join()
        # Catch-up reload cadence: the writer publishes, everyone else
        # follows. (A replica AHEAD of the writer — mid rolling reload —
        # is left alone; committed advances when quorum catches up.)
        writer = rs.replica(rs.writer_id)
        if writer.state not in (DOWN,) and writer.version is not None:
            now = time.monotonic()
            for rep in rs.replicas():
                if (
                    rep.spec.id != rs.writer_id
                    and rep.state in (HEALTHY, DEGRADED)
                    and rep.version is not None
                    and rep.version < writer.version
                    and not rep.reload_inflight
                    and now - rep.last_reload_post >= cfg.reload_cadence_s
                ):
                    rep.last_reload_post = now
                    rep.reload_inflight = True
                    # Fire-and-forget: a big snapshot's /reload can take
                    # many seconds, and blocking the prober on it would
                    # stall DOWN detection, half-open probes and the
                    # read-only verdict fleet-wide. The next probe pass
                    # reads the resulting version either way.
                    threading.Thread(
                        target=self._post_reload, args=(rep,),
                        name=f"graphmine-fleet-reload-{rep.spec.id}",
                        daemon=True,
                    ).start()
        self._check_visibility()
        rs.update_read_only()
        # Fenced failover: a read-only fleet with a live standby
        # promotes it instead of staying degraded. Fire-and-forget like
        # the reload cadence — a slow /promote (WAL-tail replay) must
        # not stall DOWN detection; promote_standby's own lock keeps it
        # single-flight, and the next pass retries a failed attempt.
        if (
            rs.read_only
            and rs.standby_id is not None
            and rs.replica(rs.standby_id).state not in (DOWN,)
            and not self._stop.is_set()
        ):
            threading.Thread(
                target=self.promote_standby,
                name="graphmine-fleet-promote", daemon=True,
            ).start()

    def _post_reload(self, rep: _Replica) -> None:
        try:
            self._replica_call(
                rep, "POST", "/reload", body=b"{}",
                timeout=self.config.reload_timeout_s,
            )
        except Exception:  # noqa: BLE001 — the next probe sees the state
            pass
        finally:
            rep.reload_inflight = False

    # -- per-delta time-to-visible ------------------------------------------
    def _track_visibility(self, version: int, t0: float, trace: str) -> None:
        """Start tracking a just-published version: each replica's
        first probe at >= version closes its leg of the SLO."""
        with self._vis_lock:
            if version in self._visibility:
                return
            self._visibility[version] = {
                "t0": t0,
                "trace": trace,
                "seen": set(),
                "created": time.monotonic(),
            }
            if len(self._visibility) > self._vis_max:
                for v in sorted(self._visibility)[: -self._vis_max]:
                    self._visibility.pop(v, None)

    def _mark_visible(
        self, version: int, entry: dict, replica_id: str, now: float,
    ) -> None:
        seconds = max(0.0, now - entry["t0"])
        self.registry.histogram(
            "graphmine_fleet_time_to_visible_seconds",
            "delta accept at the router to each replica serving the "
            "version that absorbed it",
            replica=replica_id,
        ).observe(seconds)
        if self.sink is None:
            return
        ctx = (
            TraceContext.from_header(entry["trace"])
            if entry["trace"] else None
        )
        span = (
            self.sink.span(
                "delta_visible", emit=False, annotate=False, remote=ctx,
            )
            if ctx is not None else contextlib.nullcontext()
        )
        with span:
            self.sink.emit(
                "delta_visible", replica=replica_id, version=int(version),
                seconds=round(seconds, 6),
            )

    def _check_visibility(self) -> None:
        """Prober-pass sweep: close the (delta, replica) legs whose
        replica now serves the tracked version; expire stale entries
        (a replica that died before catching up must not pin an entry
        forever)."""
        rs = self.replica_set
        now = time.monotonic()
        all_ids = {r.spec.id for r in rs.replicas()}
        reps = [(r.spec.id, r.version, r.state) for r in rs.replicas()]
        marks = []
        # seen-set mutation stays under the lock (a test-driven
        # probe_once racing the prober thread must not double-observe a
        # leg); the sink emission happens after release — a record
        # fsync must not serialize the sweep.
        with self._vis_lock:
            for version, entry in list(self._visibility.items()):
                for rep_id, rep_version, rep_state in reps:
                    if (
                        rep_id in entry["seen"]
                        or rep_version is None
                        or rep_version < version
                        or rep_state == DOWN
                    ):
                        continue
                    entry["seen"].add(rep_id)
                    marks.append((version, dict(entry), rep_id))
                if (
                    entry["seen"] >= all_ids
                    or now - entry["created"] > self._vis_expire_s
                ):
                    self._visibility.pop(version, None)
        for version, entry, rep_id in marks:
            self._mark_visible(version, entry, rep_id, now)

    def time_to_visible_merged(self) -> Histogram | None:
        """All per-replica time-to-visible histograms folded counter-wise
        (:meth:`~graphmine_tpu_torch.obs.histogram.Histogram.merge` — the
        mergeable-ladder rollup) into one fleet-level distribution; None
        before the first observation."""
        fam = self.registry.histogram_family(
            "graphmine_fleet_time_to_visible_seconds"
        )
        if fam is None:
            return None
        merged = Histogram(
            "graphmine_fleet_time_to_visible_merged_seconds",
            "time-to-visible across all replicas (counter-wise merge of "
            "the per-replica histograms)",
            buckets=fam.bounds,
        )
        for child in fam.children():
            merged.merge(child)
        return merged

    # -- read routing ------------------------------------------------------
    def route_read(
        self, method: str, path_qs: str, body: bytes | None,
        headers,
    ) -> tuple[int, bytes, dict]:
        """Consistent-version read with bounded cross-replica retry
        under the propagated deadline. Returns (status, body, headers)
        for the handler to relay."""
        cfg = self.config
        rs = self.replica_set
        endpoint = urlparse(path_qs).path.lstrip("/") or "?"
        t0 = time.monotonic()
        try:
            deadline_ms = int(headers.get("X-Deadline-Ms", ""))
        except ValueError:
            deadline_ms = cfg.default_deadline_ms
        deadline = t0 + max(1, deadline_ms) / 1000.0
        committed = rs.committed_version()
        if committed is None:
            return self._no_replica(
                endpoint, 0, None, "no committed version yet (fleet warming)"
            )
        pinned_hdr = headers.get("X-Pinned-Version", "")
        if pinned_hdr:
            try:
                pinned = int(pinned_hdr)
            except ValueError:
                pinned = committed
            if pinned > committed:
                # The session has seen a version this fleet can no
                # longer quorum on — answering an OLDER version would
                # break monotonic reads; refuse instead.
                self._emit_route(
                    endpoint, "stale_pin", 0, committed,
                    seconds=time.monotonic() - t0,
                )
                return self._shed(
                    f"fleet committed v{committed} is behind the session's "
                    f"pinned v{pinned}; retry after the fleet catches up"
                )
        tried: list = []
        attempts = 0
        last_error = "no eligible replica"
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                last_error = f"deadline {deadline_ms}ms exhausted"
                break
            rep = rs.pick(committed, exclude=tried)
            if rep is None:
                break
            attempts += 1
            attempt_timeout = min(cfg.read_timeout_s, remaining)
            try:
                status, resp_body, resp_headers = self._replica_call(
                    rep, method, path_qs, body=body,
                    timeout=attempt_timeout,
                    headers={
                        "X-Serve-Version": str(committed),
                        **(
                            {"X-Request-Id": headers["X-Request-Id"]}
                            if headers.get("X-Request-Id") else {}
                        ),
                        **(
                            {"X-Tenant-Id": headers["X-Tenant-Id"]}
                            if headers.get("X-Tenant-Id") else {}
                        ),
                    },
                )
            except Exception as e:  # noqa: BLE001 — timeout/refused/reset
                # Charge the breaker only when the replica had the FULL
                # read budget: a failure under a deadline-truncated
                # timeout is the client's budget running out, not
                # replica fault — tight-deadline traffic must not open
                # breakers on healthy replicas (dead ones are still
                # caught by the prober's DOWN detection).
                if attempt_timeout >= cfg.read_timeout_s:
                    rep.breaker.record_failure(repr(e))
                tried.append(rep.spec.id)
                last_error = f"{rep.spec.id}: {e!r}"
                continue
            if status == 409:
                # The replica swapped versions between pick and serve —
                # not a fault (no breaker hit), just not at our pin
                # anymore; the prober will re-read its version.
                tried.append(rep.spec.id)
                last_error = f"{rep.spec.id}: version moved (409)"
                continue
            if status >= 500:
                rep.breaker.record_failure(f"HTTP {status}")
                tried.append(rep.spec.id)
                last_error = f"{rep.spec.id}: HTTP {status}"
                continue
            rep.breaker.record_success()
            self.registry.counter(
                "graphmine_fleet_read_retries_total",
                "extra read attempts beyond the first, fleet-wide",
            ).inc(attempts - 1)
            self._emit_route(
                endpoint, "served", attempts, committed,
                replica=rep.spec.id, seconds=time.monotonic() - t0,
            )
            out_headers = {
                "Content-Type": resp_headers.get(
                    "Content-Type", "application/json"
                ),
                "X-Pinned-Version": str(committed),
                "X-Fleet-Replica": rep.spec.id,
            }
            # keep the replica's X-Request-Id echo: client-side trace
            # correlation must survive a router in front of the server
            if resp_headers.get("X-Request-Id"):
                out_headers["X-Request-Id"] = resp_headers["X-Request-Id"]
            return status, resp_body, out_headers
        return self._no_replica(endpoint, attempts, committed, last_error)

    def _no_replica(
        self, endpoint: str, attempts: int, version, reason: str,
    ) -> tuple[int, bytes, dict]:
        self.registry.counter(
            "graphmine_fleet_no_replica_total",
            "reads refused because no replica was eligible",
        ).inc()
        self._emit_route(endpoint, "no_replica", attempts, version,
                         reason=reason)
        return self._shed(f"no eligible replica: {reason}")

    def _shed(self, reason: str) -> tuple[int, bytes, dict]:
        body = json.dumps({
            "error": "fleet unavailable",
            "reason": reason,
            "retry_after_s": self.config.retry_after_s,
        }).encode()
        return 503, body, {
            "Content-Type": "application/json",
            "Retry-After": str(max(1, round(self.config.retry_after_s))),
        }

    def _emit_route(
        self, endpoint: str, verdict: str, attempts: int, version,
        **kv,
    ) -> None:
        if "seconds" in kv:
            kv["seconds"] = round(kv["seconds"], 6)
        if self.sink is not None:
            self.sink.emit(
                "fleet_route", endpoint=endpoint, verdict=verdict,
                attempts=attempts, version=version, **kv,
            )

    # -- fenced failover ---------------------------------------------------
    def promote_standby(self) -> dict:
        """Promote the configured standby to writer (single-flight; the
        prober fires it on writer loss, ``POST /promote`` and
        ``fleet_cli promote`` fire it manually): one ``/promote``
        exchange with the standby — it fences the store epoch, replays
        its WAL tail and resumes writes — then the fleet re-points write
        forwarding at it. On failure the fleet stays read-only and the
        next prober pass retries."""
        if not self._promote_lock.acquire(blocking=False):
            return {"ok": False, "reason": "a promotion is already in flight"}
        try:
            rs = self.replica_set
            if rs.standby_id is None:
                return {"ok": False, "reason": "no standby configured"}
            standby = rs.replica(rs.standby_id)
            if standby.state == DOWN:
                return {
                    "ok": False,
                    "reason": f"standby {standby.spec.id} is down",
                }
            try:
                status, body, _ = self._replica_call(
                    standby, "POST", "/promote", body=b"{}",
                    timeout=self.config.promote_timeout_s,
                )
            except Exception as e:  # noqa: BLE001 — retried next pass
                self._emit_route(
                    "promote", "promote_failed", 1, rs.committed_version(),
                    reason=repr(e),
                )
                return {"ok": False, "reason": repr(e)}
            if status != 200:
                self._emit_route(
                    "promote", "promote_failed", 1, rs.committed_version(),
                    reason=f"HTTP {status}",
                )
                return {"ok": False, "reason": f"/promote answered {status}"}
            out = json.loads(body.decode())
            epoch = out.get("epoch")
            rs.promote_writer(standby.spec.id, epoch)
            self.registry.counter(
                "graphmine_fleet_promotions_total",
                "standby-to-writer promotions",
            ).inc()
            return {
                "ok": True,
                "writer": standby.spec.id,
                "epoch": epoch,
                "replayed": out.get("replayed"),
                "copied_tail": out.get("copied_tail"),
            }
        finally:
            self._promote_lock.release()

    # -- write forwarding --------------------------------------------------
    def forward_write(
        self, path_qs: str, body: bytes | None, headers,
    ) -> tuple[int, bytes, dict]:
        """POST /delta and /reload go to THE writer (single-publisher
        contract); a read-only fleet (writer down) refuses with 503 +
        Retry-After rather than electing a second publisher."""
        rs = self.replica_set
        endpoint = urlparse(path_qs).path.lstrip("/") or "?"
        if rs.read_only:
            self._emit_route(endpoint, "read_only", 0, rs.committed_version())
            return self._shed(
                f"fleet is read-only: writer {rs.writer_id} is down "
                "(no failover; restore the writer)"
            )
        writer = rs.replica(rs.writer_id)
        fwd_headers = {}
        # X-Delta-Id / X-Delta-Ack ride through: the idempotency key and
        # the WAL-durable 202 contract are writer semantics the router
        # must not strip. X-Tenant-Id too: tenant routing is writer
        # semantics — stripping it would land the delta on the default
        # namespace, a silent cross-tenant write.
        for name in ("X-Deadline-Ms", "X-Request-Id", "X-Delta-Id",
                     "X-Delta-Ack", "X-Tenant-Id"):
            if headers.get(name):
                fwd_headers[name] = headers[name]
        t0 = time.monotonic()
        try:
            status, resp_body, resp_headers = self._replica_call(
                writer, "POST", path_qs, body=body or b"{}",
                timeout=self.config.write_timeout_s, headers=fwd_headers,
            )
        except Exception as e:  # noqa: BLE001 — writer unreachable
            writer.breaker.record_failure(repr(e))
            self._emit_route(
                endpoint, "writer_unreachable", 1, rs.committed_version(),
                reason=repr(e),
            )
            return self._shed(f"writer {rs.writer_id} unreachable: {e!r}")
        if endpoint == "delta" and status == 200:
            # A synchronous apply published a version: start the
            # time-to-visible clock. The writer serves it already (the
            # 200 means the swap happened), so its leg closes here; the
            # prober closes each remaining replica's leg as it catches
            # up. (202 WAL-acks carry no version yet — their visibility
            # is bounded by the same publish this tracking catches when
            # the coalesced group lands via a later sync apply or the
            # reload cadence.)
            try:
                version = json.loads(resp_body.decode()).get("version")
            except (ValueError, UnicodeDecodeError):
                version = None
            if isinstance(version, int):
                self._track_visibility(
                    version, t0, self._trace_header()
                )
                with self._vis_lock:
                    entry = self._visibility.get(version)
                    # A prober sweep racing between _track_visibility
                    # and here may have closed the writer leg already —
                    # membership is the double-observe guard.
                    if (
                        entry is not None
                        and writer.spec.id not in entry["seen"]
                    ):
                        entry["seen"].add(writer.spec.id)
                        entry = dict(entry)
                    else:
                        entry = None
                if entry is not None:
                    self._mark_visible(
                        version, entry, writer.spec.id, time.monotonic()
                    )
        self._emit_route(
            endpoint, "forwarded", 1, rs.committed_version(),
            replica=writer.spec.id, status=status,
        )
        out_headers = {
            "Content-Type": resp_headers.get(
                "Content-Type", "application/json"
            ),
            "X-Fleet-Replica": writer.spec.id,
        }
        for passthrough in ("Retry-After", "X-Request-Id"):
            if resp_headers.get(passthrough):
                out_headers[passthrough] = resp_headers[passthrough]
        return status, resp_body, out_headers

    # -- rolling reload ----------------------------------------------------
    def rolling_reload(self) -> dict:
        """Drain → /reload → re-probe → rejoin, one replica at a time
        (writer LAST, so write availability is the last thing to
        blink), aborting if the fleet would drop below ``min_healthy``
        read-eligible replicas. Returns the roll report; one roll at a
        time per router."""
        if not self._roll_lock.acquire(blocking=False):
            return {"ok": False, "aborted": "a roll is already in progress"}
        try:
            return self._roll()
        finally:
            self._roll_lock.release()

    def _roll(self) -> dict:
        cfg = self.config
        rs = self.replica_set
        order = [r for r in rs.replicas() if r.spec.id != rs.writer_id]
        order.append(rs.replica(rs.writer_id))
        rolled = []
        for rep in order:
            if rep.state == DOWN:
                rolled.append({"id": rep.spec.id, "skipped": "down"})
                continue
            serving = rs.healthy_count()
            remaining = serving - (1 if rep.state in (HEALTHY, DEGRADED) else 0)
            if remaining < cfg.min_healthy:
                return {
                    "ok": False, "rolled": rolled,
                    "aborted": (
                        f"draining {rep.spec.id} would leave {remaining} "
                        f"serving replica(s) < min_healthy {cfg.min_healthy}"
                    ),
                }
            rs.transition(rep, DRAINING, "rolling reload")
            time.sleep(cfg.drain_grace_s)
            try:
                status, body, _ = self._replica_call(
                    rep, "POST", "/reload", body=b"{}",
                    timeout=cfg.reload_timeout_s,
                )
                if status != 200:
                    raise RuntimeError(f"/reload answered HTTP {status}")
                new_version = int(json.loads(body.decode())["version"])
            except Exception as e:  # noqa: BLE001 — abort, leave it DOWN
                rs.transition(rep, DOWN, f"rolling reload failed: {e!r}")
                return {
                    "ok": False, "rolled": rolled,
                    "aborted": f"reload of {rep.spec.id} failed: {e!r}",
                }
            # Per-tenant committed rule: /reload answers with
            # the default tenant's new version, but a multi-tenant
            # replica can come back caught up on that namespace and
            # STALE on another it also serves. Snapshot its pre-drain
            # tenant_versions and refuse rejoin until it is at-or-past
            # every one of them — behind on ANY tenant is catch-up-stale.
            before_tv = rep.last_health.get("tenant_versions")
            before_tv = dict(before_tv) if isinstance(before_tv, dict) else {}
            ok = False
            rejoin_deadline = time.monotonic() + cfg.rejoin_timeout_s
            while time.monotonic() < rejoin_deadline:
                health = self._probe_replica(rep, cfg.probe_timeout_s)
                tenants_ok = True
                if health is not None and before_tv:
                    after_tv = health.get("tenant_versions")
                    after_tv = after_tv if isinstance(after_tv, dict) else {}
                    try:
                        tenants_ok = all(
                            int(after_tv.get(t, -1)) >= int(v)
                            for t, v in before_tv.items()
                        )
                    except (TypeError, ValueError):
                        tenants_ok = False
                if (
                    health is not None
                    and bool(health.get("ready", True))
                    and int(health.get("version", 0)) == new_version
                    and tenants_ok
                ):
                    rep.version = new_version
                    rep.last_health = health
                    rep.probe_failures = 0
                    ok = True
                    break
                time.sleep(min(0.05, cfg.probe_interval_s))
            if not ok:
                rs.transition(
                    rep, DOWN,
                    f"did not re-probe ready at v{new_version} within "
                    f"{cfg.rejoin_timeout_s:g}s after reload",
                )
                return {
                    "ok": False, "rolled": rolled,
                    "aborted": f"{rep.spec.id} did not rejoin",
                }
            rs.transition(rep, HEALTHY, f"rolled to v{new_version}")
            rs._recompute()
            rolled.append({"id": rep.spec.id, "version": new_version})
        rs._recompute()
        return {
            "ok": True, "rolled": rolled,
            "committed_version": rs.committed_version(),
        }

    # -- surfaces ----------------------------------------------------------
    def healthz(self) -> dict:
        rs = self.replica_set
        committed = rs.committed_version()
        healthy = rs.healthy_count()
        out = {
            "ok": True,
            "role": "router",
            "committed_version": committed,
            "replicas_serving": healthy,
            "replicas_total": len(rs.replicas()),
            "writer": rs.writer_id,
            "standby": rs.standby_id,
            "writer_epoch": rs.writer_epoch,
            "read_only": rs.read_only,
            "ready": committed is not None
            and healthy >= max(1, self.config.min_healthy),
        }
        # Sharded write plane: surface the writer's committed
        # publish epoch + per-range version vector, as last probed — the
        # fleet-facing "which epoch is served" answer the chaos tier's
        # no-mixed-epoch-reads assertion keys off.
        writer = (
            rs.replica(rs.writer_id) if rs.writer_id is not None else None
        )
        if writer is not None and writer.last_health.get("epoch") is not None:
            out["epoch"] = writer.last_health.get("epoch")
            out["shard_versions"] = writer.last_health.get("shard_versions")
            out["writer_shards"] = writer.last_health.get("writer_shards")
        return out

    def fleetz(self) -> dict:
        return {**self.replica_set.snapshot(),
                "config": self.config.snapshot()}

    # -- result quality & alerts -------------------------------------------
    def _collect_alertz(self, max_age_s: float = 1.0) -> dict:
        """Best-effort ``GET /alertz`` fan-out to every not-DOWN
        replica: per-replica alert/quality payloads keyed by replica id.
        A replica that fails the call is simply absent (its prober
        verdict, not this page, owns its health story).

        TTL-cached (``max_age_s``): /alertz, /statusz and /metrics all
        read through here, and each fan-out is a serial HTTP pass whose
        per-replica timeout a hung-but-not-yet-DOWN replica can spend in
        full — a monitoring cycle hitting all three endpoints must cost
        ONE pass, not three, and a scrape burst must not multiply
        replica load. The per-replica timeout is the data-plane
        ``read_timeout_s`` (the quality state is cached on the replica
        engine — the prober's own /healthz reads already built it), so
        the worst-case stall is bounded by the same budget as any
        routed read."""
        with self._alertz_cache_lock:
            t_cached, cached = self._alertz_cache
            if time.monotonic() - t_cached <= max_age_s:
                return cached
            if self._alertz_refreshing:
                # Single-flight: one thread pays the fan-out; everyone
                # else gets the stale-but-bounded cached view instead of
                # queueing behind a hung replica's timeout (a sick
                # replica must not stall every /metrics scrape).
                return cached
            self._alertz_refreshing = True
        out = {}
        try:
            for rep in self.replica_set.replicas():
                if rep.state == DOWN:
                    continue
                try:
                    status, body, _ = self._replica_call(
                        rep, "GET", "/alertz",
                        timeout=self.config.read_timeout_s,
                    )
                    if status == 200:
                        out[rep.spec.id] = json.loads(body)
                except Exception:  # noqa: BLE001 — dead replica, not a 500
                    continue
        finally:
            with self._alertz_cache_lock:
                self._alertz_cache = (time.monotonic(), out)
                self._alertz_refreshing = False
        return out

    @staticmethod
    def _merge_sketches(payloads: dict, key: str) -> QuantileSketch | None:
        """Counter-wise merge of one sketch family across replica
        quality payloads — EXACTLY the ``Histogram.merge`` rollup the
        latency histograms use (associative, ladder-checked; pinned
        equal to the by-hand per-replica merge in the quality suite).
        Mismatched-ladder or torn payloads are skipped, never re-binned.
        """
        merged = None
        for payload in payloads.values():
            state = (payload.get("quality") or {}).get("state") or {}
            sk_state = state.get(key)
            if not sk_state:
                continue
            try:
                sk = QuantileSketch.from_state(sk_state, name=key)
                if merged is None:
                    merged = sk
                else:
                    merged.merge(sk)
            except (ValueError, TypeError):
                continue
        return merged

    def quality_merged(self, payloads: dict | None = None) -> dict:
        """The fleet-level quality view: per-replica firing counts plus
        the counter-wise merged LOF-score and community-size sketches."""
        if payloads is None:
            payloads = self._collect_alertz()
        merged = {}
        for key in ("lof_sketch", "size_sketch"):
            sk = self._merge_sketches(payloads, key)
            if sk is not None:
                merged[key] = sk.to_state()
        # No silent truncation: a replica whose /alertz fan-out call
        # failed (e.g. its first post-swap O(V) quality build outran the
        # read timeout) is NAMED, so a partial fleet distribution never
        # reads as a complete one.
        missing = sorted(
            rep.spec.id for rep in self.replica_set.replicas()
            if rep.state != DOWN and rep.spec.id not in payloads
        )
        return {
            **({"replicas_missing": missing} if missing else {}),
            "replicas": {
                rid: {
                    "firing": p.get("firing", 0),
                    "version": p.get("version"),
                    "anomaly_rate": (
                        (p.get("quality") or {}).get("state") or {}
                    ).get("anomaly_rate"),
                }
                for rid, p in payloads.items()
            },
            "firing_total": sum(p.get("firing", 0) for p in payloads.values()),
            "merged": merged,
        }

    def alertz(self) -> dict:
        """The router's ``/alertz``: every replica's alert level state
        plus the fleet-merged quality sketches."""
        payloads = self._collect_alertz()
        return {
            "role": "router",
            "replicas": payloads,
            "quality": self.quality_merged(payloads),
        }

    def statusz(self) -> dict:
        """The fleet SLO page, gap-filled in one place: WAL state + settled ship lag, the current writer
        epoch, per-replica state/breaker with LAST TRANSITION REASONS,
        and the time-to-visible quantiles (per replica + fleet-merged) —
        previously split across the writer's /statusz and the router's
        /fleetz snapshot."""
        rs = self.replica_set
        fleet = rs.snapshot()
        writer = rs.replica(rs.writer_id)
        epoch = rs.writer_epoch
        if epoch is None:
            epoch = writer.last_health.get("writer_epoch")
        ttv: dict = {}
        fam = self.registry.histogram_family(
            "graphmine_fleet_time_to_visible_seconds"
        )
        if fam is not None:
            for child in fam.children():
                s = child.snapshot()
                if not s.count:
                    continue
                ttv[child.labels.get("replica", "?")] = s.summary()
        merged = self.time_to_visible_merged()
        if merged is not None and merged.count:
            ttv["merged"] = merged.snapshot().summary()
        out = {
            "role": "router",
            "committed_version": fleet["committed_version"],
            "writer": rs.writer_id,
            "standby": rs.standby_id,
            "writer_epoch": epoch,
            "read_only": fleet["read_only"],
            "replicas": fleet["replicas"],
            "time_to_visible": ttv,
            # The writer's durable-write state as last probed: the WAL
            # snapshot (pending/applied seqs) is the "settled ship lag"
            # numerator the standby's replication lag pairs with.
            "wal": writer.last_health.get("wal"),
            # fleet-merged result-quality view: counter-wise
            # sketch merge across replicas + per-replica firing counts
            "quality": self.quality_merged(),
            # router-process memory plane: the router holds
            # no snapshot, but its RSS/headroom ride the same section
            # shape as the replicas' so one dashboard reads the fleet
            "memory": self._memory_payload(),
        }
        if rs.standby_id is not None:
            sb = rs.replica(rs.standby_id).last_health
            out["replication"] = {
                "lag_entries": sb.get("replication_lag_entries"),
                "lag_s": sb.get("replication_lag_s"),
            }
        return out

    def _memory_payload(self) -> dict:
        """Router-side memory section: RSS + headroom against
        the process budget, exported as the same ``graphmine_memory_*``
        gauges the replicas serve — the low-headroom alert rule reads
        the identical metric name fleet-wide."""
        out = host_memory(self._mem_budget)
        export_memory_gauges(self.registry, out)
        return out

    def metrics_text(self) -> str:
        # refresh the router's graphmine_memory_* gauges on the scrape
        # itself — a deployment that only reads /metrics must not see
        # absent/stale RSS just because nobody opened /statusz
        self._memory_payload()
        tracer = getattr(self.sink, "tracer", None)
        labels = {"run_id": tracer.run_id} if tracer is not None else None
        text = self.registry.render_textfile(labels=labels)
        merged = self.time_to_visible_merged()
        if merged is not None and merged.count:
            # the fleet-merged rollup rides the same scrape: one
            # counter-wise Histogram.merge of the per-replica children,
            # exposed as its own metric name (one name, one meaning)
            lines = [
                f"# HELP {merged.name} {merged.help}",
                f"# TYPE {merged.name} histogram",
                *merged.render_lines(extra_labels=labels),
            ]
            text += "\n".join(lines) + "\n"
        # Fleet-merged LOF score distribution: the quality
        # sketch rolled up across replicas rides the scrape as a value-
        # domain histogram (buckets are LOF score bounds, not seconds).
        payloads = self._collect_alertz()
        sk = self._merge_sketches(payloads, "lof_sketch")
        if sk is not None and sk.count:
            sk.name = "graphmine_fleet_lof_score_sketch"
            lines = [
                f"# HELP {sk.name} fleet-merged LOF score distribution "
                "(counter-wise quality-sketch merge across replicas)",
                f"# TYPE {sk.name} histogram",
                *sk.render_lines(extra_labels=labels),
            ]
            text += "\n".join(lines) + "\n"
        return text

    def observe(self, endpoint: str, seconds: float, status: int) -> None:
        reg = self.registry
        reg.histogram(
            "graphmine_fleet_request_seconds",
            "router request wall time by endpoint",
            endpoint=endpoint,
        ).observe(seconds)
        reg.counter(
            "graphmine_fleet_requests_total", "requests through the router"
        ).inc()
        if status >= 400:
            reg.counter(
                "graphmine_fleet_errors_total",
                "router requests answered 4xx/5xx",
            ).inc()


class _FleetHandler(BaseHTTPRequestHandler):
    rtr: FleetRouter  # bound by FleetRouter.start

    def log_message(self, fmt, *args):  # noqa: A003 — records, not stderr
        pass

    def _send(
        self, code: int, body: bytes, headers: dict | None = None,
    ) -> None:
        self._status = code
        self.send_response(code)
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        hdrs["Content-Length"] = str(len(body))
        for name, value in hdrs.items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _reply_json(self, code: int, payload: dict) -> None:
        self._send(code, json.dumps(payload).encode())

    def _body(self) -> bytes:
        length = int(self.headers.get("Content-Length", 0))
        return self.rfile.read(length) if length > 0 else b""

    def _serve(self, method: str, routes: dict) -> None:
        url = urlparse(self.path)
        handler = routes.get(url.path)
        endpoint = url.path.lstrip("/") if handler else "unknown"
        self._status = 500
        # Root span per request: each request
        # through the router is its OWN trace — minted fresh, or adopted
        # from a client that already propagates traceparent. Every
        # replica call inside forwards the header (_replica_call), so
        # the whole fleet's handling of this request stitches into one
        # cross-process timeline.
        sink = self.rtr.sink
        span = contextlib.nullcontext()
        if sink is not None and getattr(sink, "tracer", None) is not None:
            ctx = TraceContext.from_header(
                self.headers.get(TRACE_HEADER, "")
            )
            span = sink.span(
                f"fleet:{endpoint}", emit=False, annotate=False,
                remote=ctx, new_trace=ctx is None,
            )
        t0 = time.perf_counter()
        with span:
            try:
                if handler is None:
                    self._reply_json(
                        404, {"error": f"unknown path {url.path!r}"}
                    )
                else:
                    getattr(self, handler)(url)
            except OSError:
                self._status = 499  # client closed; nothing more to send
            except Exception as e:  # noqa: BLE001 — the router must answer
                try:
                    self._reply_json(500, {"error": repr(e)})
                except OSError:
                    self._status = 499
            finally:
                self.rtr.observe(
                    endpoint, time.perf_counter() - t0, self._status
                )

    def do_GET(self) -> None:  # noqa: N802
        self._serve("GET", _GET_ROUTES)

    def do_POST(self) -> None:  # noqa: N802
        self._serve("POST", _POST_ROUTES)

    # -- routes ------------------------------------------------------------
    def _ep_healthz(self, url) -> None:
        self._reply_json(200, self.rtr.healthz())

    def _ep_fleetz(self, url) -> None:
        self._reply_json(200, self.rtr.fleetz())

    def _ep_statusz(self, url) -> None:
        self._reply_json(200, self.rtr.statusz())

    def _ep_alertz(self, url) -> None:
        self._reply_json(200, self.rtr.alertz())

    def _ep_metrics(self, url) -> None:
        self._send(
            200, self.rtr.metrics_text().encode(),
            {"Content-Type": "text/plain; version=0.0.4; charset=utf-8"},
        )

    def _ep_read(self, url) -> None:
        path_qs = url.path + (f"?{url.query}" if url.query else "")
        body = self._body() if self.command == "POST" else None
        status, resp, headers = self.rtr.route_read(
            self.command, path_qs, body, self.headers
        )
        self._send(status, resp, headers)

    def _ep_write(self, url) -> None:
        # keep the query string: ?tenant= is the header-less tenant
        # spelling and must survive the router hop like X-Tenant-Id does
        path_qs = url.path + (f"?{url.query}" if url.query else "")
        status, resp, headers = self.rtr.forward_write(
            path_qs, self._body(), self.headers
        )
        self._send(status, resp, headers)

    def _ep_roll(self, url) -> None:
        out = self.rtr.rolling_reload()
        self._reply_json(200 if out.get("ok") else 409, out)

    def _ep_promote(self, url) -> None:
        out = self.rtr.promote_standby()
        self._reply_json(200 if out.get("ok") else 409, out)
