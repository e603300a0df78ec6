"""Deterministic fault injection: every recovery path exercised on the CPU.

Counterpart of the pipeline and serving parts of
``graphmine_tpu/testing/faults.py``.
A :class:`FaultInjector` installs into the
:func:`graphmine_tpu_torch.pipeline.resilience.fault_point` seam and raises
a planned error the Nth time a named site is hit::

    inj = FaultInjector()
    inj.add("lpa_superstep", transient_error, at=2)      # 2nd superstep
    inj.add("lpa_superstep", oom_error, at=4, repeat=2)  # 4th AND 5th hit
    with inj.installed():
        run_pipeline(cfg)
    assert inj.fired("lpa_superstep") == 1

Sites in the driver: ``load``, ``build_graph``, ``lpa_superstep`` (ctx:
``iteration``, ``variant``, ``state``), ``census``, ``outliers_recursive``,
``outliers_lof``, ``snapshot_publish``.

The factories return the errors the production classifier sees on the
card: :func:`oom_error` is a ``torch.cuda.OutOfMemoryError`` carrying the
caching allocator's message, :func:`device_oom` provokes a real one from
the allocator, so :func:`~graphmine_tpu_torch.pipeline.resilience.classify_error`
is the code under test. :func:`device_loss` reads as a dead device
(the elastic mesh rungs answer it). :func:`poison_labels` corrupts the
driver's label state without raising (the tripwires must catch it);
:func:`hang` sleeps (the watchdog must bound it); :func:`corrupt_file`,
:func:`truncate_file`, :func:`corrupt_shard` and :func:`corrupt_manifest`
damage checkpoints in place.

Serving: :func:`slow_repair` stalls every delta apply at the
``delta_repair`` seam (``serve/delta.py::_verify_or_fallback``, ctx:
``state``, ``num_shards``, ``tenant``), :func:`delta_burst` draws seeded
``POST /delta`` payloads, :func:`noisy_neighbor_burst` aims a burst and a
tenant-scoped stall at one tenant, and :func:`slow_client_post` dribbles a
request body to a live server.

Fleet and replicated writers: :func:`replica_kill` and
:func:`writer_kill_mid_apply` kill a replica's listener in place,
:func:`replica_slow` stalls every request of one replica,
:func:`replica_stale` pins one replica's version, :func:`wal_torn_tail`
tears a write-ahead log's newest segment, :func:`ship_lag` slows a
standby's log shipping, :func:`writer_shard_kill` kills one range of the
sharded write plane and :func:`shard_publish_torn` crashes its epoch
commit between stage and commit.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field

import torch

from graphmine_tpu_torch.pipeline import resilience


class InjectedTransientError(Exception):
    """Looks like transient device/RPC weather; classified retryable."""


class SimulatedPreemption(Exception):
    """A preempted worker: the process dies mid-run. Fatal by contract:
    recovery is a new run resuming from the checkpoint."""

    graphmine_error_class = resilience.FATAL


class InjectedDeviceLoss(Exception):
    """Looks like a dead device or a torn link; classified
    degradable_device (the elastic mesh rungs respond)."""


def transient_error() -> Exception:
    return InjectedTransientError(
        "UNAVAILABLE: socket closed; failed to connect to remote runtime "
        "(injected fault)"
    )


def oom_error() -> Exception:
    """The caching allocator's out-of-memory error, as it reads on the
    card."""
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 8.79 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.02 GiB is free. Of the allocated "
        "memory 76.50 GiB is allocated by PyTorch (injected fault)"
    )


def device_oom(device) -> Exception:
    """A real ``torch.cuda.OutOfMemoryError`` from the caching allocator
    of CUDA ``device`` (a 256 TiB request), caught and returned so the
    injector raises it; on any other device, :func:`oom_error`."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return oom_error()
    try:
        torch.empty(1 << 48, dtype=torch.uint8, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        return e
    raise RuntimeError("a 256 TiB allocation succeeded")


def preemption() -> Exception:
    return SimulatedPreemption("worker preempted (injected fault)")


def device_loss(chip: int = 2) -> Exception:
    """A device failure mid-exchange, classified by its message (the JAX
    package's words, so the classifier is the code under test); the chip
    index is what the driver routes its rung meshes around."""
    return InjectedDeviceLoss(
        f"DATA_LOSS: device failure on chip {chip}: ICI link down during "
        "all-gather (injected fault)"
    )


def poison_labels(shard: int, num_shards: int, value: int = -7):
    """A ctx-aware mutator: overwrites shard ``shard`` of a
    ``num_shards`` split of the driver's label tensor with ``value`` (an
    id outside the vertex range) on its device, and raises nothing.
    Install at ``lpa_superstep``, whose ctx carries the driver's state."""

    def _mutate(**ctx):
        state = ctx.get("state")
        if state is None or "labels" not in state:
            raise ValueError(
                "poison_labels needs a fault site whose ctx carries the "
                "driver's mutable state (lpa_superstep)"
            )
        labels = torch.as_tensor(state["labels"]).clone()
        chunk = -(-labels.shape[0] // num_shards)
        labels[shard * chunk: (shard + 1) * chunk] = value
        state["labels"] = labels
        return None

    _mutate.wants_ctx = True
    return _mutate


# Parked hang() sleepers, each on its own event, released when the
# injector is uninstalled.
_sleepers_lock = threading.Lock()
_sleepers: list = []


def _release_abandoned_sleepers() -> None:
    with _sleepers_lock:
        for ev in _sleepers:
            ev.set()
        _sleepers.clear()


def _parked_sleep(seconds: float) -> None:
    """A ``seconds`` sleep that ends early when the injector is
    uninstalled (shared by :func:`hang` and the serving stalls)."""
    ev = threading.Event()
    with _sleepers_lock:
        _sleepers.append(ev)
    ev.wait(seconds)
    with _sleepers_lock:
        if ev in _sleepers:
            _sleepers.remove(ev)


def hang(seconds: float):
    """A 'factory' that sleeps instead of raising: a hung step for the
    watchdog. The sleep ends early when the injector is uninstalled."""

    def _sleep():
        _parked_sleep(seconds)
        return None

    _sleep.is_hang = True
    return _sleep


@dataclass
class _Rule:
    site: str
    factory: object          # () -> Exception, a hang() sleeper or a mutator
    at: int                  # 1-based hit index at which to fire
    repeat: int = 1          # fire on this many consecutive hits
    fired: int = 0


@dataclass
class FaultInjector:
    """Deterministic site/hit-count fault plan (see the module note)."""

    rules: list = field(default_factory=list)
    hits: dict = field(default_factory=dict)
    log: list = field(default_factory=list)  # (site, hit, ctx) of every hit

    def add(self, site: str, factory, at: int = 1, repeat: int = 1) -> "FaultInjector":
        if at < 1 or repeat < 1:
            raise ValueError("at and repeat are 1-based positive counts")
        self.rules.append(_Rule(site=site, factory=factory, at=at, repeat=repeat))
        return self

    def fired(self, site: str | None = None) -> int:
        return sum(r.fired for r in self.rules if site is None or r.site == site)

    def __call__(self, site: str, **ctx) -> None:
        n = self.hits[site] = self.hits.get(site, 0) + 1
        self.log.append((site, n, ctx))
        for r in self.rules:
            if r.site == site and r.at <= n < r.at + r.repeat:
                r.fired += 1
                out = r.factory(**ctx) if getattr(r.factory, "wants_ctx", False) else r.factory()
                if out is not None:  # hang() and mutators return None
                    raise out

    @contextlib.contextmanager
    def installed(self):
        """Install into the resilience seam for the block (one injector
        at a time per process)."""
        resilience.set_fault_hook(self)
        try:
            yield self
        finally:
            resilience.set_fault_hook(None)
            _release_abandoned_sleepers()


# ---- serving injectors: write-path overload and slow clients --------------


def slow_repair(seconds: float):
    """A slowed delta repair: install at the ``delta_repair`` seam
    (``serve/delta.py::_verify_or_fallback``) with ``repeat=`` covering
    the burst, and every apply stalls ``seconds`` before verifying —
    the deterministic stand-in for a repair that outgrew its working
    set. Unlike :func:`hang` it is the APPLY PATH that slows, so queued
    deltas pile up behind the publish worker and the admission ladder
    (coalesce → defer → shed) is what keeps the backlog bounded. The
    sleep is interruptible on injector uninstall, and the repaired
    state passes through untouched (``wants_ctx`` so the ctx-carrying
    seam doesn't hand a positional payload to a plain factory)."""

    def _stall(**ctx):
        _parked_sleep(seconds)
        return None

    _stall.wants_ctx = True
    _stall.is_slow_repair = True
    return _stall


def delta_burst(
    num_vertices: int,
    batches: int,
    rows_per_batch: int,
    seed: int = 0,
    delete_frac: float = 0.0,
    base_src=None,
    base_dst=None,
):
    """Deterministic write-burst generator: ``batches`` POST /delta
    payload dicts of ``rows_per_batch`` rows each, drawn from a seeded
    RNG so a chaos test's admission verdicts replay identically.
    ``delete_frac`` of each batch's rows are deletes sampled from
    ``base_src``/``base_dst`` (matching deletes) when given, else from
    the id space (mostly-unmatched deletes — the quarantine path)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_del = int(rows_per_batch * delete_frac)
    n_ins = rows_per_batch - n_del
    payloads = []
    for _ in range(batches):
        ins = rng.integers(0, num_vertices, size=(n_ins, 2))
        payload = {"insert": ins.tolist()}
        if n_del:
            if base_src is not None and len(base_src):
                idx = rng.integers(0, len(base_src), n_del)
                payload["delete"] = [
                    [int(base_src[i]), int(base_dst[i])] for i in idx
                ]
            else:
                payload["delete"] = rng.integers(
                    0, num_vertices, size=(n_del, 2)
                ).tolist()
        payloads.append(payload)
    return payloads


def noisy_neighbor_burst(
    tenant: str,
    num_vertices: int,
    batches: int,
    rows_per_batch: int,
    seed: int = 0,
    stall_s: float = 0.0,
):
    """The multi-tenant abuse kit: one tenant hammering a
    shared server while its co-tenants must stay within SLO. Returns
    ``(payloads, staller)``:

    - ``payloads``: a :func:`delta_burst` aimed at ``tenant`` (POST each
      with ``X-Tenant-Id: <tenant>``);
    - ``staller``: a ``delta_repair``-seam injector that stalls
      ``stall_s`` **only when the apply belongs to** ``tenant`` — the
      ctx's ``tenant`` key, threaded from the ingestor's store — so the
      abusive tenant's applies become expensive while B's and C's stay
      fast. ``None`` when ``stall_s`` is 0 (pure volume abuse).

    Install the staller with ``repeat=`` covering the burst; the
    JAX package's acceptance test (tests/test_tenancy.py) asserts from live endpoints
    that the victims' reads hold p99, their deltas keep publishing with
    zero sheds charged to the abuser's debt, and only the abuser's
    alert plane fires."""
    payloads = delta_burst(
        num_vertices, batches, rows_per_batch, seed=seed,
    )

    staller = None
    if stall_s > 0:

        def _tenant_stall(**ctx):
            if ctx.get("tenant") == tenant:
                _parked_sleep(stall_s)
            return None

        _tenant_stall.wants_ctx = True
        _tenant_stall.is_slow_repair = True
        staller = _tenant_stall
    return payloads, staller


def slow_client_post(
    host: str,
    port: int,
    path: str,
    payload: dict,
    chunk_bytes: int = 8,
    delay_s: float = 0.01,
    timeout_s: float = 30.0,
):
    """POST ``payload`` dribbling the body ``chunk_bytes`` at a time with
    ``delay_s`` between writes — the slow-loris-shaped client a threaded
    server must tolerate without stalling OTHER requests (each handler
    thread blocks only on its own socket). Returns
    ``(status_code, parsed_json_body)``."""
    import json as _json
    import socket

    body = _json.dumps(payload).encode()
    head = (
        f"POST {path} HTTP/1.1\r\nHost: {host}:{port}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\nConnection: close\r\n\r\n"
    ).encode()
    with socket.create_connection((host, port), timeout=timeout_s) as sock:
        sock.sendall(head)
        for i in range(0, len(body), chunk_bytes):
            sock.sendall(body[i: i + chunk_bytes])
            if delay_s:
                import time as _time

                _time.sleep(delay_s)
        raw = b""
        while True:
            got = sock.recv(65536)
            if not got:
                break
            raw += got
    status_line, _, rest = raw.partition(b"\r\n")
    status = int(status_line.split()[1])
    _, _, resp_body = rest.partition(b"\r\n\r\n")
    return status, _json.loads(resp_body.decode())


# ---- fleet / replicated-writer injectors ------------------------------------
# The per-replica seams (SnapshotServer.chaos_delay_s and
# chaos_hold_version, per-instance attributes the production middleware and
# reload() consult) are zero-cost no-ops in production and deterministic
# handles in chaos tests. Host-only: none of them touches a device.


def replica_kill(server) -> None:
    """Hard-kill a replica's HTTP listener in place — every subsequent
    connection is refused, exactly what the fleet router sees when a
    replica process dies. Unlike ``SnapshotServer.stop()`` there is no
    graceful queue drain: the 'process' just stops answering. The
    Python object survives, so the test can still inspect its state;
    'restarting the replica' is constructing a fresh SnapshotServer on
    the same port (ThreadingHTTPServer sets SO_REUSEADDR)."""
    httpd = server._httpd
    server._httpd = None
    if httpd is not None:
        httpd.shutdown()
        httpd.server_close()
    t = server._thread
    server._thread = None
    if t is not None:
        t.join(timeout=10)


def replica_slow(server, seconds: float) -> None:
    """Slow ONE replica: every request (including its /healthz) stalls
    ``seconds`` before handling. With the fleet's generous probe timeout
    the replica stays alive-and-healthy while its data-plane latency
    blows the router's per-attempt read timeout — the exact shape that
    must open the per-replica circuit breaker rather than mark the
    replica down. ``replica_slow(server, 0.0)`` heals it."""
    server.chaos_delay_s = float(seconds)


def wal_torn_tail(wal_root: str, cut_bytes: int = 7) -> str:
    """Tear the tail of the newest write-ahead-log segment in place —
    the bytes a kill mid-append leaves behind (a frame whose payload
    never finished). ``cut_bytes`` lands inside the final record's
    payload, so the sha256 (or the length) can no longer verify; the
    next :class:`~graphmine_tpu_torch.serve.wal.WriteAheadLog` open must keep
    every record BEFORE the tear, truncate it, and keep appending —
    never refuse the whole log. Returns the damaged segment path."""
    import glob as _glob

    segs = sorted(_glob.glob(os.path.join(wal_root, "wal-*.seg")))
    if not segs:
        raise ValueError(f"no WAL segments under {wal_root!r} to tear")
    path = segs[-1]
    size = os.path.getsize(path)
    keep = max(8, size - max(1, cut_bytes))  # never cut into the magic
    with open(path, "r+b") as f:
        f.truncate(keep)
    return path


def writer_kill_mid_apply(server) -> None:
    """SIGKILL-shaped writer loss for an in-process chaos test: the
    HTTP listener dies instantly (every later connection refused — what
    the fleet prober sees when the writer process is killed) while the
    apply worker is left RUNNING with whatever it already popped — the
    zombie half of a killed writer. That zombie's eventual publish is
    exactly the deposed-writer comeback the store's epoch fence must
    refuse once the standby is promoted (``publish_fenced``); its
    WAL-durable queue survives on disk for the promotion replay. (A
    real SIGKILL also stops the worker — in-process we cannot kill a
    thread, and leaving it grinding makes the test STRICTER: the fence,
    not process death, is what protects the store.)"""
    replica_kill(server)


def ship_lag(server_or_shipper, seconds: float) -> None:
    """Slow ONE standby's log shipping: every poll of the primary's
    /wal stalls ``seconds`` first — the deterministic stand-in for a
    congested replication link. The standby stays healthy and serving
    reads while its replication lag (the /healthz gauge pair) grows;
    ``ship_lag(x, 0.0)`` heals. Accepts a SnapshotServer (standby) or a
    LogShipper."""
    shipper = getattr(server_or_shipper, "_shipper", server_or_shipper)
    if shipper is None or not hasattr(shipper, "chaos_delay_s"):
        raise ValueError(
            "ship_lag needs a standby server (standby_of=...) or a "
            "LogShipper"
        )
    shipper.chaos_delay_s = float(seconds)


def writer_shard_kill(server, shard: int, tenant: str = "default") -> None:
    """Kill ONE vertex-range writer shard of a sharded write plane
    (serve/shardplane.py): the shard's WAL handle closes
    un-flushed and its range flips read-only — batches touching it
    refuse 503 while every OTHER range keeps accepting writes. The
    restart is ``plane.restart_shard(shard)`` (per-range WAL replay;
    acked sub-batches survive by append-time fsync) or a standby
    promotion via ``plane.promote_shard``. Acts on an in-process
    SnapshotServer started with ``writer_shards > 1``."""
    ts = server._tenants.get(tenant)
    plane = getattr(ts, "plane", None) if ts is not None else None
    if plane is None:
        raise ValueError(
            f"writer_shard_kill needs a server running with "
            f"writer_shards > 1 (tenant {tenant!r} has no shard plane)"
        )
    plane.kill_shard(int(shard), reason="writer_shard_kill")


def shard_publish_torn(at: int = 1, repeat: int = 1) -> FaultInjector:
    """A coordinator crash BETWEEN stage and commit: every shard's
    per-range arrays are staged, the ``publish_epoch`` record is never
    written. Returns a ready-to-install :class:`FaultInjector` targeting
    the ``shard_publish_commit`` seam (inside the store's fence lock,
    before the stage→final rename). The recovery contract: readers keep
    serving the PREVIOUS committed epoch, and the next startup's
    ``EpochCoordinator.recover()`` finishes the staged generation (or
    sweeps an incomplete one) — never a half-visible epoch."""
    inj = FaultInjector()
    inj.add("shard_publish_commit", preemption, at=at, repeat=repeat)
    return inj


def replica_stale(server, hold: bool = True) -> None:
    """Pin ONE replica to its current snapshot version: /reload becomes
    a no-op (``swapped: false, held: true``), so the replica falls
    behind every publish — the stale replica the committed-version rule
    must keep out of the read path without ever surfacing a
    mixed-version answer. ``replica_stale(server, False)`` releases."""
    server.chaos_hold_version = bool(hold)


def corrupt_file(path: str, offset: int = -64, nbytes: int = 16) -> None:
    """Flip ``nbytes`` bytes in place at ``offset`` (negative = from EOF):
    by default inside the last zip member of a small ``.npz``."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path!r} is empty; nothing to corrupt")
    pos = offset % size
    nbytes = min(nbytes, size - pos)
    with open(path, "r+b") as f:
        f.seek(pos)
        chunk = f.read(nbytes)
        f.seek(pos)
        f.write(bytes(b ^ 0xFF for b in chunk))


def corrupt_shard(checkpoint_dir: str, shard: int, tag: str = "lpa") -> str:
    """Flip bytes inside one shard file of the current sharded-checkpoint
    generation; returns the damaged path."""
    from graphmine_tpu_torch.pipeline import checkpoint as ckpt

    path = ckpt.shard_file(ckpt.sharded_dir(checkpoint_dir, tag), shard)
    corrupt_file(path)
    return path


def corrupt_manifest(checkpoint_dir: str, tag: str = "lpa") -> str:
    """Flip bytes inside the manifest of the current sharded-checkpoint
    generation (a wrong checksum or broken JSON; both roll back); returns
    the damaged path."""
    from graphmine_tpu_torch.pipeline import checkpoint as ckpt

    path = os.path.join(ckpt.sharded_dir(checkpoint_dir, tag), ckpt.MANIFEST_NAME)
    corrupt_file(path)
    return path


def truncate_file(path: str, keep_fraction: float = 0.5) -> None:
    """Truncate a file to ``keep_fraction`` of its bytes (a torn write)."""
    if not 0 <= keep_fraction < 1:
        raise ValueError("keep_fraction must be in [0, 1)")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(int(size * keep_fraction))
