"""Vertex-range sharded write plane and epoch-coordinated publish.

Counterpart of ``graphmine_tpu/serve/shardplane.py``, whole, with the same
records, directory layout and commit-record format, so either package
commits and reads the other's epoch directories. Host code: nothing here
touches a device. On one card the plane splits the write-ahead log,
admission and repair debt by vertex range; the apply still runs once, on
the reassembled batch.

- :class:`ShardPlan`: a deterministic partition of the vertex-id space
  into contiguous ranges (``GRAPHMINE_WRITER_SHARDS``; 1 = the unsharded
  path). Edge ownership is the dst range; inserts whose dst lands past the
  plan's vertex space (graph growth) belong to the last shard, so two
  holders of one plan agree on every row's owner.
- :func:`split_delta` / :func:`merge_splits`: a batch touching k ranges
  becomes k sub-batches, each carrying its original row indices, and the
  merge gives back the batch bit-identically. The idempotency key
  propagates as ``(delta_id, shard)``: each shard's log dedupes the id on
  its own, so a retry after a partial accept appends only where it was
  missing. Sub-batches have disjoint dst ranges and so disjoint delete
  keys, and :func:`~graphmine_tpu_torch.serve.delta.splice_edges` deletes
  only from the base arrays, so per-shard applies commute.
- :class:`ShardedWritePlane`: per range, its own
  :class:`~graphmine_tpu_torch.serve.wal.WriteAheadLog` (shard-labelled
  gauges), :class:`~graphmine_tpu_torch.serve.admission.AdmissionController`,
  :class:`~graphmine_tpu_torch.serve.delta.RepairDebt` and optional
  standby copy. A dead shard flips only its range read-only; a restart
  replays its log tail, and a standby promotion mints its epoch through
  the store's fence lock.
- :class:`EpochCoordinator`: two-phase commit over the store's fence
  lock. Shards stage per-range array files with per-shard manifests, then
  the coordinator commits a durable ``publish_epoch`` record mapping epoch
  to the per-shard version vector. Readers serve the latest committed
  epoch, so a multi-range batch becomes visible whole or not at all; a
  crash between stage and commit (the ``shard_publish_commit`` fault seam)
  leaves the previous epoch served, and :meth:`EpochCoordinator.recover`
  finishes a complete stage or sweeps an incomplete one.

Every ``shard_publish`` / ``epoch_commit`` / ``shard_degraded`` record is
built by :func:`emit_shard_record`.
"""

from __future__ import annotations

import bisect as _bisect
import glob
import json
import os
import shutil
import threading
import time
from dataclasses import dataclass

import numpy as np

from graphmine_tpu_torch.pipeline import resilience
from graphmine_tpu_torch.pipeline.checkpoint import (
    _file_sha256,
    _fsync_dir,
    _fsync_file,
    _manifest_checksum,
)
from graphmine_tpu_torch.serve.admission import AdmissionBounds, AdmissionController
from graphmine_tpu_torch.serve.delta import EdgeDelta, RepairDebt
from graphmine_tpu_torch.serve.snapshot import (
    EPOCHS_DIRNAME,
    MANIFEST_NAME,
    _NAME_RE,
)
from graphmine_tpu_torch.serve.tenancy import DEFAULT_TENANT
from graphmine_tpu_torch.serve.wal import WriteAheadLog

ENV_WRITER_SHARDS = "GRAPHMINE_WRITER_SHARDS"
SHARDS_DIRNAME = "shards"
_EPOCH_FMT = "epoch-%08d"
_FORMAT_VERSION = 1

# The record family this module owns; every emit goes through
# emit_shard_record so the schema contract has ONE enforcement point.
SHARD_RECORD_PHASES = frozenset(
    ("shard_publish", "epoch_commit", "shard_degraded")
)


def emit_shard_record(sink, phase: str, **kv) -> None:
    """THE single builder for the shard-plane record family. A phase
    outside :data:`SHARD_RECORD_PHASES` raises (a typo'd phase must die
    here, not rot the JSONL); a ``None`` sink is a no-op so plane code
    never branches on observability being attached."""
    if phase not in SHARD_RECORD_PHASES:
        raise ValueError(
            f"emit_shard_record owns only {sorted(SHARD_RECORD_PHASES)}, "
            f"not {phase!r}"
        )
    if sink is None:
        return
    sink.emit(phase, **kv)


class ShardRangeUnavailableError(RuntimeError):
    """A batch touched a vertex range whose writer shard is degraded
    (killed, read-only, awaiting promotion). Retryable — the HTTP layer
    answers 503 + Retry-After; batches touching only healthy ranges are
    unaffected, which is the whole point of range sharding."""

    def __init__(self, message: str, shards=()):
        super().__init__(message)
        self.shards = tuple(int(s) for s in shards)


def writer_shards_from_env(default: int = 1) -> int:
    """Resolve ``GRAPHMINE_WRITER_SHARDS`` (malformed values fail
    loudly — a typo'd shard count silently falling back to 1 would
    un-shard a deployment without a trace)."""
    raw = os.environ.get(ENV_WRITER_SHARDS)
    if raw is None:
        return int(default)
    try:
        n = int(raw)
    except ValueError as e:
        raise ValueError(f"{ENV_WRITER_SHARDS}={raw!r} is not an int") from e
    if n < 1:
        raise ValueError(f"{ENV_WRITER_SHARDS}={n} must be >= 1")
    return n


@dataclass(frozen=True)
class ShardPlan:
    """Contiguous vertex-range partition of ``[0, num_vertices)`` into
    ``num_shards`` ranges. Frozen: ranges never rebalance mid-flight —
    rows for vertices born after the plan (graph growth) belong to the
    LAST shard by rule, so every holder of the plan routes identically
    forever."""

    num_shards: int
    num_vertices: int
    boundaries: tuple  # len num_shards + 1; [0, ..., num_vertices]

    @classmethod
    def build(cls, num_shards: int, num_vertices: int) -> "ShardPlan":
        k = int(num_shards)
        if k < 1:
            raise ValueError(f"num_shards must be >= 1, got {k}")
        v = max(0, int(num_vertices))
        chunk = -(-v // k) if v else 0  # ceil-div
        bounds = [min(v, i * chunk) for i in range(k + 1)]
        bounds[-1] = v
        return cls(k, v, tuple(bounds))

    @classmethod
    def from_env(cls, num_vertices: int, default: int = 1) -> "ShardPlan":
        return cls.build(writer_shards_from_env(default), num_vertices)

    def owner_of(self, vertex: int) -> int:
        """The shard owning ``vertex``; ids at/past ``num_vertices``
        (growth) belong to the last shard."""
        i = _bisect.bisect_right(self.boundaries, int(vertex)) - 1
        return min(max(i, 0), self.num_shards - 1)

    def owners(self, vertices) -> np.ndarray:
        """Vectorized :meth:`owner_of` over a dst column."""
        v = np.asarray(vertices, np.int64)
        idx = (
            np.searchsorted(
                np.asarray(self.boundaries, np.int64), v, side="right"
            )
            - 1
        )
        return np.clip(idx, 0, self.num_shards - 1).astype(np.int64)

    def range_of(self, shard: int) -> tuple[int, int]:
        s = int(shard)
        if not 0 <= s < self.num_shards:
            raise IndexError(f"shard {s} outside plan of {self.num_shards}")
        return int(self.boundaries[s]), int(self.boundaries[s + 1])

    def ranges(self) -> list[dict]:
        """The range table (fleet_cli ``status --shards`` / serve_cli
        ``info`` render this)."""
        return [
            {
                "shard": s,
                "lo": self.boundaries[s],
                "hi": self.boundaries[s + 1],
                "owns_growth": s == self.num_shards - 1,
            }
            for s in range(self.num_shards)
        ]

    def snapshot(self) -> dict:
        return {
            "num_shards": self.num_shards,
            "num_vertices": self.num_vertices,
            "boundaries": list(self.boundaries),
        }


@dataclass(frozen=True)
class DeltaSplit:
    """One shard's sub-batch plus the ORIGINAL row indices it came from
    (positions into the unsplit batch's insert/delete arrays) — what
    makes :func:`merge_splits` a bit-exact inverse."""

    shard: int
    delta: EdgeDelta
    insert_index: np.ndarray
    delete_index: np.ndarray


def split_delta(delta: EdgeDelta, plan: ShardPlan) -> list[DeltaSplit]:
    """Deterministically split one batch by dst-range ownership.

    Cross-range deletes (src in range A, dst in range B) route to B —
    the dst owner, same rule as inserts, so the shard that owns an
    edge's insert also owns its delete. Returns only TOUCHED shards
    (ascending); an empty batch routes to shard 0 so its accounting has
    a home. ``plan.num_shards == 1`` short-circuits to one whole-batch
    split — the exact pre-shard path, zero array work."""
    n_ins, n_del = delta.num_inserts, delta.num_deletes
    if plan.num_shards == 1:
        return [
            DeltaSplit(
                0, delta,
                np.arange(n_ins, dtype=np.int64),
                np.arange(n_del, dtype=np.int64),
            )
        ]
    ins_owner = plan.owners(delta.insert_dst)
    del_owner = plan.owners(delta.delete_dst)
    out = []
    for s in range(plan.num_shards):
        ii = np.flatnonzero(ins_owner == s)
        di = np.flatnonzero(del_owner == s)
        if not len(ii) and not len(di):
            continue
        out.append(DeltaSplit(s, delta.take(ii, di), ii, di))
    if not out:
        out.append(
            DeltaSplit(
                0, delta,
                np.arange(0, dtype=np.int64), np.arange(0, dtype=np.int64),
            )
        )
    return out


def merge_splits(splits: list) -> EdgeDelta:
    """Reassemble the original batch from its splits, bit-identically:
    every row scatters back to its original position, weights included.
    The inverse of :func:`split_delta` — pinned by the randomized
    splitter-parity tests."""
    n_ins = sum(len(sp.insert_index) for sp in splits)
    n_del = sum(len(sp.delete_index) for sp in splits)
    isrc = np.empty(n_ins, np.int64)
    idst = np.empty(n_ins, np.int64)
    dsrc = np.empty(n_del, np.int64)
    ddst = np.empty(n_del, np.int64)
    weighted = any(sp.delta.insert_weight is not None for sp in splits)
    iw = np.empty(n_ins, np.float32) if weighted else None
    for sp in splits:
        ii, di = sp.insert_index, sp.delete_index
        isrc[ii] = sp.delta.insert_src
        idst[ii] = sp.delta.insert_dst
        dsrc[di] = sp.delta.delete_src
        ddst[di] = sp.delta.delete_dst
        if weighted:
            iw[ii] = (
                sp.delta.insert_weight
                if sp.delta.insert_weight is not None
                else np.ones(len(ii), np.float32)
            )
    return EdgeDelta(isrc, idst, dsrc, ddst, insert_weight=iw)


# ---- epoch-coordinated publish ---------------------------------------------


class EpochCoordinator:
    """Two-phase commit of per-range array generations over the snapshot
    store's flock fence.

    On-disk layout under ``<store.root>/epochs/``::

        epoch-00000007.stage/shard-000/{labels.npy, ..., manifest.json}
        epoch-00000007/       (renamed from .stage at commit)
        epoch-00000007.json   (the durable publish_epoch commit record)

    State machine:

    1. :meth:`stage` writes every shard's arrays + a manifest
       (per-file sha256 + whole-manifest checksum, each file fsync'd)
       into the ``.stage`` directory. Nothing is visible yet.
    2. :meth:`commit` — under the store's fence lock — passes the
       ``shard_publish_commit`` fault seam, renames stage→final, fsyncs,
       then durably writes the ``publish_epoch`` commit record
       (tmp + fsync + rename). **The record IS the commit point**:
       readers key off :meth:`committed_epoch` = the highest epoch with
       a valid record, so a crash anywhere before the record leaves the
       previous epoch served, in full.
    3. :meth:`recover` (restart path, also under the fence lock)
       finishes a complete-but-uncommitted generation — re-running just
       the commit leg — or sweeps an incomplete stage. Either way the
       store converges on a committed epoch.

    One coordinator per store root is the concurrency contract (the
    fence lock serializes commits against promotions and each other).
    """

    RETAIN_EPOCHS = 2

    def __init__(self, store, plan: ShardPlan, sink=None):
        self.store = store
        self.plan = plan
        self.sink = sink
        self.root = os.path.join(store.root, EPOCHS_DIRNAME)

    # -- paths ------------------------------------------------------------
    def _final_dir(self, epoch: int) -> str:
        return os.path.join(self.root, _EPOCH_FMT % int(epoch))

    def _stage_dir(self, epoch: int) -> str:
        return self._final_dir(epoch) + ".stage"

    def _record_path(self, epoch: int) -> str:
        return self._final_dir(epoch) + ".json"

    # -- stage ------------------------------------------------------------
    def stage(
        self,
        epoch: int,
        shard_arrays: dict,
        versions: dict | None = None,
    ) -> str:
        """Write every shard's per-range arrays into the epoch's stage
        directory. ``shard_arrays`` maps shard → {name: np.ndarray};
        ``versions`` maps shard → the snapshot version whose apply last
        touched that range (the vector the commit record publishes).
        Emits one ``shard_publish`` record per shard. Restaging an
        epoch replaces its previous stage (a crashed attempt's leftovers
        never mix into a fresh one)."""
        epoch = int(epoch)
        versions = versions or {}
        stage = self._stage_dir(epoch)
        shutil.rmtree(stage, ignore_errors=True)
        os.makedirs(stage)
        for shard in sorted(shard_arrays):
            arrays = shard_arrays[shard]
            sdir = os.path.join(stage, f"shard-{int(shard):03d}")
            os.makedirs(sdir)
            entries, total = {}, 0
            for name in sorted(arrays):
                if not _NAME_RE.match(name):
                    raise ValueError(f"unsafe shard array name {name!r}")
                arr = np.asarray(arrays[name])
                fname = f"{name}.npy"
                path = os.path.join(sdir, fname)
                np.save(path, arr)
                _fsync_file(path)
                total += int(arr.nbytes)
                entries[name] = {
                    "file": fname,
                    "sha256": _file_sha256(path),
                    "dtype": str(arr.dtype),
                    "shape": list(arr.shape),
                }
            lo, hi = self.plan.range_of(shard)
            body = {
                "format_version": _FORMAT_VERSION,
                "epoch": epoch,
                "shard": int(shard),
                "num_shards": self.plan.num_shards,
                "range": [lo, hi],
                "version": int(versions.get(shard, 0)),
                "created": time.time(),
                "arrays": entries,
            }
            body["checksum"] = _manifest_checksum(body)
            man_tmp = os.path.join(sdir, MANIFEST_NAME + ".tmp")
            with open(man_tmp, "w") as f:
                json.dump(body, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            os.replace(man_tmp, os.path.join(sdir, MANIFEST_NAME))
            _fsync_dir(sdir)
            emit_shard_record(
                self.sink, "shard_publish",
                epoch=epoch, shard=int(shard),
                version=int(versions.get(shard, 0)),
                arrays=sorted(arrays), bytes=total,
                range=[lo, hi],
            )
        _fsync_dir(stage)
        return stage

    # -- commit -----------------------------------------------------------
    def commit(self, epoch: int, version_vector: dict) -> dict:
        """Durably commit a staged epoch (two-phase commit, leg two).
        Serialized through the store's fence lock — the same lock every
        promotion's epoch mint takes, so a commit can never interleave
        with a fence transition. Raises if the stage is missing (a
        recover() swept it, or stage() was never called)."""
        epoch = int(epoch)
        stage, final = self._stage_dir(epoch), self._final_dir(epoch)
        with self.store.fence_lock():
            # Torn-publish seam (testing/faults.shard_publish_torn): a
            # coordinator crash injected here (every shard staged,
            # nothing committed) must leave the previous epoch served
            # and this generation recoverable.
            resilience.fault_point("shard_publish_commit", epoch=epoch)
            if os.path.isdir(stage):
                shutil.rmtree(final, ignore_errors=True)
                os.replace(stage, final)
                _fsync_dir(self.root)
            elif not os.path.isdir(final):
                raise FileNotFoundError(
                    f"epoch {epoch} has no staged generation at {stage!r} "
                    "to commit (stage() first, or recover() swept an "
                    "incomplete one)"
                )
            record = self._write_record_locked(epoch, version_vector)
        emit_shard_record(
            self.sink, "epoch_commit",
            epoch=epoch,
            version_vector={str(k): int(v) for k, v in version_vector.items()},
            shards=self.plan.num_shards,
        )
        self._retire()
        return record

    def _write_record_locked(self, epoch: int, version_vector: dict) -> dict:
        record = {
            "record": "publish_epoch",
            "format_version": _FORMAT_VERSION,
            "epoch": int(epoch),
            "version_vector": {
                str(int(k)): int(v) for k, v in version_vector.items()
            },
            "num_shards": self.plan.num_shards,
            "ranges": self.plan.ranges(),
            "created": time.time(),
        }
        record["checksum"] = _manifest_checksum(record)
        path = self._record_path(epoch)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(record, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(self.root)
        return record

    # -- read -------------------------------------------------------------
    def _read_record(self, path: str) -> dict | None:
        try:
            with open(path) as f:
                body = json.load(f)
        except (OSError, ValueError):
            return None
        if body.get("checksum", "") != _manifest_checksum(body):
            return None
        if body.get("record") != "publish_epoch":
            return None
        return body

    def committed_epochs(self) -> list[int]:
        out = []
        for path in sorted(glob.glob(os.path.join(self.root, "epoch-*.json"))):
            rec = self._read_record(path)
            if rec is not None:
                out.append(int(rec["epoch"]))
        return sorted(out)

    def committed_epoch(self) -> int:
        """The highest epoch with a valid durable commit record — THE
        reader rule (0 = nothing committed yet). A staged-but-
        uncommitted generation is invisible here by construction."""
        epochs = self.committed_epochs()
        return epochs[-1] if epochs else 0

    def version_vector(self, epoch: int | None = None) -> dict:
        """The committed epoch's shard → version map (empty when nothing
        is committed)."""
        e = self.committed_epoch() if epoch is None else int(epoch)
        if e <= 0:
            return {}
        rec = self._read_record(self._record_path(e))
        if rec is None:
            return {}
        return {int(k): int(v) for k, v in rec["version_vector"].items()}

    def read_epoch(self, epoch: int | None = None) -> dict | None:
        """Load EVERY shard's arrays from one committed epoch directory,
        verifying each sha256 — the multi-host read surface. All shards
        come from the ONE epoch the commit record names, so a reader can
        never observe a half-visible multi-range batch: the no-mixed-
        epoch-reads guarantee is structural, not a convention. ``None``
        when nothing is committed; damaged bytes raise."""
        e = self.committed_epoch() if epoch is None else int(epoch)
        if e <= 0:
            return None
        rec = self._read_record(self._record_path(e))
        if rec is None:
            raise FileNotFoundError(
                f"epoch {e} has no valid commit record at "
                f"{self._record_path(e)!r} — it was never committed"
            )
        final = self._final_dir(e)
        shards = {}
        for sdir in sorted(glob.glob(os.path.join(final, "shard-*"))):
            with open(os.path.join(sdir, MANIFEST_NAME)) as f:
                body = json.load(f)
            if body.get("checksum", "") != _manifest_checksum(body):
                raise ValueError(
                    f"shard manifest at {sdir!r} failed its checksum"
                )
            arrays = {}
            for name, ent in body.get("arrays", {}).items():
                path = os.path.join(sdir, ent["file"])
                sha = _file_sha256(path)
                if sha != ent["sha256"]:
                    raise ValueError(
                        f"shard array {name!r} at {path!r} failed its "
                        f"sha256 ({sha[:12]}... != {ent['sha256'][:12]}...)"
                    )
                arrays[name] = np.load(path)
            shards[int(body["shard"])] = {
                "arrays": arrays,
                "version": int(body.get("version", 0)),
                "range": tuple(body.get("range", (0, 0))),
            }
        return {
            "epoch": e,
            "version_vector": {
                int(k): int(v) for k, v in rec["version_vector"].items()
            },
            "shards": shards,
        }

    def _stage_complete(self, stage: str) -> bool:
        """Every shard directory present with a checksum-valid manifest
        and all its (non-empty) array files — the recover() verdict on
        whether a torn stage can be finished."""
        sdirs = sorted(glob.glob(os.path.join(stage, "shard-*")))
        if not sdirs:
            return False
        for sdir in sdirs:
            try:
                with open(os.path.join(sdir, MANIFEST_NAME)) as f:
                    body = json.load(f)
            except (OSError, ValueError):
                return False
            if body.get("checksum", "") != _manifest_checksum(body):
                return False
            for ent in body.get("arrays", {}).values():
                try:
                    size = os.path.getsize(os.path.join(sdir, ent["file"]))
                except (OSError, KeyError, TypeError):
                    return False
                if size <= 0:
                    return False
        return True

    def recover(self) -> dict:
        """Restart-path convergence after a coordinator crash: finish
        any complete generation newer than the committed epoch (rename
        if still staged, then write the missing commit record — its
        version vector recovered from the per-shard manifests), sweep
        incomplete stages, and report what happened. Runs under the
        fence lock so a concurrently-restarted coordinator can't race
        the same generation."""
        recommitted, swept = [], []
        with self.store.fence_lock():
            committed = self.committed_epoch()
            # final dirs whose commit record is missing: the crash
            # landed between the rename and the record write
            for path in sorted(glob.glob(os.path.join(self.root, "epoch-*"))):
                base = os.path.basename(path)
                if base.endswith(".json") or base.endswith(".stage"):
                    continue
                if not os.path.isdir(path):
                    continue
                try:
                    e = int(base.split("-", 1)[1])
                except (IndexError, ValueError):
                    continue
                if e <= committed:
                    continue
                if self._read_record(self._record_path(e)) is not None:
                    continue
                if self._stage_complete(path):
                    self._write_record_locked(e, self._vector_from_dir(path))
                    recommitted.append(e)
                else:
                    shutil.rmtree(path, ignore_errors=True)
                    swept.append(e)
            for stage in sorted(
                glob.glob(os.path.join(self.root, "epoch-*.stage"))
            ):
                try:
                    e = int(
                        os.path.basename(stage)[: -len(".stage")].split(
                            "-", 1
                        )[1]
                    )
                except (IndexError, ValueError):
                    shutil.rmtree(stage, ignore_errors=True)
                    continue
                if e > committed and self._stage_complete(stage):
                    final = self._final_dir(e)
                    shutil.rmtree(final, ignore_errors=True)
                    os.replace(stage, final)
                    _fsync_dir(self.root)
                    self._write_record_locked(e, self._vector_from_dir(final))
                    recommitted.append(e)
                else:
                    shutil.rmtree(stage, ignore_errors=True)
                    swept.append(e)
        for e in recommitted:
            emit_shard_record(
                self.sink, "epoch_commit", epoch=e,
                version_vector={
                    str(k): v for k, v in self.version_vector(e).items()
                },
                shards=self.plan.num_shards, recovered=True,
            )
        return {
            "committed_epoch": self.committed_epoch(),
            "recommitted": sorted(set(recommitted)),
            "swept": sorted(set(swept)),
        }

    def _vector_from_dir(self, gen_dir: str) -> dict:
        vec = {}
        for sdir in sorted(glob.glob(os.path.join(gen_dir, "shard-*"))):
            try:
                with open(os.path.join(sdir, MANIFEST_NAME)) as f:
                    body = json.load(f)
                vec[int(body["shard"])] = int(body.get("version", 0))
            except (OSError, ValueError, KeyError):
                continue
        return vec

    def _retire(self) -> None:
        """Keep the newest :data:`RETAIN_EPOCHS` committed generations;
        older ones (dir + record) drop — the two-generation snapshot
        discipline applied to epochs."""
        epochs = self.committed_epochs()
        for e in epochs[: -self.RETAIN_EPOCHS]:
            shutil.rmtree(self._final_dir(e), ignore_errors=True)
            try:
                os.remove(self._record_path(e))
            except OSError:
                pass

    def snapshot(self) -> dict:
        e = self.committed_epoch()
        return {
            "committed_epoch": e,
            "version_vector": {
                str(k): v for k, v in self.version_vector(e).items()
            },
            "retained_epochs": self.committed_epochs(),
        }


# ---- the sharded write plane ------------------------------------------------


class _WriterShard:
    """One vertex range's writer state: its own WAL, admission ladder,
    debt ledger, availability verdict and optional standby WAL copy."""

    __slots__ = (
        "shard", "lo", "hi", "wal", "admission", "debt", "read_only",
        "reason", "standby", "version",
    )

    def __init__(self, shard, lo, hi, wal, admission, debt):
        self.shard = shard
        self.lo = lo
        self.hi = hi
        self.wal = wal
        self.admission = admission
        self.debt = debt
        self.read_only = False
        self.reason = ""
        self.standby: WriteAheadLog | None = None
        self.version = 0   # last published version that touched this range


class _ShardSink:
    """Sink proxy tagging every record with its shard — the per-range
    twin of the server's ``_TenantSink`` (absent key = unsharded, so
    every pre-shard record stays valid)."""

    __slots__ = ("_sink", "_shard")

    def __init__(self, sink, shard: int):
        self._sink = sink
        self._shard = int(shard)

    def emit(self, phase: str, **kv):
        kv.setdefault("shard", self._shard)
        return self._sink.emit(phase, **kv)

    def __getattr__(self, name):
        return getattr(self._sink, name)


class ShardedWritePlane:
    """Per-range writer shards for ONE tenant's namespace.

    Composition contract: tenancy splits the store by namespace, the
    plane splits each namespace's vertex-range space — so a 2-tenant /
    3-shard deployment runs 6 independent (WAL, admission, debt) triples
    and one coordinator per tenant. The plane owns durability and
    range-availability; the server's apply worker still owns the actual
    splice/repair (driving the ORIGINAL unsplit batch — see
    :func:`split_delta` for why that is bit-exact).
    """

    def __init__(
        self,
        store,
        plan: ShardPlan,
        sink=None,
        registry=None,
        tenant: str = DEFAULT_TENANT,
        wal_root: str | None = None,
        admission_bounds: AdmissionBounds | None = None,
    ):
        self.store = store
        self.plan = plan
        self.sink = sink
        self.registry = registry
        self.tenant = tenant or DEFAULT_TENANT
        self.coordinator = EpochCoordinator(store, plan, sink=sink)
        self._base = wal_root or os.path.join(store.root, SHARDS_DIRNAME)
        self._lock = threading.Lock()
        bounds = (
            admission_bounds if admission_bounds is not None
            else AdmissionBounds.from_env()
        )
        self.bounds = bounds
        self.shards: list[_WriterShard] = []
        for i in range(plan.num_shards):
            lo, hi = plan.range_of(i)
            shard_sink = None if sink is None else _ShardSink(sink, i)
            wal = WriteAheadLog(
                self._wal_dir(i), sink=shard_sink, registry=registry,
                shard=i,
            )
            adm = AdmissionController(
                bounds=bounds, sink=shard_sink, registry=None,
                tenant=self.tenant,
            )
            self.shards.append(
                _WriterShard(i, lo, hi, wal, adm, RepairDebt())
            )

    def _wal_dir(self, shard: int) -> str:
        return os.path.join(self._base, f"shard-{int(shard):03d}", "wal")

    def _standby_dir(self, shard: int) -> str:
        return os.path.join(
            self._base, f"shard-{int(shard):03d}", "standby-wal"
        )

    # -- write path --------------------------------------------------------
    def submit(
        self,
        delta: EdgeDelta,
        delta_id: str = "",
        deadline_s: float | None = None,
        queue_depth: int = 0,
        applying: bool = False,
        trace: str = "",
        replay: bool = False,
    ) -> dict:
        """Admit + durably log one batch across its owner shards.

        Returns ``{"verdict": ..., "splits": [...], "shard_seqs": {...}}``:

        - ``"refused"`` never happens silently — a dead range raises
          :class:`ShardRangeUnavailableError` (503; untouched ranges are
          unaffected because THEIR submit calls don't touch this one);
        - ``"shed"`` when any owner shard's admission ladder refuses
          (one saturated range sheds the whole batch — a partial accept
          would make the batch's visibility non-atomic);
        - ``"duplicate"`` when every touched shard already holds
          ``delta_id`` (a clean retry);
        - ``"accepted"`` with ``shard_seqs`` = {shard: seq} — the
          ``(delta_id, shard)`` dedupe pairs. A retry after a PARTIAL
          accept appends only to the shards that missed it, so each
          shard stays exactly-once.
        """
        splits = split_delta(delta, self.plan)
        touched = [sp.shard for sp in splits]
        dead = [s for s in touched if self.shards[s].read_only]
        if dead:
            parts = ", ".join(
                f"shard {s} [{self.shards[s].lo},{self.shards[s].hi})"
                f" ({self.shards[s].reason or 'read_only'})"
                for s in dead
            )
            raise ShardRangeUnavailableError(
                f"batch touches degraded vertex range(s): {parts}; "
                "untouched ranges keep accepting writes — retry after "
                "the range recovers or its standby promotes",
                shards=dead,
            )
        # Per-shard dedupe: (delta_id, shard) — each shard's own log is
        # the authority for its half of a retried batch.
        shard_seqs: dict[int, int] = {}
        missing = []
        for sp in splits:
            ws = self.shards[sp.shard]
            seq = ws.wal.lookup(delta_id, tenant=self.tenant) if delta_id else None
            if seq is not None:
                shard_seqs[sp.shard] = int(seq)
            else:
                missing.append(sp)
        if delta_id and not missing:
            return {
                "verdict": "duplicate",
                "splits": splits,
                "shard_seqs": shard_seqs,
                "applied": all(
                    self.shards[s].wal.seq_applied(q)
                    for s, q in shard_seqs.items()
                ),
            }
        # Admission: every missing shard's ladder must accept before any
        # append — all-or-nothing, so a shed can't strand a half-durable
        # batch.
        decisions = []
        for sp in missing:
            ws = self.shards[sp.shard]
            rows = sp.delta.num_inserts + sp.delta.num_deletes
            debt_at = ws.debt.snapshot()
            decision = ws.admission.resolve(
                rows=rows, queue_depth=queue_depth, debt=debt_at,
                applying=applying, emit=True, replay=replay,
            )
            decisions.append((sp, rows, decision, debt_at))
            if decision.verdict == "shed":
                ws.debt.shed(rows)
                ws.admission.record_shed(
                    decision.reason, rows, decision.queue_depth,
                    ws.debt.snapshot(),
                )
                return {
                    "verdict": "shed",
                    "shard": sp.shard,
                    "reason": (
                        f"shard {sp.shard} "
                        f"[{ws.lo},{ws.hi}): {decision.reason}"
                    ),
                    "retry_after_s": decision.retry_after_s,
                    "splits": splits,
                    "shard_seqs": {},
                }
        # Durability: append each sub-batch to its owner shard's WAL
        # (fsync per append — the shard's acceptance is on disk before
        # the caller hears "accepted").
        for sp, rows, decision, debt_at in decisions:
            ws = self.shards[sp.shard]
            payload = _split_payload(sp)
            seq, dup = ws.wal.append(
                payload, delta_id=delta_id or "", deadline_s=deadline_s,
                trace=trace, tenant=self.tenant,
            )
            shard_seqs[sp.shard] = int(seq)
            ws.debt.submitted(rows)
        return {
            "verdict": "accepted",
            "splits": splits,
            "shard_seqs": shard_seqs,
        }

    def commit_applied(self, shard_seqs: dict, version: int) -> None:
        """Per-shard watermark advance after the publish that absorbed
        these seqs — also records the version into each touched range's
        slot of the version vector."""
        for shard, seq in shard_seqs.items():
            ws = self.shards[int(shard)]
            seqs = seq if isinstance(seq, (list, tuple, set)) else [seq]
            ws.wal.commit_applied([int(s) for s in seqs], int(version))
            ws.version = int(version)

    def skip(self, shard_seqs: dict) -> None:
        """Tombstone a durable-but-shed batch on every shard that logged
        it (deadline expiry before apply)."""
        for shard, seq in shard_seqs.items():
            try:
                self.shards[int(shard)].wal.skip(int(seq))
            except OSError:
                pass  # best-effort, same as the single-WAL path

    def version_vector(self) -> dict:
        return {ws.shard: int(ws.version) for ws in self.shards}

    def note_versions(self, vector: dict) -> None:
        """Adopt a committed epoch's version vector (startup: the plane
        resumes where the last committed epoch left each range)."""
        for shard, v in vector.items():
            s = int(shard)
            if 0 <= s < len(self.shards):
                self.shards[s].version = int(v)

    # -- per-range failover ------------------------------------------------
    def kill_shard(self, shard: int, reason: str = "writer_shard_kill") -> None:
        """Simulated shard death (the ``writer_shard_kill`` injector's
        target): the shard's WAL handle closes un-flushed, the range
        flips read-only, every OTHER range keeps accepting. Durability
        holds by construction — every acked seq was fsync'd at append."""
        ws = self.shards[int(shard)]
        ws.wal.close()
        ws.read_only = True
        ws.reason = reason
        emit_shard_record(
            self.sink, "shard_degraded", shard=int(shard),
            status="read_only", reason=reason, range=[ws.lo, ws.hi],
            tenant=self.tenant,
        )

    def restart_shard(self, shard: int) -> list[dict]:
        """Reopen a dead shard's WAL (open-time recovery: torn tail
        tolerated, acked prefix intact) and return its accepted-but-
        unapplied entries — the replay work list the server re-enqueues.
        The range re-opens for writes."""
        ws = self.shards[int(shard)]
        ws.wal = WriteAheadLog(
            self._wal_dir(shard),
            sink=None if self.sink is None else _ShardSink(self.sink, shard),
            registry=self.registry, shard=int(shard),
        )
        pending = ws.wal.pending()
        ws.read_only = False
        ws.reason = ""
        emit_shard_record(
            self.sink, "shard_degraded", shard=int(shard),
            status="recovered", reason="wal replayed after restart",
            pending=len(pending), range=[ws.lo, ws.hi], tenant=self.tenant,
        )
        return pending

    def attach_standby(self, shard: int) -> WriteAheadLog:
        """Create/open the shard's log-shipped standby copy (same-
        filesystem deployment: the ship path is WAL.copy_from, the same
        verbatim-copy machinery LogShipper drives over HTTP)."""
        ws = self.shards[int(shard)]
        if ws.standby is None:
            ws.standby = WriteAheadLog(
                self._standby_dir(shard), sink=None, registry=None,
                shard=int(shard),
            )
        return ws.standby

    def ship_shard(self, shard: int) -> int:
        """One shipping pass: copy the shard's un-shipped tail into its
        standby verbatim (same seq, same id). Returns entries copied."""
        ws = self.shards[int(shard)]
        if ws.standby is None:
            return 0
        entries = ws.wal.entries(ws.standby.last_seq + 1)
        return ws.standby.copy_from(entries)

    def promote_shard(self, shard: int) -> dict:
        """Promote a dead shard's standby copy via the fenced path:
        mint the next writer epoch through the store's fence lock (the
        coordinator's serialization point — a deposed shard writer is
        fenced before the standby owns the range), swap the standby WAL
        in as the shard's log, re-open the range. Returns the pending
        entries to replay plus the minted epoch."""
        ws = self.shards[int(shard)]
        if ws.standby is None:
            raise ValueError(
                f"shard {int(shard)} has no standby to promote "
                "(attach_standby + ship_shard first)"
            )
        epoch = self.store.advance_epoch(
            sink=self.sink,
            reason=f"shard {int(shard)} standby promoted",
        )
        ws.wal = ws.standby
        ws.standby = None
        pending = ws.wal.pending()
        ws.read_only = False
        ws.reason = ""
        emit_shard_record(
            self.sink, "shard_degraded", shard=int(shard),
            status="promoted", reason=f"standby promoted at epoch {epoch}",
            epoch=int(epoch), pending=len(pending), range=[ws.lo, ws.hi],
            tenant=self.tenant,
        )
        return {"epoch": int(epoch), "pending": pending}

    # -- observability -----------------------------------------------------
    def snapshot(self) -> dict:
        """The plane's status page section: the range table with each
        shard's availability, WAL seqs/backlog and last-touch version,
        plus the committed epoch."""
        return {
            "num_shards": self.plan.num_shards,
            "plan": self.plan.snapshot(),
            "epoch": self.coordinator.committed_epoch(),
            "shards": [
                {
                    "shard": ws.shard,
                    "lo": ws.lo,
                    "hi": ws.hi,
                    "owns_growth": ws.shard == self.plan.num_shards - 1,
                    "read_only": ws.read_only,
                    "reason": ws.reason,
                    "version": int(ws.version),
                    "standby": ws.standby is not None,
                    "wal": ws.wal.snapshot(),
                    "admission": ws.admission.snapshot(),
                    "repair_debt": ws.debt.snapshot(),
                }
                for ws in self.shards
            ],
        }

    def close(self) -> None:
        for ws in self.shards:
            ws.wal.close()
            if ws.standby is not None:
                ws.standby.close()


def _split_payload(sp: DeltaSplit) -> dict:
    """The wire-shaped payload one shard's WAL frame carries: the
    sub-batch as insert/delete pair (or weighted-triple) lists, plus the
    original row indices so a replayed frame can participate in a
    bit-exact merge."""
    d = sp.delta
    if d.insert_weight is not None:
        insert = [
            [int(s), int(t), float(w)]
            for s, t, w in zip(d.insert_src, d.insert_dst, d.insert_weight)
        ]
    else:
        insert = [
            [int(s), int(t)] for s, t in zip(d.insert_src, d.insert_dst)
        ]
    return {
        "insert": insert,
        "delete": [
            [int(s), int(t)] for s, t in zip(d.delete_src, d.delete_dst)
        ],
        "shard": int(sp.shard),
        "insert_index": [int(i) for i in sp.insert_index],
        "delete_index": [int(i) for i in sp.delete_index],
    }
