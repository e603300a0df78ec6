"""Versioned result snapshots: the hand-off to the serving plane.

Counterpart of ``graphmine_tpu/serve/snapshot.py``, whole and with the
same on-disk format, so either package reads the other's stores. A
snapshot is the published output of one pipeline run: community labels,
CC labels, LOF scores, the community census and the edge arrays, with
provenance (run id, parent snapshot, graph fingerprint).

Format: one ``.npy`` per array and a JSON manifest with each file's
sha256 and a checksum of the whole manifest, written into a tmp
generation directory (every file fsync'd, the manifest last) and
published by one directory rename after the previous generation is
rotated to ``*.prev``: a kill at any point leaves the old or the new
snapshot whole. Loads verify every hash, roll back to ``.prev`` on
corruption (the condemned generation kept at ``*.corrupt``), and refuse a
wrong graph fingerprint without rollback.

Versioning: each publish increments ``version`` and records its parent's
``snapshot_id``. Writer epochs: every manifest carries ``writer_epoch``;
a publish below the store's epoch (the newest manifest's, or the durable
``EPOCH`` fence file's) is refused with :class:`PublishFencedError`, on
entry and again at the commit rename, under the store's fence lock.
``epoch=None`` inherits the current epoch, so single-writer callers never
trip it.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import time
from dataclasses import dataclass

try:
    import fcntl
except ImportError:  # non-POSIX: single-process stores only
    fcntl = None

import numpy as np

from graphmine_tpu_torch.pipeline import resilience
from graphmine_tpu_torch.serve.tenancy import (
    DEFAULT_TENANT,
    TENANT_RE,
    validate_tenant_id,
)
from graphmine_tpu_torch.pipeline.checkpoint import (
    CheckpointCorruptionError,
    FingerprintMismatch,
    _CORRUPTION_ERRORS,
    _file_sha256,
    _fsync_dir,
    _fsync_file,
    _load_with_rollback,
    _manifest_checksum,
    _tree_bytes,
)

MANIFEST_NAME = "manifest.json"
EPOCH_NAME = "EPOCH"
TENANTS_DIRNAME = "tenants"
# Sharded-write-plane publish epochs (serve/shardplane.py): staged
# per-range generations and their commit records live under <root>/epochs.
EPOCHS_DIRNAME = "epochs"
_FORMAT_VERSION = 1


class PublishFencedError(RuntimeError):
    """A publish carried a writer epoch below the store's current epoch:
    the publisher was deposed (a standby was promoted past it) and its
    work must not reach readers. Not a retryable condition — the honest
    recovery is rejoining as a replica/standby of the new writer."""
# Array names become file names; keep them boring so a hostile/typo'd
# name can never escape the generation directory.
_NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]*$")

# The standard array set the driver publishes and the query engine reads.
# publish() accepts any dict (the format is name-agnostic).
STANDARD_ARRAYS = (
    "src", "dst", "labels", "cc_labels", "lof",
    "census_present", "census_sizes", "census_edges",
)


@dataclass(frozen=True)
class Snapshot:
    """One loaded snapshot generation: arrays + manifest metadata."""

    arrays: dict                # name -> np.ndarray
    meta: dict                  # manifest body minus per-file hashes
    path: str = ""              # generation dir it was loaded from

    @property
    def version(self) -> int:
        return int(self.meta["version"])

    @property
    def snapshot_id(self) -> str:
        return self.meta["snapshot_id"]

    @property
    def nbytes(self) -> int:
        """Total array payload bytes."""
        return int(sum(int(a.nbytes) for a in self.arrays.values()))

    @property
    def parent(self) -> str:
        return self.meta.get("parent", "")

    @property
    def fingerprint(self) -> str:
        return self.meta.get("fingerprint", "")

    @property
    def num_vertices(self) -> int:
        return int(self.meta.get("num_vertices", 0))

    @property
    def num_edges(self) -> int:
        return int(self.meta.get("num_edges", 0))

    @property
    def writer_epoch(self) -> int:
        return int(self.meta.get("writer_epoch", 0))

    def __getitem__(self, name: str) -> np.ndarray:
        return self.arrays[name]

    def get(self, name: str, default=None):
        return self.arrays.get(name, default)


class SnapshotStore:
    """Two-generation versioned snapshot store rooted at one directory.

    ``publish`` is safe against kills at any point (see module docstring);
    ``load`` returns the newest intact generation. One publisher per root
    is the concurrency contract (same as the checkpoint generation
    rotation); any number of concurrent readers may load.

    **Tenant namespace**: a store optionally belongs to one
    tenant. The default tenant lives at the bare ``root`` — byte-for-byte
    the pre-tenancy layout, so every existing deployment IS a default-
    tenant store — while tenant ``t`` lives at ``<root>/tenants/<t>/``
    with its own version chain, ``.prev`` rotation, ``EPOCH`` fence,
    fence lock, canary arrays and ``lof_centers``: complete blast-radius
    isolation at the filesystem layer (one tenant's corrupt generation
    rolls back alone; one tenant's fence fences only its own writer).
    Tenant ids are validated before any path is built.
    """

    def __init__(self, root: str, tenant: str = DEFAULT_TENANT):
        self.base_root = root
        self.tenant = validate_tenant_id(tenant)
        if self.tenant == DEFAULT_TENANT:
            self.root = root
        else:
            self.root = os.path.join(root, TENANTS_DIRNAME, self.tenant)

    # -- tenancy -----------------------------------------------------------
    def for_tenant(self, tenant: str) -> SnapshotStore:
        """The sibling store for ``tenant`` under the same base root
        (``self`` when already that tenant's store). Hostile ids raise
        ``ValueError`` here, before any filesystem path exists."""
        tenant = validate_tenant_id(tenant)
        if tenant == self.tenant:
            return self
        return SnapshotStore(self.base_root, tenant=tenant)

    def list_tenants(self) -> list[str]:
        """Every tenant with a store directory under this base root:
        the default tenant whenever the bare root has published (or is
        an empty-but-created store), plus each valid id under
        ``tenants/``. Non-conforming directory names are ignored rather
        than surfaced — they cannot have been created through this API."""
        out = []
        base = SnapshotStore(self.base_root)
        if base._peek_manifest() is not None:
            out.append(DEFAULT_TENANT)
        tdir = os.path.join(self.base_root, TENANTS_DIRNAME)
        try:
            names = sorted(os.listdir(tdir))
        except OSError:
            names = []
        for name in names:
            if TENANT_RE.fullmatch(name) and os.path.isdir(
                os.path.join(tdir, name)
            ):
                out.append(name)
        return out

    # -- paths ------------------------------------------------------------
    def _gen(self) -> str:
        return os.path.join(self.root, "snapshot")

    def _prev(self) -> str:
        return self._gen() + ".prev"

    # -- writer epoch ------------------------------------------------------
    @contextlib.contextmanager
    def _fence_lock(self):
        """Inter-process exclusive lock serializing the fence write
        against the publish commit boundary. Without it the re-check at
        the commit rename is a TOCTOU: a promotion (fence bump + first
        publish) can land between a deposed writer's epoch read and its
        generation rotation, and the deposed writer then evicts the
        promoted writer's snapshot — the exact clobber the fence
        declares impossible. ``flock`` releases on process death, so a
        killed holder can never wedge the store."""
        os.makedirs(self.root, exist_ok=True)
        if fcntl is None:
            yield
            return
        fd = os.open(
            os.path.join(self.root, ".fence.lock"),
            os.O_CREAT | os.O_RDWR, 0o644,
        )
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.close(fd)

    def fence_lock(self):
        """The store's inter-process fence lock as a public context
        manager, for callers that commit under the fence."""
        return self._fence_lock()

    def _fence_file_epoch(self) -> int:
        try:
            with open(os.path.join(self.root, EPOCH_NAME)) as f:
                return int(json.load(f).get("epoch", 0))
        except (OSError, ValueError):
            return 0

    def current_epoch(self) -> int:
        """The store's writer epoch: max of the newest manifest's
        ``writer_epoch`` and the durable fence file (a promotion bumps
        the fence first, so the deposed writer is fenced before the new
        writer's first publish exists)."""
        peek = self._peek_manifest()
        manifest_epoch = int(peek.get("writer_epoch", 0)) if peek else 0
        return max(manifest_epoch, self._fence_file_epoch())

    def fence_epoch(self, epoch: int, sink=None, reason: str = "") -> int:
        """Durably raise the store's writer epoch (atomic write + fsync
        of the ``EPOCH`` fence file). From the moment this returns, any
        publish carrying a lower epoch refuses with
        :class:`PublishFencedError` — the promotion's first act, before
        the standby replays a single WAL entry. Lowering is refused
        (an epoch that can move backwards fences nothing)."""
        epoch = int(epoch)
        with self._fence_lock():
            cur = self.current_epoch()
            if epoch < cur:
                raise ValueError(
                    f"fence_epoch({epoch}) below the store's current epoch "
                    f"{cur}: epochs are monotonic"
                )
            self._write_fence_locked(epoch, reason)
        if sink is not None:
            sink.emit(
                "writer_promote", epoch=epoch, store=self.root,
                reason=reason or "epoch fence raised",
            )
        return epoch

    def _write_fence_locked(self, epoch: int, reason: str) -> None:
        tmp = os.path.join(self.root, EPOCH_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump(
                {"epoch": epoch, "t": time.time(), "reason": reason}, f
            )
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, EPOCH_NAME))
        _fsync_dir(self.root)

    def advance_epoch(self, sink=None, reason: str = "") -> int:
        """Atomically mint-and-fence the NEXT writer epoch: read the
        current epoch and durably raise it by one under the fence lock,
        returning the new epoch this caller now exclusively owns.
        ``fence_epoch(current_epoch() + 1)`` composed by the caller is
        NOT equivalent — two concurrent promotions would read the same
        current epoch and both fence the same value (fence_epoch
        accepts an equal epoch as an idempotent re-assert), leaving two
        writers that both pass the fence: the split-brain the epoch
        exists to make impossible. Every promotion allocates here."""
        with self._fence_lock():
            epoch = self.current_epoch() + 1
            self._write_fence_locked(epoch, reason)
        if sink is not None:
            sink.emit(
                "writer_promote", epoch=epoch, store=self.root,
                reason=reason or "epoch fence advanced",
            )
        return epoch

    def _check_fence(self, epoch: int | None, sink) -> int:
        """Resolve the publish epoch against the fence; raises
        :class:`PublishFencedError` (with its loud ``publish_fenced``
        record) for a deposed writer. ``None`` inherits — legacy
        single-writer callers never trip this."""
        cur = self.current_epoch()
        if epoch is None:
            return cur
        epoch = int(epoch)
        if epoch < cur:
            if sink is not None:
                sink.emit(
                    "publish_fenced", attempted_epoch=epoch,
                    store_epoch=cur, store=self.root,
                    reason=(
                        f"publish at writer epoch {epoch} refused: the "
                        f"store was fenced at epoch {cur} (a standby was "
                        "promoted past this writer)"
                    ),
                )
            raise PublishFencedError(
                f"publish refused: writer epoch {epoch} is behind the "
                f"store's epoch {cur} at {self.root!r} — this writer was "
                "deposed; rejoin as a replica of the promoted writer "
                "instead of republishing"
            )
        return epoch

    # -- publish ----------------------------------------------------------
    def publish(
        self,
        arrays: dict,
        fingerprint: str = "",
        run_id: str = "",
        mesh_shape=None,
        extra_meta: dict | None = None,
        sink=None,
        epoch: int | None = None,
    ) -> Snapshot:
        """Durably publish one snapshot generation; returns it as loaded.

        ``epoch``: the publisher's writer epoch (replicated-writer
        deployments). ``None`` (every single-writer caller) inherits the
        store's current epoch; an epoch below the store's refuses with
        :class:`PublishFencedError` + a ``publish_fenced`` record — the
        fence is checked on entry (cheap refusal before any bytes are
        written) and again at the commit rename (a promotion racing a
        slow publish still fences it).

        ``fingerprint`` ties the snapshot to the exact edge arrays /
        id assignment (``checkpoint.graph_fingerprint``); loads under a
        different graph refuse. Version/parent chain continues from the
        current generation (version 1 when the store is empty). ``sink``:
        emits a ``snapshot_publish`` record (span-stamped, rendered by
        ``tools/obs_report.py``).

        The returned :class:`Snapshot` ALIASES the caller's arrays (no
        defensive copy of potentially-GB columns): snapshots are
        immutable by contract, so a publisher that keeps mutable working
        state must copy-on-write before changing it (the delta
        ingestor's LOF splice does) — a live ``QueryEngine`` built on
        the returned snapshot reads these same buffers.
        """
        t0 = time.perf_counter()
        for name, arr in arrays.items():
            if not _NAME_RE.match(name):
                raise ValueError(f"unsafe snapshot array name {name!r}")
            if not isinstance(arr, np.ndarray):
                raise TypeError(
                    f"snapshot arrays must be host numpy (got "
                    f"{type(arr).__name__} for {name!r}); np.asarray() first"
                )
        epoch = self._check_fence(epoch, sink)
        parent_version, parent_id = 0, ""
        peek = self._peek_manifest()
        if peek is not None:
            parent_version = int(peek.get("version", 0))
            parent_id = peek.get("snapshot_id", "")
        version = parent_version + 1
        snapshot_id = f"{version:06d}-{os.urandom(4).hex()}"

        os.makedirs(self.root, exist_ok=True)
        gen = self._gen()
        tmp = f"{gen}.tmp.{os.getpid()}"
        # Sweep EVERY stale tmp generation (same rationale as
        # checkpoint.save_sharded): each kill mid-publish leaves one
        # behind, and restarted publishers never reuse the old pid.
        import glob as _glob
        import shutil

        for stale in _glob.glob(gen + ".tmp.*"):
            shutil.rmtree(stale, ignore_errors=True)
        os.makedirs(tmp)

        entries = {}
        for name, arr in arrays.items():
            fname = f"{name}.npy"
            path = os.path.join(tmp, fname)
            np.save(path, arr)
            _fsync_file(path)
            entries[name] = {
                "file": fname,
                "sha256": _file_sha256(path),
                "dtype": str(arr.dtype),
                "shape": list(arr.shape),
            }

        body = {
            "format_version": _FORMAT_VERSION,
            "version": version,
            "snapshot_id": snapshot_id,
            "parent": parent_id,
            "run_id": run_id or "",
            "fingerprint": fingerprint or "",
            "writer_epoch": int(epoch),
            "mesh_shape": list(mesh_shape) if mesh_shape else [1],
            "created": time.time(),
            "arrays": entries,
        }
        if extra_meta:
            overlap = set(extra_meta) & set(body)
            if overlap:
                raise ValueError(
                    f"extra_meta may not shadow manifest keys {sorted(overlap)}"
                )
            body.update(extra_meta)
        body["checksum"] = _manifest_checksum(body)
        man_tmp = os.path.join(tmp, MANIFEST_NAME + ".tmp")
        with open(man_tmp, "w") as f:
            json.dump(body, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(man_tmp, os.path.join(tmp, MANIFEST_NAME))
        _fsync_dir(tmp)

        # Torn-publish seam: a fault/preemption injected HERE (every file
        # written, nothing published) must leave the previous generation
        # the loadable one.
        resilience.fault_point(
            "snapshot_publish_commit", version=version, tmp=tmp
        )

        # Re-check the fence at the commit boundary: a promotion that
        # landed while this publish was writing its (possibly large)
        # arrays must still fence it — the deposed writer's work dies in
        # the tmp directory, never in the published slot. The check and
        # the rotation+rename hold the fence lock together: a
        # fence_epoch cannot slip between them, so a fenced writer can
        # never evict the promoted writer's generation (atomic with the
        # fence, not merely checked near it).
        with self._fence_lock():
            cur = self.current_epoch()
            if int(epoch) < cur:
                shutil.rmtree(tmp, ignore_errors=True)
                if sink is not None:
                    sink.emit(
                        "publish_fenced", attempted_epoch=int(epoch),
                        store_epoch=cur, store=self.root,
                        reason=(
                            f"publish at writer epoch {epoch} fenced at the "
                            f"commit rename: the store moved to epoch {cur} "
                            "mid-publish (standby promoted during the write)"
                        ),
                    )
                raise PublishFencedError(
                    f"publish refused at commit: writer epoch {epoch} is "
                    f"behind the store's epoch {cur} at {self.root!r} — a "
                    "standby was promoted while this publish was in flight"
                )

            prev = self._prev()
            if os.path.exists(gen):
                if self._peek_dir(gen) is None:
                    # The current generation's manifest is unreadable:
                    # rotating it into .prev would EVICT the only intact
                    # snapshot and install garbage as the rollback target
                    # (a kill before the final rename would then lose every
                    # loadable generation). Condemn it aside instead — the
                    # same *.corrupt convention as the loader's rollback.
                    condemned = gen + ".corrupt"
                    n = 0
                    while os.path.exists(condemned):
                        n += 1
                        condemned = f"{gen}.corrupt.{n}"
                    os.replace(gen, condemned)
                else:
                    if os.path.exists(prev):
                        shutil.rmtree(prev)
                    os.replace(gen, prev)
            os.replace(tmp, gen)
            _fsync_dir(self.root)
        if sink is not None:
            sink.emit(
                "snapshot_publish",
                version=version,
                snapshot_id=snapshot_id,
                parent=parent_id,
                path=gen,
                bytes=_tree_bytes(gen),
                arrays=sorted(arrays),
                seconds=round(time.perf_counter() - t0, 4),
            )
        meta = {k: v for k, v in body.items() if k not in ("arrays", "checksum")}
        return Snapshot(arrays=dict(arrays), meta=meta, path=gen)

    # -- load -------------------------------------------------------------
    @staticmethod
    def _peek_dir(gen_dir: str) -> dict | None:
        """Cheap one-directory manifest read (JSON + manifest checksum,
        no array hashing); None = absent/unparseable/checksum-damaged.
        Applies the loader's manifest-level corruption verdict so the
        publish rotation never treats a bit-damaged-but-parseable
        manifest as an intact generation, and stats every listed array
        file (existence + non-empty, no hashing — damage overwhelmingly
        lands in the GB-scale arrays, not the KB manifest) so a
        generation missing its arrays is never rotated over an intact
        ``.prev``."""
        try:
            with open(os.path.join(gen_dir, MANIFEST_NAME)) as f:
                body = json.load(f)
        except Exception:
            return None
        if body.get("checksum", "") != _manifest_checksum(body):
            return None
        for ent in body.get("arrays", {}).values():
            try:
                if os.path.getsize(os.path.join(gen_dir, ent["file"])) <= 0:
                    return None
            except (OSError, KeyError, TypeError):
                return None
        return body

    def _peek_manifest(self) -> dict | None:
        """Cheap manifest read for the version/parent chain: the current
        generation, falling back to ``.prev`` when the current one is
        missing/unreadable — a kill in the window between the two
        publish renames leaves only ``.prev`` intact, and the chain must
        continue from it, never reset to version 1. None = neither
        generation readable."""
        for gen in (self._gen(), self._prev()):
            peek = self._peek_dir(gen)
            if peek is not None:
                return peek
        return None

    def peek_version(self) -> int | None:
        peek = self._peek_manifest()
        if peek is None:
            return None
        try:
            return int(peek["version"])
        except (KeyError, TypeError, ValueError):
            return None

    def peek_arrays(self, names) -> tuple[dict, dict] | None:
        """Load ONLY the named arrays (plus the manifest meta) from the
        newest intact generation, without per-array hash verification —
        the cheap parent read the publish-time quality pass
        (``obs/quality.py``) uses for snapshot-over-parent drift when the
        parent is not already in memory. Advisory-telemetry contract:
        full verification stays with :meth:`load`; any read failure here
        returns None (drift is then simply skipped) instead of raising
        into a publish. Returns ``({name: array}, meta)`` with absent
        names simply missing from the dict."""
        for gen in (self._gen(), self._prev()):
            body = self._peek_dir(gen)
            if body is None:
                continue
            out = {}
            try:
                for name in names:
                    ent = body.get("arrays", {}).get(name)
                    if ent is None:
                        continue
                    out[name] = np.load(os.path.join(gen, ent["file"]))
            except Exception:  # noqa: BLE001 — advisory read, never raise
                continue
            meta = {
                k: v for k, v in body.items()
                if k not in ("arrays", "checksum")
            }
            return out, meta
        return None

    def _read_verified(self, gen_dir: str, fingerprint: str | None):
        """Load one generation, verifying manifest checksum, every
        array's sha256/dtype/shape, then the graph fingerprint. Raises a
        :data:`_CORRUPTION_ERRORS` member on damaged bytes,
        :class:`FingerprintMismatch` on a wrong-graph snapshot."""
        man_path = os.path.join(gen_dir, MANIFEST_NAME)
        try:
            with open(man_path) as f:
                body = json.load(f)
        except json.JSONDecodeError as e:
            raise CheckpointCorruptionError(
                f"snapshot manifest at {man_path} is not valid JSON ({e})"
            ) from e
        want = body.get("checksum", "")
        got = _manifest_checksum(body)
        if want != got:
            raise CheckpointCorruptionError(
                f"snapshot manifest at {man_path} failed its checksum "
                f"({got[:12]}... != recorded {want[:12]}...)"
            )
        saved_fp = body.get("fingerprint", "")
        if fingerprint and saved_fp and fingerprint != saved_fp:
            raise FingerprintMismatch(
                f"snapshot at {gen_dir} was published for a different graph "
                f"or vertex-id assignment (fingerprint {saved_fp[:12]}... != "
                f"{fingerprint[:12]}...); republish from the current graph "
                "or query the snapshot it was built from"
            )
        arrays = {}
        for name, ent in body.get("arrays", {}).items():
            path = os.path.join(gen_dir, ent["file"])
            sha = _file_sha256(path)
            if sha != ent["sha256"]:
                raise CheckpointCorruptionError(
                    f"snapshot array {name!r} at {path} failed its sha256 "
                    f"({sha[:12]}... != manifest {ent['sha256'][:12]}...)"
                )
            arr = np.load(path)
            if list(arr.shape) != ent["shape"] or str(arr.dtype) != ent["dtype"]:
                raise CheckpointCorruptionError(
                    f"snapshot array {name!r} at {path} is "
                    f"{arr.dtype}{list(arr.shape)}, manifest says "
                    f"{ent['dtype']}{ent['shape']}"
                )
            arrays[name] = arr
        meta = {k: v for k, v in body.items() if k not in ("arrays", "checksum")}
        snap = Snapshot(arrays=arrays, meta=meta, path=gen_dir)
        # (snapshot, version) so the shared rollback state machine — whose
        # contract is (payload, generation-counter) tuples — applies as-is.
        return snap, snap.version

    def _read_confirmed(self, gen_dir: str, fingerprint: str | None):
        """One confirming re-read before a corruption verdict — the same
        transient-I/O-weather rationale as the checkpoint readers."""
        try:
            return self._read_verified(gen_dir, fingerprint)
        except FingerprintMismatch:
            raise
        except _CORRUPTION_ERRORS as first:
            try:
                return self._read_verified(gen_dir, fingerprint)
            except FingerprintMismatch:
                raise
            except _CORRUPTION_ERRORS:
                raise first

    def load(self, fingerprint: str | None = None, sink=None) -> Snapshot | None:
        """Newest intact snapshot, or None when the store is empty.

        A corrupt current generation rolls back to ``.prev`` (promoted to
        the current slot, the condemned directory preserved at
        ``*.corrupt`` — ``checkpoint_rollback`` records through ``sink``);
        a wrong ``fingerprint`` raises :class:`FingerprintMismatch`
        without rollback. ``sink`` also gets a ``snapshot_load`` record.
        """
        t0 = time.perf_counter()
        out = _load_with_rollback(
            self._gen(), self._prev(),
            lambda p: self._read_confirmed(p, fingerprint),
            sink, "snapshot",
            f"delete {self._gen()!r} (and its .prev) and republish",
        )
        if out is None:
            return None
        snap, version = out
        if sink is not None:
            sink.emit(
                "snapshot_load", version=int(version), path=snap.path,
                snapshot_id=snap.snapshot_id,
                seconds=round(time.perf_counter() - t0, 4),
            )
        return snap
