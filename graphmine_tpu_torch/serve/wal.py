"""Durable write-ahead delta log and log shipping.

Counterpart of ``graphmine_tpu/serve/wal.py``, whole, with the same frame
format, ``COMMIT`` watermark file, records and gauges, so either package
reads the other's log directories. Host code: nothing here touches a
device, so an append (and the 202 that follows it) never waits on the
card.

- :class:`WriteAheadLog`: an append-only segmented log of
  admission-accepted delta batches. Every entry is a checksummed frame
  (seq + length header, sha256, JSON payload), append-fsync'd before the
  acceptance is answered. Readers tolerate a torn tail: a kill mid-append
  leaves a tail the next open detects, truncates and appends past; damage
  anywhere else raises :class:`WalCorruptionError`. Segments rotate at a
  size bound, and compaction is keyed to the published snapshot version:
  the apply worker commits a durable ``(applied_seq, snapshot_version)``
  watermark after each publish, and segments wholly below it are pruned
  (a retained tail keeps the dedupe horizon).
- Idempotency: entries carry the client's delta id (``X-Delta-Id``);
  :meth:`WriteAheadLog.append` dedupes on ``(tenant, id)`` under the log's
  lock, so a retry after a lost acknowledgement never applies twice.
- :class:`LogShipper`: the standby side. It tails the primary's
  ``GET /wal?from=seq``, appends the entries verbatim (same seq, same id)
  into the standby's own log, and merges the primary's watermark history,
  keeping the copy within an observable lag (``ship_lag`` records and the
  ``/healthz`` replication gauges). A standby on its own bootstrap copy of
  the store places its replay cursor from that history
  (:meth:`WriteAheadLog.replay_floor`, :meth:`WriteAheadLog.rewind`).

Epoch fencing lives in :mod:`~graphmine_tpu_torch.serve.snapshot`: a
deposed writer's publish is refused at the store with
:class:`~graphmine_tpu_torch.serve.snapshot.PublishFencedError`.
"""

from __future__ import annotations

import bisect
import glob
import hashlib
import json
import os
import struct
import threading
import time
from urllib import request as urlrequest

from graphmine_tpu_torch.pipeline.checkpoint import _fsync_dir, _fsync_file
from graphmine_tpu_torch.serve.tenancy import DEFAULT_TENANT

# Segment framing. Each segment starts with the magic; each record is
#   <8-byte seq little-endian> <4-byte payload length> <32-byte sha256> <payload>
# A record whose bytes run out, or whose digest disagrees, is a torn
# tail: everything before it is intact (appends are sequential and each
# append fsyncs), everything from it on is discarded.
_MAGIC = b"GMWAL1\x00\n"
_HDR = struct.Struct("<QI")
_DIGEST_LEN = 32

DEFAULT_SEGMENT_BYTES = 4 << 20
# Fully-applied segments kept after compaction: the duplicate-submit
# dedupe horizon (a retry older than the retained tail re-applies; the
# retention bound is the documented contract, not a silent cap).
DEFAULT_RETAIN_SEGMENTS = 2

_ENV_SEGMENT = "GRAPHMINE_WAL_SEGMENT_BYTES"
_ENV_RETAIN = "GRAPHMINE_WAL_RETAIN_SEGMENTS"

COMMIT_NAME = "COMMIT"

# Watermark-history bound: one (applied_seq, snapshot_version) pair per
# publish, kept in the COMMIT file. The history is what maps a snapshot
# VERSION back to a replay cursor — a promotion that adopts a store
# older than the mirrored watermark (separate-store standby) rewinds to
# the pair vouching for the adopted version instead of trusting the
# primary's watermark about a store it never published to. Bounded so
# the COMMIT file stays small; a bootstrap older than the bound falls
# back to the loud no-voucher path, never a silent wrong cursor.
HISTORY_MAX = 4096


class WalCorruptionError(RuntimeError):
    """Damaged bytes in a *non-tail* position: history this log already
    acknowledged is unreadable. Refused loudly (the checkpoint-reader
    contract) — silently dropping acknowledged entries is the exact
    failure mode the WAL exists to prevent."""


def _env_int(var: str, default: int) -> int:
    raw = os.environ.get(var)
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError as e:
        raise ValueError(f"{var}={raw!r} is not an int") from e


def _parse_frames(blob: bytes) -> tuple[list, int, str | None]:
    """Walk the record frames in ``blob`` (offsets relative to its
    start). Returns ``(frames, valid_end, tear)``: ``frames`` is
    ``[(seq, entry, offset)]`` for every intact record, ``valid_end``
    the byte length of the intact prefix, ``tear`` the first damage
    found (``None`` = clean to the end). The ONE owner of the frame
    format — open-time recovery classifies the tear, shipping reads
    just stop at it."""
    frames, pos = [], 0
    while pos < len(blob):
        if pos + _HDR.size + _DIGEST_LEN > len(blob):
            return frames, pos, "truncated frame header"
        seq, length = _HDR.unpack_from(blob, pos)
        start = pos + _HDR.size + _DIGEST_LEN
        if start + length > len(blob):
            return frames, pos, f"payload of seq {seq} truncated"
        payload = blob[start: start + length]
        if hashlib.sha256(payload).digest() != blob[pos + _HDR.size: start]:
            return frames, pos, f"checksum mismatch at seq {seq}"
        try:
            entry = json.loads(payload.decode())
        except ValueError:
            return frames, pos, f"unparseable payload at seq {seq}"
        frames.append((int(seq), entry, pos))
        pos = start + length
    return frames, pos, None


class _Segment:
    """Bookkeeping for one on-disk segment file. ``index`` maps each
    intact record to its byte offset (``(seq, offset)`` pairs, seq
    ascending — appends are monotone) so tail reads seek instead of
    re-checksumming the whole segment on every shipping poll."""

    __slots__ = ("path", "first_seq", "last_seq", "size", "index")

    def __init__(self, path: str, first_seq: int):
        self.path = path
        self.first_seq = first_seq
        self.last_seq = 0        # 0 = no intact records yet
        self.size = len(_MAGIC)
        self.index: list[tuple[int, int]] = []


class WriteAheadLog:
    """Segmented, fsync'd, checksummed write-ahead log of delta batches.

    One writer per directory is the concurrency contract (the snapshot
    store's rule); any number of readers may scan (:meth:`entries` is
    what the primary's ``GET /wal`` serves and the standby's shipper
    consumes). All mutation happens under one lock; ``append`` returns
    only after the record's bytes AND the segment file are fsync'd.

    Entry shape (the JSON payload inside each frame)::

        {"seq": int, "op": "delta" | "skip", "id": str,
         "payload": {...the POST /delta body...},
         "deadline_s": float | None, "t": epoch-seconds}

    Entries for a non-default tenant additionally carry ``"tenant"``:
    the tenant id rides the durable frame so standby replay
    routes each entry back to ITS tenant's apply queue, and idempotency
    dedupe is scoped ``(tenant, delta_id)`` — two tenants may reuse the
    same client-side id without colliding, and a retry can never be
    answered with another tenant's seq. An absent key is the default
    tenant (every pre-tenancy frame), so existing logs replay unchanged.

    ``skip`` entries are tombstones: a WAL-durable batch that was shed
    off the queue (deadline expiry) before applying — replay excludes
    the skipped seq, and the shed entry's id leaves the dedupe map so
    the retry the 503 asked for re-accepts as a fresh entry (dedupe
    against a tombstoned seq would report the work applied when replay
    explicitly excludes it).
    """

    def __init__(
        self,
        root: str,
        segment_max_bytes: int | None = None,
        retain_segments: int | None = None,
        sink=None,
        registry=None,
        read_only: bool = False,
        shard: int | None = None,
    ):
        self.root = root
        # Writer-shard identity (serve/shardplane.py): when set, the seq
        # gauges export as per-shard-labeled children
        # (``...{shard="2"}``) — one unlabeled gauge would silently
        # average a dead shard's backlog into healthy ranges.
        self.shard = None if shard is None else int(shard)
        # read_only opens a FOREIGN log (a promotion reading the deposed
        # primary's directory): scan must not repair — truncating a
        # "torn" tail that is really the still-alive zombie's in-flight
        # append would destroy a frame it is about to fsync and
        # acknowledge (silent acked loss on shared storage). Mutators
        # refuse; the intact prefix is readable as usual.
        self.read_only = read_only
        # Set when an append failure left the active segment's tail in
        # an unknown state (the rollback itself failed) — every later
        # append refuses until a restart re-scans the segments.
        self._failed: str | None = None
        self.sink = sink
        self.registry = registry
        self.segment_max_bytes = (
            segment_max_bytes if segment_max_bytes is not None
            else _env_int(_ENV_SEGMENT, DEFAULT_SEGMENT_BYTES)
        )
        self.retain_segments = max(1, (
            retain_segments if retain_segments is not None
            else _env_int(_ENV_RETAIN, DEFAULT_RETAIN_SEGMENTS)
        ))
        self._lock = threading.Lock()
        self._segments: list[_Segment] = []
        self._active = None            # open file handle of the last segment
        self._last_seq = 0
        self._applied_seq = 0
        self._applied_version = 0
        # (applied_seq, snapshot_version) pairs, ascending by seq — the
        # version→cursor map replay_floor answers from.
        self._history: list[tuple[int, int]] = []
        # (tenant, delta_id) -> seq (process lifetime): the idempotency
        # map is tenant-scoped so ids never collide across tenants
        self._ids: dict[tuple[str, str], int] = {}
        self._skipped: set[int] = set()
        # The watermark is a CONTIGUOUS floor: every seq at or below it
        # is resolved (published, or a tombstone). Concurrent accepts
        # fsync outside the queue lock, so a group can publish seq N+1
        # while acked seq N is still racing toward the queue — the floor
        # must never jump that gap (a crash in the window would make
        # restart replay skip the acked entry: silent loss).
        # _applied_above holds published seqs stuck above an unresolved
        # gap (persisted in COMMIT, vouched per-snapshot by the
        # manifest's wal_applied_above); _meta_above holds non-work seqs
        # (tombstone records and their targets) the floor may pass.
        self._applied_above: set[int] = set()
        self._meta_above: set[int] = set()
        # Standby compaction guard: when set, never prune entries the
        # store version named here has not absorbed (its replay floor) —
        # the primary's mirrored watermark describes the PRIMARY's
        # store, and pruning against it would eat entries a
        # separate-store promotion still needs to replay.
        self.protect_version: int | None = None
        # The lock-free stats cache snapshot()/healthz read (see the seq
        # properties below for why it must not take the lock).
        self._snap: dict = {}
        if not self.read_only:
            os.makedirs(self.root, exist_ok=True)
        self._load_commit()
        self._scan()
        self._refresh_snap_locked()
        self._export()

    # -- open / recovery ---------------------------------------------------
    def _seg_path(self, first_seq: int) -> str:
        return os.path.join(self.root, f"wal-{first_seq:012d}.seg")

    def _load_commit(self) -> None:
        try:
            with open(os.path.join(self.root, COMMIT_NAME)) as f:
                body = json.load(f)
            self._applied_seq = int(body.get("applied_seq", 0))
            self._applied_version = int(body.get("snapshot_version", 0))
            self._history = [
                (int(s), int(v)) for s, v in body.get("history", ())
            ]
            self._applied_above = {
                int(s) for s in body.get("applied_above", ())
                if int(s) > self._applied_seq
            }
            if not self._history and self._applied_seq > 0:
                # pre-history COMMIT format: the latest pair is all we
                # can vouch for
                self._history = [(self._applied_seq, self._applied_version)]
        except (OSError, ValueError):
            pass  # empty/absent watermark: nothing applied yet

    def _scan(self) -> None:
        """Open-time recovery: read every retained segment, verify each
        frame, tolerate (and truncate) a torn tail in the LAST segment,
        refuse damage anywhere else."""
        paths = sorted(glob.glob(os.path.join(self.root, "wal-*.seg")))
        for i, path in enumerate(paths):
            last = i == len(paths) - 1
            seg = _Segment(path, 0)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError as e:
                raise WalCorruptionError(f"cannot read {path}: {e}") from e
            if not blob.startswith(_MAGIC):
                if last and len(blob) < len(_MAGIC):
                    # killed between create and the magic fsync: an empty
                    # husk, not history — drop it (read-only leaves the
                    # foreign file alone: it may be the live owner's
                    # create-in-progress)
                    if not self.read_only:
                        os.remove(path)
                    continue
                raise WalCorruptionError(
                    f"{path} lacks the WAL segment magic; this directory "
                    "holds something that is not a graphmine WAL"
                )
            frames, valid_rel, torn = _parse_frames(blob[len(_MAGIC):])
            valid = len(_MAGIC) + valid_rel
            for seq, entry, off in frames:
                self._index(entry)
                seg.index.append((seq, off + len(_MAGIC)))
                if seg.first_seq == 0:
                    seg.first_seq = seq
                seg.last_seq = seq
            if torn is not None:
                if not last:
                    raise WalCorruptionError(
                        f"{path}: {torn} in a non-tail segment — "
                        "acknowledged history is damaged; restore the "
                        "directory from the standby's copy"
                    )
                if not self.read_only:
                    # torn tail: keep the intact prefix, drop the tear so
                    # the next append continues from a clean boundary. A
                    # read-only open of a FOREIGN log must not: the
                    # "tear" may be the live owner's in-flight append,
                    # and truncating it under the owner destroys a frame
                    # it is about to fsync and acknowledge.
                    with open(path, "r+b") as f:
                        f.truncate(valid)
                    _fsync_file(path)
                    if self.sink is not None:
                        self.sink.emit(
                            "wal_replay", entries=0,
                            from_seq=self._last_seq + 1,
                            torn_tail=torn, truncated_to=valid, path=path,
                        )
            seg.size = valid
            if seg.first_seq == 0:
                seg.first_seq = self._last_seq + 1  # intact but empty
            self._segments.append(seg)

    def _index(self, entry: dict) -> None:
        seq = int(entry["seq"])
        self._last_seq = max(self._last_seq, seq)
        if entry.get("op") == "skip":
            skipped = int(entry.get("skip_seq", 0))
            self._skipped.add(skipped)
            # neither the tombstone record nor its target is unapplied
            # work: the contiguous floor may advance past both
            self._meta_above.add(seq)
            self._meta_above.add(skipped)
            # the shed entry's id leaves the dedupe map: the client was
            # TOLD the work was shed (503 + Retry-After), so its retry
            # must re-accept as a fresh entry — answering "duplicate"
            # against a tombstoned seq would swallow the very retry the
            # server asked for (silent acknowledged loss)
            for key, s in list(self._ids.items()):
                if s == skipped:
                    del self._ids[key]
        elif entry.get("id"):
            tenant = entry.get("tenant") or DEFAULT_TENANT
            self._ids.setdefault((tenant, entry["id"]), seq)

    # -- append ------------------------------------------------------------
    def _open_active(self) -> None:
        if self._active is not None:
            return
        if self._segments:
            seg = self._segments[-1]
            self._active = open(seg.path, "ab")
            return
        self._new_segment(self._last_seq + 1)

    def _new_segment(self, first_seq: int) -> None:
        if self._active is not None:
            self._active.close()
            self._active = None
        seg = _Segment(self._seg_path(first_seq), first_seq)
        self._active = open(seg.path, "ab")
        self._active.write(_MAGIC)
        self._active.flush()
        os.fsync(self._active.fileno())
        _fsync_dir(self.root)
        seg.last_seq = 0
        self._segments.append(seg)

    def append(
        self,
        payload: dict,
        delta_id: str = "",
        deadline_s: float | None = None,
        seq: int | None = None,
        t: float | None = None,
        trace: str = "",
        tenant: str = DEFAULT_TENANT,
    ) -> tuple[int, bool]:
        """Durably append one accepted delta batch; returns
        ``(seq, duplicate)``.

        ``duplicate=True`` means the id (or, for a shipped copy, the
        explicit ``seq``) is already in the log — nothing was written,
        and the returned seq is the original's (the idempotency
        contract: a client retry after a lost acknowledgement maps onto
        the first accept instead of minting a second apply).

        ``seq``: explicit sequence number for the log-shipping copy
        path — the standby appends the primary's entries verbatim so
        both logs speak one sequence space. Client appends leave it
        None and take the next local seq. Returns only after the
        record's bytes and the segment file are fsync'd.

        ``trace``: the accepting request's propagated trace header
        (``obs/spans.py`` :class:`TraceContext` wire form) — carried in
        the durable entry so the trace survives fsync → ship → standby
        replay, and a promoted writer's apply of a shipped entry still
        lands in the ORIGINATING request's trace.

        ``tenant``: the owning tenant, durable in the frame
        for non-default tenants, and the dedupe scope for ``delta_id``.
        """
        t0 = time.perf_counter()
        with self._lock:
            if seq is not None and int(seq) <= self._last_seq:
                return int(seq), True   # shipped retry: already copied
            dedupe_key = (tenant or DEFAULT_TENANT, delta_id)
            if seq is None and delta_id and dedupe_key in self._ids:
                return self._ids[dedupe_key], True
            use_seq = int(seq) if seq is not None else self._last_seq + 1
            entry = {
                "seq": use_seq,
                "op": "delta",
                "id": delta_id or "",
                "payload": payload,
                "deadline_s": deadline_s,
                "t": time.time() if t is None else float(t),
            }
            if trace:
                entry["trace"] = trace
            if tenant and tenant != DEFAULT_TENANT:
                entry["tenant"] = tenant
            written = self._write_locked(entry)
            self._index(entry)
            self._refresh_snap_locked()
        seconds = time.perf_counter() - t0
        self._export()
        if self.sink is not None:
            rows = 0
            if isinstance(payload, dict):
                rows = len(payload.get("insert", ()) or ()) + len(
                    payload.get("delete", ()) or ()
                )
            self.sink.emit(
                "wal_append", seq=use_seq, rows=rows, bytes=written,
                seconds=round(seconds, 6), delta_id=delta_id or "",
            )
        return use_seq, False

    def skip(self, skip_seq: int) -> int:
        """Tombstone a durable-but-shed entry so replay excludes it."""
        with self._lock:
            entry = {
                "seq": self._last_seq + 1,
                "op": "skip",
                "skip_seq": int(skip_seq),
                "t": time.time(),
            }
            self._write_locked(entry)
            self._index(entry)
            self._refresh_snap_locked()
            return entry["seq"]

    def _write_locked(self, entry: dict) -> int:
        self._assert_writable_locked()
        self._open_active()
        seg = self._segments[-1]
        if seg.size > self.segment_max_bytes and seg.last_seq:
            self._new_segment(int(entry["seq"]))
            seg = self._segments[-1]
        payload = json.dumps(entry, separators=(",", ":")).encode()
        frame = (
            _HDR.pack(int(entry["seq"]), len(payload))
            + hashlib.sha256(payload).digest()
            + payload
        )
        try:
            self._active.write(frame)
            self._active.flush()
            os.fsync(self._active.fileno())
        except OSError:
            # The frame may be partially on disk while bookkeeping has
            # not advanced: left alone, the caller's retry of this seq
            # would land AFTER the orphan bytes — two frames under one
            # seq, every later index offset shifted by the orphan, so
            # shipping seeks land mid-frame and restart replay can apply
            # both payloads. Roll the file back to the last frame
            # boundary so disk and bookkeeping agree again; if even that
            # fails, the segment's tail state is unknown — poison the
            # log so every later append refuses loudly instead of
            # acknowledging into a file we can no longer reason about.
            try:
                self._active.truncate(seg.size)
                self._active.flush()
                os.fsync(self._active.fileno())
            except OSError as e2:
                self._failed = (
                    f"append of seq {entry['seq']} failed and the "
                    f"segment could not be rolled back: {e2!r}"
                )
            raise
        seg.index.append((int(entry["seq"]), seg.size))
        seg.size += len(frame)
        if seg.first_seq == 0 or seg.last_seq == 0:
            seg.first_seq = min(seg.first_seq or entry["seq"], entry["seq"])
        seg.last_seq = max(seg.last_seq, int(entry["seq"]))
        return len(frame)

    def _assert_writable_locked(self) -> None:
        if self.read_only:
            raise ValueError(
                f"{self.root}: write-ahead log opened read_only (a "
                "foreign directory — promotions read the deposed "
                "primary's log, they never write it)"
            )
        if self._failed is not None:
            raise WalCorruptionError(
                f"{self.root}: log poisoned by an earlier append "
                f"failure — {self._failed}; restart to re-scan the "
                "segments before accepting new writes"
            )

    # -- the applied watermark / compaction --------------------------------
    def _advance_floor_locked(self) -> bool:
        """Move the contiguous floor up through resolved seqs: published
        entries parked in ``_applied_above`` and non-work seqs
        (tombstones + targets) in ``_meta_above``. Stops at the first
        seq that is neither — an acked entry still racing toward the
        apply queue, whose loss the floor exists to prevent."""
        moved = False
        while True:
            nxt = self._applied_seq + 1
            if nxt in self._applied_above:
                self._applied_above.discard(nxt)
            elif nxt in self._meta_above:
                self._meta_above.discard(nxt)
            else:
                break
            self._applied_seq = nxt
            moved = True
        return moved

    def commit(self, applied_seq: int, snapshot_version: int) -> None:
        """Durably record that every entry up to ``applied_seq`` is
        reflected in published snapshot ``snapshot_version``, then prune
        fully-applied segments past the retention tail. The watermark is
        what replay keys off — compaction is therefore keyed to the
        published snapshot version, never to wall clock.

        This is the ABSOLUTE form (ship mirror, reconcile forward-jump:
        the caller holds an external voucher that everything at or below
        ``applied_seq`` is in the snapshot). The apply worker commits
        through :meth:`commit_applied`, which only advances the floor
        over a contiguous resolved run."""
        with self._lock:
            if int(applied_seq) <= self._applied_seq:
                return
            self._applied_seq = int(applied_seq)
            self._applied_version = int(snapshot_version)
            self._applied_above = {
                s for s in self._applied_above if s > self._applied_seq
            }
            self._meta_above = {
                s for s in self._meta_above if s > self._applied_seq
            }
            self._advance_floor_locked()
            self._history.append((self._applied_seq, self._applied_version))
            del self._history[:-HISTORY_MAX]
            self._write_commit_locked()
            self._compact_locked()
            self._refresh_snap_locked()
        self._export()

    def commit_applied(self, seqs, snapshot_version: int) -> None:
        """Mark published entry seqs resolved and advance the watermark
        over the contiguous resolved prefix — the apply worker's (and
        the reconcile voucher's) commit path. Seqs above an unresolved
        gap persist in the COMMIT file's ``applied_above`` so a crash
        can't replay (double-apply) them, while the floor itself never
        jumps an acked-but-unapplied entry (silent loss on restart —
        the exact hole the WAL closes). The ``(floor, version)``
        history pair is appended only when the floor moves; the
        snapshot at ``snapshot_version`` contains every resolved entry
        by construction (publishes are cumulative)."""
        with self._lock:
            new = {
                int(s) for s in seqs
                if int(s) > self._applied_seq
                and int(s) not in self._applied_above
            }
            if not new:
                return
            self._applied_above |= new
            if self._advance_floor_locked():
                self._applied_version = int(snapshot_version)
                self._history.append(
                    (self._applied_seq, self._applied_version)
                )
                del self._history[:-HISTORY_MAX]
            self._write_commit_locked()
            self._compact_locked()
            self._refresh_snap_locked()
        self._export()

    def preview_commit(self, seqs) -> tuple[int, list[int]]:
        """What :meth:`commit_applied` *would* leave as ``(floor,
        applied_above)`` — computed without mutating, so the apply
        worker can stamp the manifest voucher BEFORE the publish whose
        success the real commit waits on."""
        with self._lock:
            above = set(self._applied_above) | {
                int(s) for s in seqs if int(s) > self._applied_seq
            }
            meta = set(self._meta_above)
            floor = self._applied_seq
            while True:
                nxt = floor + 1
                if nxt in above:
                    above.discard(nxt)
                elif nxt in meta:
                    meta.discard(nxt)
                else:
                    break
                floor = nxt
            return floor, sorted(above)

    def seq_applied(self, seq: int) -> bool:
        """Is this entry's effect in a published snapshot? (At or below
        the contiguous floor, or resolved above a gap.)"""
        with self._lock:
            return int(seq) <= self._applied_seq or (
                int(seq) in self._applied_above
            )

    def _write_commit_locked(self) -> None:
        if self.read_only:
            raise ValueError(
                f"{self.root}: write-ahead log opened read_only (a "
                "foreign directory) — refusing to move its COMMIT "
                "watermark"
            )
        tmp = os.path.join(self.root, COMMIT_NAME + ".tmp")
        with open(tmp, "w") as f:
            json.dump({
                "applied_seq": self._applied_seq,
                "snapshot_version": self._applied_version,
                "history": self._history,
                "applied_above": sorted(self._applied_above),
                "t": time.time(),
            }, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(self.root, COMMIT_NAME))
        _fsync_dir(self.root)

    def note_baseline(self, snapshot_version: int) -> None:
        """Record pair ``(0, version)`` — "this store at ``version``
        contains no WAL entries" — once, when a fresh WAL starts next to
        an already-published store. Only a PRIMARY may write it (a
        standby's store is a bootstrap *copy*; the primary's shipped
        history is what vouches for copies). It is the pair that lets a
        later separate-store promotion replay from seq 0 exactly."""
        with self._lock:
            if self._history or self._applied_seq or self._last_seq:
                return  # not fresh: the baseline claim would be a guess
            self._history = [(0, int(snapshot_version))]
            self._applied_version = int(snapshot_version)
            self._write_commit_locked()
            self._refresh_snap_locked()

    def commit_history(self) -> list[tuple[int, int]]:
        """The retained ``(applied_seq, snapshot_version)`` pairs — the
        ship feed carries them so a standby can map any bootstrap copy's
        version back to a replay cursor."""
        with self._lock:
            return list(self._history)

    def merge_history(self, pairs) -> None:
        """Merge a primary's shipped history pairs (ship path). New seqs
        fill in; an existing seq keeps the local pair. The watermark
        advances to the merged maximum — the same mirror the shipper
        used to do with the latest pair only, now with the full map."""
        with self._lock:
            have = {s for s, _ in self._history}
            added = False
            for s, v in pairs:
                s, v = int(s), int(v)
                if s in have:
                    continue
                self._history.append((s, v))
                have.add(s)
                added = True
            if not added:
                return
            self._history.sort()
            del self._history[:-HISTORY_MAX]
            top_seq, top_version = self._history[-1]
            if top_seq > self._applied_seq:
                self._applied_seq = top_seq
                self._applied_version = top_version
            self._write_commit_locked()
            self._compact_locked()
            self._refresh_snap_locked()
        self._export()

    def _replay_floor_locked(self, snapshot_version: int) -> int | None:
        for s, v in reversed(self._history):
            if v == int(snapshot_version):
                return s
        return None

    def replay_floor(self, snapshot_version: int) -> int | None:
        """The replay cursor vouched for ``snapshot_version``: the
        ``applied_seq`` of the pair recorded AT that exact version
        (entries ≤ it are in the snapshot; entries past it are not).
        ``None`` when no retained pair matches — the caller must treat
        the version as unvouched and say so loudly, never guess a
        cursor (an off-by-one replays a non-idempotent delta twice or
        drops an acknowledged one)."""
        with self._lock:
            return self._replay_floor_locked(snapshot_version)

    def rewind(self, applied_seq: int, snapshot_version: int) -> None:
        """Durably move the watermark BACK to ``(applied_seq,
        snapshot_version)`` — the promotion path after adopting a store
        older than the mirrored watermark. Pairs above the new cursor
        describe the deposed primary's lineage, not this store's: they
        drop, and the local apply worker re-records true local pairs as
        the replayed entries publish."""
        with self._lock:
            if int(applied_seq) >= self._applied_seq:
                return
            self._applied_seq = int(applied_seq)
            self._applied_version = int(snapshot_version)
            self._history = [
                (s, v) for s, v in self._history if s < self._applied_seq
            ]
            self._history.append((self._applied_seq, self._applied_version))
            # applied_above pairs above the new cursor describe the
            # deposed lineage's store too — they must replay here.
            # Tombstones (_meta_above) stay: they are log facts, shipped
            # verbatim, true in every copy.
            self._applied_above = {
                s for s in self._applied_above if s <= self._applied_seq
            }
            self._write_commit_locked()
            self._refresh_snap_locked()
        self._export()

    def oldest_retained_seq(self) -> int | None:
        """The smallest seq still readable (compaction prunes below the
        watermark) — ``None`` for an entry-less log. A promotion rewind
        below this has a durability hole it must announce."""
        with self._lock:
            firsts = [s.first_seq for s in self._segments if s.last_seq]
            return min(firsts) if firsts else None

    def _compact_locked(self) -> None:
        floor = self._applied_seq
        if self.protect_version is not None:
            # Standby: the mirrored watermark vouches for the PRIMARY's
            # store. Never prune past what OUR store version has
            # absorbed — a separate-store promotion rewinds there and
            # replays everything above it. No vouching pair retained =
            # protect everything (an unvouched prune is silent acked
            # loss; unbounded growth is the honest price until the
            # bootstrap is refreshed).
            pf = self._replay_floor_locked(self.protect_version)
            floor = 0 if pf is None else min(floor, pf)
        applied = [
            s for s in self._segments
            if s.last_seq and s.last_seq <= floor
        ]
        # never prune the active (last) segment, and keep the newest
        # retain_segments fully-applied ones as the dedupe horizon
        prunable = [s for s in applied if s is not self._segments[-1]]
        for seg in prunable[: max(0, len(prunable) - self.retain_segments)]:
            try:
                os.remove(seg.path)
            except OSError:
                pass  # already gone; the bookkeeping below still drops
                # it — keeping a fileless segment would make
                # oldest_retained_seq() vouch for entries that cannot
                # be read back, silencing the promotion-rewind loss
                # warning that horizon exists to trigger
            self._segments.remove(seg)

    # -- reads -------------------------------------------------------------
    def entries(self, from_seq: int = 0, limit: int = 0) -> list[dict]:
        """Intact entries with ``seq >= from_seq`` in order (both ops —
        the ship path copies tombstones too). ``limit`` bounds one
        response (0 = all retained). The per-segment offset index turns
        a tail read (every shipping poll) into a seek — without it each
        poll re-checksums the whole active segment from byte zero."""
        out: list[dict] = []
        with self._lock:
            plan = []
            for seg in self._segments:
                if seg.last_seq and seg.last_seq < from_seq:
                    continue
                start = len(_MAGIC)
                if seg.index:
                    i = bisect.bisect_left(seg.index, (int(from_seq), -1))
                    if i >= len(seg.index):
                        continue  # every indexed record is below from_seq
                    start = seg.index[i][1]
                plan.append((seg.path, start))
        for path, start in plan:
            for entry in self._read_segment(path, start):
                if int(entry["seq"]) < from_seq:
                    continue
                out.append(entry)
                if limit and len(out) >= limit:
                    return out
        return out

    def _read_segment(self, path: str, start: int | None = None):
        """Yield intact frames from ``start`` (a frame boundary from the
        offset index; ``None`` = first record). Seeks — a tail read must
        not re-read the whole segment from disk on every shipping
        poll."""
        offset = len(_MAGIC) if start is None else int(start)
        try:
            with open(path, "rb") as f:
                f.seek(offset)
                blob = f.read()
        except OSError:
            return
        # a tear here is a racing append (or the torn tail open-time
        # recovery will classify): stop at it, never past it
        frames, _, _ = _parse_frames(blob)
        for _, entry, _ in frames:
            yield entry

    def pending(self) -> list[dict]:
        """Accepted-but-unapplied delta entries (seq above the applied
        watermark, minus tombstoned seqs) — the startup-replay work
        list."""
        with self._lock:
            applied = self._applied_seq
            resolved = set(self._skipped) | set(self._applied_above)
        return [
            e for e in self.entries(applied + 1)
            if e.get("op") == "delta" and int(e["seq"]) not in resolved
        ]

    def copy_from(self, entries) -> int:
        """Append foreign entries VERBATIM (same seq, same id) — the
        log-shipping copy path shared by the standby's shipper and the
        promotion's final tail catch-up. Already-held seqs are skipped
        (idempotent retries); returns how many were newly written."""
        copied = 0
        for entry in entries:
            if entry.get("op") == "skip":
                with self._lock:
                    if int(entry["seq"]) > self._last_seq:
                        self._write_locked(entry)
                        self._index(entry)
                        self._refresh_snap_locked()
                        copied += 1
                continue
            _, dup = self.append(
                entry.get("payload", {}),
                delta_id=entry.get("id", ""),
                deadline_s=entry.get("deadline_s"),
                seq=int(entry["seq"]),
                t=entry.get("t"),
                trace=entry.get("trace", ""),
                tenant=entry.get("tenant") or DEFAULT_TENANT,
            )
            if not dup:
                copied += 1
        return copied

    def lookup(
        self, delta_id: str, tenant: str = DEFAULT_TENANT,
    ) -> int | None:
        with self._lock:
            return self._ids.get((tenant or DEFAULT_TENANT, delta_id))

    # The seq properties and snapshot() are deliberately LOCK-FREE:
    # append() holds the log's lock across its fsyncs, and /healthz (the
    # fleet prober's verdict) reads these — taking the lock here would
    # couple probe latency to write-path disk stalls, and a >timeout
    # fsync stall would mark a live, merely-slow writer DOWN and fire a
    # promotion against a healthy primary. Ints are rebound atomically
    # under the GIL; the stats dict is rebuilt under the lock by every
    # mutator and swapped in with one reference assignment.
    @property
    def last_seq(self) -> int:
        return self._last_seq

    @property
    def applied_seq(self) -> int:
        return self._applied_seq

    @property
    def applied_version(self) -> int:
        return self._applied_version

    def _refresh_snap_locked(self) -> None:
        """Rebuild the cached stats dict (callers hold the lock).
        ``pending_entries`` counts acked-but-unpublished work: the
        above-floor span minus seqs resolved ABOVE the floor (published
        over a gap, tombstones + their targets). The all-time
        ``_skipped`` set must not be subtracted — seqs the floor already
        passed would be double-counted and the gauge would read 0 while
        a durable acknowledged delta still awaits apply."""
        floor = self._applied_seq
        resolved_above = sum(1 for s in self._applied_above if s > floor)
        resolved_above += sum(1 for s in self._meta_above if s > floor)
        self._snap = {
            "last_seq": self._last_seq,
            "applied_seq": floor,
            "applied_version": self._applied_version,
            "pending_entries": max(
                0, self._last_seq - floor - resolved_above
            ),
            "segments": len(self._segments),
            "segment_bytes": sum(s.size for s in self._segments),
        }

    def snapshot(self) -> dict:
        return dict(self._snap)

    def _export(self) -> None:
        reg = self.registry
        if reg is None:
            return
        snap = self.snapshot()
        # A shard-owned WAL exports labeled children; the single-writer
        # log keeps the exact pre-shard unlabeled series.
        lab = {} if self.shard is None else {"shard": str(self.shard)}
        reg.gauge(
            "graphmine_serve_wal_last_seq",
            "highest sequence number appended to the write-ahead log",
            **lab,
        ).set(snap["last_seq"])
        reg.gauge(
            "graphmine_serve_wal_applied_seq",
            "WAL watermark: entries at or below this seq are published",
            **lab,
        ).set(snap["applied_seq"])
        reg.gauge(
            "graphmine_serve_wal_pending_entries",
            "WAL entries accepted but not yet in a published snapshot",
            **lab,
        ).set(snap["pending_entries"])
        # memory plane: retained-segment bytes on the same scrape as the
        # seq gauges (name and help owned by obs/memmodel)
        from graphmine_tpu_torch.obs.memmodel import export_memory_gauges

        export_memory_gauges(
            reg, {"wal_segment_bytes": snap["segment_bytes"]}
        )

    def close(self) -> None:
        with self._lock:
            if self._active is not None:
                self._active.close()
                self._active = None


class LogShipper:
    """Standby-side WAL tailer: keeps a verbatim durable copy of the
    primary's log within a bounded, observable replication lag.

    Polls ``GET {primary_url}/wal?from=<local last_seq + 1>`` on a
    cadence, appends fetched entries into the standby's own
    :class:`WriteAheadLog` (same seq, same id — one sequence space
    across the pair), and merges the primary's watermark history so the
    shared-store promotion never replays work the primary already
    published — while a separate-store promotion can still map its own
    adopted version to the exact replay cursor. Lag is
    exported two ways: entries behind (``primary last_seq - local
    last_seq``) and seconds behind (age of the oldest entry not yet
    shipped), as ``ship_lag`` records (rate-limited) and registry
    gauges; ``/healthz`` on a standby server surfaces both.

    ``chaos_delay_s`` is the :func:`~graphmine_tpu_torch.testing.faults.ship_lag`
    injector's seam — an extra sleep before each poll, the deterministic
    stand-in for a slow replication link. Production value is 0.0.
    """

    def __init__(
        self,
        wal: WriteAheadLog,
        primary_url: str,
        poll_interval_s: float = 0.2,
        timeout_s: float = 5.0,
        batch_limit: int = 512,
        sink=None,
        registry=None,
        shard: int | None = None,
    ):
        self.wal = wal
        # Per-range shipping lane: labels the lag gauges so one
        # range's replication stall never hides inside a plane average.
        self.shard = None if shard is None else int(shard)
        self.primary_url = primary_url.rstrip("/")
        self.poll_interval_s = float(poll_interval_s)
        self.timeout_s = float(timeout_s)
        self.batch_limit = int(batch_limit)
        self.sink = sink
        self.registry = registry
        self.chaos_delay_s = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()
        self._primary_last_seq = 0
        self._primary_epoch = 0
        self._behind_since: float | None = None
        self._polls = 0
        self._errors = 0
        self._last_error = ""
        self._last_emit = 0.0

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="graphmine-wal-shipper", daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            delay = self.chaos_delay_s
            if delay > 0:
                self._stop.wait(delay)  # ship_lag injector
                if self._stop.is_set():
                    return
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the shipper must not die
                with self._lock:
                    self._errors += 1
                    self._last_error = repr(e)
            self._stop.wait(self.poll_interval_s)

    # -- one poll ----------------------------------------------------------
    def poll_once(self) -> dict:
        """One catch-up pass (public so tests and the promotion path can
        drive it deterministically): fetch from the primary, append the
        batch, mirror the watermark, refresh the lag verdict. Returns
        the shipped summary; raises on transport failure (the loop
        counts it; promotion treats an unreachable primary as 'ship what
        we have')."""
        from_seq = self.wal.last_seq + 1
        url = f"{self.primary_url}/wal?from={from_seq}&limit={self.batch_limit}"
        with urlrequest.urlopen(url, timeout=self.timeout_s) as resp:
            body = json.loads(resp.read().decode())
        # tombstones ship verbatim too, so the standby's replay
        # exclusion matches the primary's
        shipped = self.wal.copy_from(body.get("entries", ()))
        hist = body.get("history")
        if hist:
            # the full (seq, version) map, so a separate-store promotion
            # can place its adopted bootstrap version on the log exactly
            self.wal.merge_history(hist)
        else:  # pre-history primary: mirror the latest pair as before
            applied = int(body.get("applied_seq", 0))
            if applied > self.wal.applied_seq:
                self.wal.commit(applied, int(body.get("applied_version", 0)))
        now = time.monotonic()
        with self._lock:
            self._polls += 1
            self._primary_last_seq = int(
                body.get("last_seq", self._primary_last_seq)
            )
            self._primary_epoch = int(body.get("epoch", self._primary_epoch))
            behind = self._primary_last_seq - self.wal.last_seq
            if behind > 0:
                if self._behind_since is None:
                    self._behind_since = now
            else:
                self._behind_since = None
        snap = self.snapshot()
        self._export(snap)
        if snap["lag_entries"] > 0 and self.sink is not None:
            if now - self._last_emit >= 1.0:  # rate-limit the record spam
                self._last_emit = now
                self.sink.emit(
                    "ship_lag",
                    lag_entries=snap["lag_entries"],
                    lag_s=snap["lag_s"],
                    primary_last_seq=snap["primary_last_seq"],
                    shipped_seq=snap["shipped_seq"],
                )
        return {"shipped": shipped, **snap}

    def snapshot(self) -> dict:
        local = self.wal.last_seq
        with self._lock:
            behind = max(0, self._primary_last_seq - local)
            lag_s = (
                round(time.monotonic() - self._behind_since, 3)
                if self._behind_since is not None else 0.0
            )
            return {
                "primary_last_seq": self._primary_last_seq,
                "primary_epoch": self._primary_epoch,
                "shipped_seq": local,
                "lag_entries": behind,
                "lag_s": lag_s,
                "polls": self._polls,
                "errors": self._errors,
                "last_error": self._last_error,
            }

    def _export(self, snap: dict) -> None:
        reg = self.registry
        if reg is None:
            return
        lab = {} if self.shard is None else {"shard": str(self.shard)}
        reg.gauge(
            "graphmine_serve_replication_lag_entries",
            "WAL entries the standby has not yet shipped from the primary",
            **lab,
        ).set(snap["lag_entries"])
        reg.gauge(
            "graphmine_serve_replication_lag_seconds",
            "how long the standby has been behind the primary's WAL",
            **lab,
        ).set(snap["lag_s"])
