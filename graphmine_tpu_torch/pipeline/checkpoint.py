"""Checkpoint / resume of the LPA labels, and the durable formats' helpers.

Counterpart of ``graphmine_tpu/pipeline/checkpoint.py`` on one device:

- :func:`save_labels` / :func:`load_labels`: one atomic npz of the labels
  and the iteration, with the graph fingerprint and a state checksum, two
  rotated generations and rollback to the older one on corruption. The
  npz is the JAX package's format, byte for byte in its fields, so each
  package resumes from the other's checkpoint;
- :func:`save_sharded` / :func:`load_sharded`: the multi-device format,
  per-shard ``.npy`` files and a JSON manifest (fingerprint, mesh shape,
  iteration, each shard's sha256, a checksum of its own), with the same
  two generations and rollback; the loader returns the whole label
  vector, so a checkpoint written on D shards resumes on D' (re-shard on
  restore). The manifest has the JAX package's fields, so either package
  loads the other's;
- :func:`load_newest`: the resume entry point, the newer of the two
  formats (one corrupt beyond its rollback does not veto the other);
- the graph fingerprint, file and manifest hashes, fsync helpers and the
  rollback state machine that the snapshot store
  (:mod:`graphmine_tpu_torch.serve.snapshot`) shares.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import zipfile
import zlib

import numpy as np


class CheckpointCorruptionError(RuntimeError):
    """A generation failed its integrity check (zip CRC or state checksum)
    and no good fallback existed. The message names every file tried."""


class FingerprintMismatch(ValueError):
    """The generation indexes a different graph or id assignment. Not
    corruption: rolling back to an older generation of the same wrong
    graph would not help, so this always propagates."""


# What damaged bytes can raise on a read: truncation, bad CRCs, header
# damage, and the checksum verdicts themselves.
_CORRUPTION_ERRORS = (
    zipfile.BadZipFile, zlib.error, EOFError, KeyError, OSError,
    ValueError, CheckpointCorruptionError,
)


def graph_fingerprint(src, dst, weights=None) -> str:
    """SHA-1 of the int32 edge arrays (and the float32 weights, after a
    ``b"w"`` marker): the identity of the data and of its id assignment,
    so outputs indexed by vertex id never load against another graph."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(np.asarray(src, np.int32)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(dst, np.int32)).tobytes())
    if weights is not None:
        h.update(b"w")
        h.update(np.ascontiguousarray(np.asarray(weights, np.float32)).tobytes())
    return h.hexdigest()


def _state_checksum(labels: np.ndarray, iteration: int, fingerprint: str) -> str:
    """SHA-256 of the checkpoint state (labels' bytes, dtype and shape,
    the iteration and the fingerprint), written at save time and
    re-derived at load time: catches a member rewritten consistently
    enough to pass its zip CRC."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(labels).tobytes())
    h.update(str(labels.dtype).encode())
    h.update(str(labels.shape).encode())
    h.update(str(int(iteration)).encode())
    h.update((fingerprint or "").encode())
    return h.hexdigest()


def _prev_path(path: str) -> str:
    return path[: -len(".npz")] + ".prev.npz"


def _host_array(labels) -> np.ndarray:
    """A tensor (any device) or array as a host NumPy array."""
    if hasattr(labels, "detach"):
        return labels.detach().cpu().numpy()
    return np.asarray(labels)


def _tree_bytes(path: str) -> int:
    """Bytes of a file, or of the files directly in a directory."""
    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    return os.path.getsize(path)


def _load_with_rollback(path, prev, read_confirmed, sink, what, delete_hint):
    """Read the current generation at ``path``; on corruption roll back to
    ``prev``, promote it to the current slot and set the condemned
    generation aside at a ``.corrupt`` name. ``read_confirmed(p)`` returns
    ``(payload, counter)``. Returns None when neither generation exists.
    ``checkpoint_rollback`` (and ``checkpoint_rollback_ok``) records go to
    ``sink`` only when a previous generation exists to roll back to;
    :class:`FingerprintMismatch` propagates untouched."""
    if not os.path.exists(path) and not os.path.exists(prev):
        return None
    try:
        if not os.path.exists(path):
            raise CheckpointCorruptionError(
                f"{what} at {path} is missing (previous generation exists at {prev})"
            )
        return read_confirmed(path)
    except FingerprintMismatch:
        raise
    except _CORRUPTION_ERRORS as e:
        primary_error = e
    if not os.path.exists(prev):
        raise CheckpointCorruptionError(
            f"{what} at {path} is corrupt ({primary_error!r}) and no "
            f"previous generation exists; {delete_hint}"
        ) from primary_error
    if sink is not None:
        sink.emit("checkpoint_rollback", path=path, error=repr(primary_error))
    try:
        payload, counter = read_confirmed(prev)
    except FingerprintMismatch:
        raise
    except _CORRUPTION_ERRORS as e2:
        raise CheckpointCorruptionError(
            f"both {what} generations are corrupt: {path} "
            f"({primary_error!r}) and {prev} ({e2!r}); {delete_hint}"
        ) from e2
    if os.path.exists(path):
        condemned = path + ".corrupt"
        n = 1
        while os.path.exists(condemned):
            condemned = f"{path}.corrupt.{n}"
            n += 1
        os.replace(path, condemned)
    os.replace(prev, path)
    if sink is not None:
        sink.emit("checkpoint_rollback_ok", path=path, iteration=counter)
    return payload, counter


def _fsync_file(path: str) -> None:
    with open(path, "rb+") as f:
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    dirfd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def _file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _manifest_checksum(body: dict) -> str:
    """SHA-256 of the manifest body without its ``checksum`` field, keys
    sorted: a bit flip that still parses as JSON must not pass."""
    canon = json.dumps({k: v for k, v in sorted(body.items()) if k != "checksum"},
                       sort_keys=True)
    return hashlib.sha256(canon.encode()).hexdigest()


def save_labels(checkpoint_dir: str, labels, iteration: int, tag: str = "lpa",
                fingerprint: str | None = None, sink=None) -> str:
    """Durably save (labels, iteration): tmp file, fsync, rotate the
    current generation to ``*.prev.npz``, rename the tmp into place, fsync
    the directory. A kill at any point leaves the old or the new
    checkpoint whole. ``labels`` is a tensor on any device or an array
    (int32); ``sink`` gets a ``checkpoint_save`` record, with the save's
    wall ``seconds``."""
    t0 = time.perf_counter()
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f"{tag}_labels.npz")
    tmp = path + ".tmp.npz"  # the .npz suffix keeps np.savez from renaming
    labels_np = _host_array(labels)
    np.savez(
        tmp, labels=labels_np, iteration=np.int64(iteration),
        fingerprint=np.str_(fingerprint or ""),
        checksum=np.str_(_state_checksum(labels_np, iteration, fingerprint or "")),
    )
    _fsync_file(tmp)
    if os.path.exists(path):
        os.replace(path, _prev_path(path))
    os.replace(tmp, path)
    _fsync_dir(checkpoint_dir)
    if sink is not None:
        sink.emit("checkpoint_save", path=path, iteration=int(iteration), format="npz",
                  shards=1, bytes=_tree_bytes(path), seconds=round(time.perf_counter() - t0, 6))
    return path


def _read_verified(path: str, fingerprint: str | None):
    """Load one generation, verifying integrity then identity: a
    corruption error (the caller may roll back) or
    :class:`FingerprintMismatch` (it must not)."""
    with np.load(path) as z:
        labels = z["labels"]
        iteration = int(z["iteration"])
        saved_fp = str(z["fingerprint"]) if "fingerprint" in z else ""
        if "checksum" in z:
            want = str(z["checksum"])
            got = _state_checksum(labels, iteration, saved_fp)
            if want != got:
                raise CheckpointCorruptionError(
                    f"checkpoint at {path} failed its state checksum "
                    f"({got[:12]}... != recorded {want[:12]}...)"
                )
        if fingerprint and saved_fp and fingerprint != saved_fp:
            raise FingerprintMismatch(
                f"checkpoint at {path} was written for a different graph or "
                f"vertex-id assignment (fingerprint {saved_fp[:12]}... != "
                f"{fingerprint[:12]}...); delete the checkpoint or reload the "
                "data the way the original run did (e.g. same batch_rows)"
            )
        return labels, iteration


def _read_verified_confirmed(path: str, fingerprint: str | None):
    """:func:`_read_verified` with one confirming re-read before a
    corruption verdict: transient I/O errors do not repeat, real damage
    does."""
    try:
        return _read_verified(path, fingerprint)
    except FingerprintMismatch:
        raise
    except _CORRUPTION_ERRORS as first:
        try:
            return _read_verified(path, fingerprint)
        except FingerprintMismatch:
            raise
        except _CORRUPTION_ERRORS:
            raise first


def load_labels(checkpoint_dir: str, tag: str = "lpa", fingerprint: str | None = None,
                sink=None):
    """``(labels int32 array, iteration)``, or None when no checkpoint
    exists. A corrupt current generation rolls back to ``*.prev.npz``
    (promoted to the current slot, the condemned file kept at
    ``*.npz.corrupt``; ``checkpoint_rollback`` records on ``sink``); both
    corrupt raise :class:`CheckpointCorruptionError`. A ``fingerprint``
    that differs from the recorded one raises
    :class:`FingerprintMismatch`."""
    path = os.path.join(checkpoint_dir, f"{tag}_labels.npz")
    return _load_with_rollback(
        path, _prev_path(path), lambda p: _read_verified_confirmed(p, fingerprint),
        sink, "checkpoint", f"delete {checkpoint_dir!r} to restart from scratch",
    )


# ---- shard-aware manifest checkpoints ----------------------------------------

MANIFEST_NAME = "manifest.json"
_MANIFEST_VERSION = 1


def sharded_dir(checkpoint_dir: str, tag: str = "lpa") -> str:
    """Current-generation directory of a sharded manifest checkpoint."""
    return os.path.join(checkpoint_dir, f"{tag}_sharded")


def shard_file(gen_dir: str, shard: int) -> str:
    return os.path.join(gen_dir, f"shard_{shard:05d}.npy")


def _sharded_prev_dir(gen_dir: str) -> str:
    return gen_dir + ".prev"


def save_sharded(checkpoint_dir: str, labels, iteration: int, tag: str = "lpa",
                 fingerprint: str | None = None, num_shards: int | None = None,
                 sink=None) -> str:
    """Durably save (labels, iteration) as a manifest of ``num_shards``
    per-shard files (default 1; the driver passes its mesh size): every
    shard and the manifest land in a tmp generation directory, each file
    fsync'd, the manifest last; the current generation rotates to
    ``*.prev`` and one directory rename publishes the new one, so a kill
    at any point leaves the old or the new generation whole. Stale tmp
    generations of killed saves are swept first. ``sink`` gets a
    ``checkpoint_save`` record. Returns the generation directory."""
    import glob
    import shutil

    t0 = time.perf_counter()
    labels_np = _host_array(labels)
    num_shards = 1 if num_shards is None else int(num_shards)
    if num_shards < 1:
        raise ValueError("num_shards must be >= 1")
    os.makedirs(checkpoint_dir, exist_ok=True)
    gen = sharded_dir(checkpoint_dir, tag)
    tmp = f"{gen}.tmp.{os.getpid()}"
    for stale in glob.glob(gen + ".tmp.*"):
        shutil.rmtree(stale, ignore_errors=True)
    os.makedirs(tmp)
    # even chunks, the last takes the remainder; the manifest records them
    v = len(labels_np)
    chunk = -(-v // num_shards) if v else 0
    sizes, shas = [], []
    for s in range(num_shards):
        part = labels_np[s * chunk: (s + 1) * chunk]
        path = shard_file(tmp, s)
        np.save(path, part)
        _fsync_file(path)
        sizes.append(int(len(part)))
        shas.append(_file_sha256(path))
    body = {
        "version": _MANIFEST_VERSION, "tag": tag, "iteration": int(iteration),
        "fingerprint": fingerprint or "", "num_shards": int(num_shards),
        "mesh_shape": [int(num_shards)], "num_vertices": int(v),
        "dtype": str(labels_np.dtype), "shard_sizes": sizes, "shard_sha256": shas,
    }
    body["checksum"] = _manifest_checksum(body)
    man_tmp = os.path.join(tmp, MANIFEST_NAME + ".tmp")
    with open(man_tmp, "w") as f:
        json.dump(body, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(man_tmp, os.path.join(tmp, MANIFEST_NAME))
    _fsync_dir(tmp)
    prev = _sharded_prev_dir(gen)
    if os.path.exists(gen):
        if os.path.exists(prev):
            shutil.rmtree(prev)
        os.replace(gen, prev)
    os.replace(tmp, gen)
    _fsync_dir(checkpoint_dir)
    if sink is not None:
        sink.emit("checkpoint_save", path=gen, iteration=int(iteration), format="sharded",
                  shards=int(num_shards), bytes=_tree_bytes(gen),
                  seconds=round(time.perf_counter() - t0, 6))
    return gen


def _read_sharded_verified(gen_dir: str, fingerprint: str | None):
    """Load one sharded generation, verifying the manifest checksum, every
    shard's sha256 and size and the assembled length, then the graph
    fingerprint."""
    man_path = os.path.join(gen_dir, MANIFEST_NAME)
    try:
        with open(man_path) as f:
            body = json.load(f)
    except json.JSONDecodeError as e:
        raise CheckpointCorruptionError(f"manifest at {man_path} is not valid JSON ({e})") from e
    want = body.get("checksum", "")
    got = _manifest_checksum(body)
    if want != got:
        raise CheckpointCorruptionError(
            f"manifest at {man_path} failed its checksum ({got[:12]}... != recorded "
            f"{want[:12]}...)")
    saved_fp = body.get("fingerprint", "")
    if fingerprint and saved_fp and fingerprint != saved_fp:
        raise FingerprintMismatch(
            f"sharded checkpoint at {gen_dir} was written for a different graph or "
            f"vertex-id assignment (fingerprint {saved_fp[:12]}... != {fingerprint[:12]}...); "
            "delete the checkpoint or reload the data the way the original run did")
    parts = []
    for s in range(body["num_shards"]):
        path = shard_file(gen_dir, s)
        sha = _file_sha256(path)
        if sha != body["shard_sha256"][s]:
            raise CheckpointCorruptionError(
                f"shard {s} at {path} failed its sha256 ({sha[:12]}... != manifest "
                f"{body['shard_sha256'][s][:12]}...)")
        part = np.load(path)
        if len(part) != body["shard_sizes"][s]:
            raise CheckpointCorruptionError(
                f"shard {s} at {path} holds {len(part)} rows, manifest says "
                f"{body['shard_sizes'][s]}")
        parts.append(part)
    labels = np.concatenate(parts) if parts else np.empty(0, np.dtype(body["dtype"]))
    if len(labels) != body["num_vertices"]:
        raise CheckpointCorruptionError(
            f"sharded checkpoint at {gen_dir} assembles to {len(labels)} vertices, "
            f"manifest says {body['num_vertices']}")
    return labels.astype(np.dtype(body["dtype"]), copy=False), int(body["iteration"])


def _read_sharded_confirmed(gen_dir: str, fingerprint: str | None):
    """:func:`_read_sharded_verified` with one confirming re-read before a
    corruption verdict."""
    try:
        return _read_sharded_verified(gen_dir, fingerprint)
    except FingerprintMismatch:
        raise
    except _CORRUPTION_ERRORS as first:
        try:
            return _read_sharded_verified(gen_dir, fingerprint)
        except FingerprintMismatch:
            raise
        except _CORRUPTION_ERRORS:
            raise first


def load_sharded(checkpoint_dir: str, tag: str = "lpa", fingerprint: str | None = None,
                 sink=None):
    """``(labels int32 array [V], iteration)`` of the sharded generation,
    or None when none exists, whatever shard count wrote it. A corrupt
    current generation rolls back to ``*.prev`` (the condemned directory
    kept at ``*.corrupt``, ``checkpoint_rollback`` records on ``sink``); a
    wrong ``fingerprint`` raises :class:`FingerprintMismatch` without
    rollback. The JAX package's removed orbax format raises
    :class:`CheckpointCorruptionError`, as there."""
    gen = sharded_dir(checkpoint_dir, tag)
    if not os.path.exists(gen) and not os.path.exists(_sharded_prev_dir(gen)):
        legacy = os.path.join(checkpoint_dir, f"{tag}_orbax")
        if os.path.isdir(legacy):
            raise CheckpointCorruptionError(
                f"checkpoint at {legacy} uses the removed orbax format; only the "
                "sharded-manifest and npz formats are read")
        return None
    return _load_with_rollback(
        gen, _sharded_prev_dir(gen), lambda p: _read_sharded_confirmed(p, fingerprint),
        sink, "sharded checkpoint", f"delete {gen!r} (and its .prev) to restart from scratch",
    )


def _peek_sharded_iteration(checkpoint_dir: str, tag: str):
    """The current sharded generation's iteration from its manifest alone
    (no shard hashing); None when unreadable or absent."""
    try:
        with open(os.path.join(sharded_dir(checkpoint_dir, tag), MANIFEST_NAME)) as f:
            return int(json.load(f)["iteration"])
    except Exception:
        return None


def _peek_npz_iteration(checkpoint_dir: str, tag: str):
    """The current npz generation's iteration from one member; None when
    unreadable or absent."""
    try:
        with np.load(os.path.join(checkpoint_dir, f"{tag}_labels.npz")) as z:
            return int(z["iteration"])
    except Exception:
        return None


def load_newest(checkpoint_dir: str, tag: str = "lpa", fingerprint: str | None = None,
                sink=None):
    """The newest recoverable ``(labels, iteration)`` across both formats
    (the sharded manifest of multi-device runs and the npz of one-device
    runs; a run that walked its elastic rungs down to one device leaves
    both), or None. Iterations are peeked first and a format provably no
    newer than one already loaded is skipped. One format corrupt beyond
    its own rollback does not veto the other: its
    :class:`CheckpointCorruptionError` is raised only when nothing loads;
    :class:`FingerprintMismatch` always propagates."""
    entries = [
        (_peek_sharded_iteration(checkpoint_dir, tag), load_sharded),
        (_peek_npz_iteration(checkpoint_dir, tag), load_labels),
    ]
    entries.sort(key=lambda t: float("-inf") if t[0] is None else t[0], reverse=True)
    found, errors = [], []
    for peek, loader in entries:
        if found and peek is not None and peek <= found[-1][1]:
            break
        try:
            out = loader(checkpoint_dir, tag=tag, fingerprint=fingerprint, sink=sink)
        except FingerprintMismatch:
            raise
        except CheckpointCorruptionError as e:
            errors.append(e)
            continue
        if out is not None:
            found.append(out)
    if found:
        return max(found, key=lambda t: t[1])
    if errors:
        raise errors[0]
    return None
