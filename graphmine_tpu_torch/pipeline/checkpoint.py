"""Checkpoint / resume of the LPA labels, and the durable formats' helpers.

Counterpart of ``graphmine_tpu/pipeline/checkpoint.py`` on one device:

- :func:`save_labels` / :func:`load_labels`: one atomic npz of the labels
  and the iteration, with the graph fingerprint and a state checksum, two
  rotated generations and rollback to the older one on corruption. The
  npz is the JAX package's format, byte for byte in its fields, so each
  package resumes from the other's checkpoint;
- :func:`load_newest`: the resume entry point. The JAX package's sharded
  manifest format (multi-device runs) is not read here: a sharded
  generation in the directory is reported in a ``warning`` record and
  passed over;
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


def _foreign_generations(checkpoint_dir: str, tag: str) -> list:
    """Generations of the JAX package's multi-device formats (the sharded
    manifest and the legacy orbax directory) present in the directory."""
    names = (f"{tag}_sharded", f"{tag}_sharded.prev", f"{tag}_orbax")
    return [os.path.join(checkpoint_dir, n) for n in names
            if os.path.exists(os.path.join(checkpoint_dir, n))]


def load_newest(checkpoint_dir: str, tag: str = "lpa", fingerprint: str | None = None,
                sink=None):
    """The newest recoverable ``(labels, iteration)`` in ``checkpoint_dir``
    for a one-device resume, or None. The npz generations load through
    :func:`load_labels`. A sharded generation (written by a multi-device
    run of the JAX package) cannot be read here: it is named in a
    ``warning`` record on ``sink`` and passed over, never raised on."""
    foreign = _foreign_generations(checkpoint_dir, tag)
    if foreign and sink is not None:
        sink.emit("warning", message=(
            f"checkpoint generations {foreign} are in a multi-device format "
            "this one-device resume does not read; resuming from the npz "
            "generations only"))
    return load_labels(checkpoint_dir, tag=tag, fingerprint=fingerprint, sink=sink)
