"""Integrity helpers of the durable formats (host side).

Counterpart of the parts of ``graphmine_tpu/pipeline/checkpoint.py`` that
the snapshot store (:mod:`graphmine_tpu_torch.serve.snapshot`) uses: the
graph fingerprint, file and manifest hashes, fsync helpers and the
two-generation rollback state machine. Each computes what its original
computes, so a store written by either package verifies in the other.
Label checkpoints and resume wait for a later slice (ROADMAP.md).
"""

from __future__ import annotations

import hashlib
import json
import os
import zipfile
import zlib

import numpy as np


class CheckpointCorruptionError(RuntimeError):
    """A generation failed its integrity check and no good fallback
    existed. The message names every file tried."""


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
