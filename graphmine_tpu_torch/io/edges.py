"""Edge-table ingestion from whitespace edge lists (host-side NumPy).

Counterpart of ``graphmine_tpu/io/edges.py`` for the NumPy edge-list
paths: ``EdgeTable``, ``from_arrays`` and ``load_edge_list`` (bulk, and
chunked above 256 MB). Ids come out exactly as the JAX package assigns
them on the same file. Parquet and the native C++ parser wait for a later
slice (ROADMAP.md, queue 1 item 2).
"""

from __future__ import annotations

import io as _io
import os
from dataclasses import dataclass

import numpy as np

from graphmine_tpu_torch.io.factorize import IncrementalFactorizer, factorize


@dataclass
class EdgeTable:
    """Host-side edge table: dense int32 endpoints + vertex-name sidecar.
    Duplicate edges are kept: LPA counts them with multiplicity."""

    src: np.ndarray  # int32 [E]
    dst: np.ndarray  # int32 [E]
    names: np.ndarray  # [V] vertex id -> name
    num_rows_raw: int = 0

    @property
    def num_vertices(self) -> int:
        return len(self.names)

    @property
    def num_edges(self) -> int:
        return len(self.src)


def _edge_table_from_parts(src_parts, dst_parts, names, num_rows_raw) -> EdgeTable:
    cat = lambda parts: np.concatenate(parts) if parts else np.empty(0, np.int32)
    return EdgeTable(
        src=cat(src_parts), dst=cat(dst_parts), names=np.asarray(names),
        num_rows_raw=num_rows_raw,
    )


def iter_line_chunks(path: str, chunk_bytes: int):
    """Yield newline-aligned byte buffers of ~``chunk_bytes`` covering the
    file; the trailing newline-less line (if any) is yielded last."""
    with open(path, "rb") as f:
        carry = b""
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if carry:
                    yield carry
                return
            buf = carry + block
            nl = buf.rfind(b"\n")
            if nl < 0:
                carry = buf
                if len(carry) > (1 << 30):
                    raise ValueError(
                        f"no newline in the first GiB of {path!r}; "
                        "not a line-oriented edge list"
                    )
                continue
            carry = buf[nl + 1:]
            yield buf[:nl + 1]


# Above this file size the loader streams in bounded chunks instead of
# materializing every row as Python strings at once.
_AUTO_STREAM_BYTES = 256 << 20
_DEFAULT_CHUNK_BYTES = 64 << 20


def load_edge_list(path: str, comments: str = "#",
                   chunk_bytes: int | None = None) -> EdgeTable:
    """Load a SNAP-style whitespace edge list (``src dst [ignored ...]``).

    Ids may be arbitrary integers or strings; they are densified to int32
    in first-appearance order. Files above 256 MB (or any file when
    ``chunk_bytes`` is given) stream through one incremental interner, so
    peak host memory is O(chunk + vocabulary + edges).
    """
    big = os.path.exists(path) and os.path.getsize(path) > _AUTO_STREAM_BYTES
    if chunk_bytes is not None or big:
        return _load_edge_list_chunked(path, comments, chunk_bytes or _DEFAULT_CHUNK_BYTES)
    raw = np.loadtxt(path, comments=comments, dtype=str, ndmin=2)
    if len(raw) == 0:
        return _edge_table_from_parts([], [], np.empty(0, dtype=object), 0)
    if raw.shape[1] < 2:
        raise ValueError(f"edge list {path!r} needs >= 2 columns")
    (src, dst), names = factorize(raw[:, 0], raw[:, 1])
    return EdgeTable(src=src, dst=dst, names=names, num_rows_raw=len(raw))


def _load_edge_list_chunked(path: str, comments: str, chunk_bytes: int) -> EdgeTable:
    interner = IncrementalFactorizer()
    src_parts, dst_parts = [], []
    num_rows = 0
    ncols = None
    for buf in iter_line_chunks(path, chunk_bytes):
        if not buf.strip():
            continue
        raw = np.loadtxt(_io.BytesIO(buf), comments=comments, dtype=str, ndmin=2)
        if not raw.size:
            continue
        if raw.shape[1] < 2:
            raise ValueError(f"edge list {path!r} needs >= 2 columns")
        # loadtxt checks rectangularity only within a chunk
        if ncols is None:
            ncols = raw.shape[1]
        elif raw.shape[1] != ncols:
            raise ValueError(
                f"edge list {path!r}: number of columns changed between data lines"
            )
        num_rows += len(raw)
        src_parts.append(interner.add(raw[:, 0]))
        dst_parts.append(interner.add(raw[:, 1]))
    return _edge_table_from_parts(src_parts, dst_parts, interner.names(), num_rows)


def from_arrays(src, dst, names=None) -> EdgeTable:
    """Build an EdgeTable from pre-densified integer endpoint arrays."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1 if len(src) else 0
    if names is None:
        names = np.array([str(i) for i in range(n)])
    return EdgeTable(src=src, dst=dst, names=np.asarray(names), num_rows_raw=len(src))
