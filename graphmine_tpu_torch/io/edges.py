"""Edge-table ingestion from whitespace edge lists (host side).

Counterpart of ``graphmine_tpu/io/edges.py`` for edge lists:
``EdgeTable`` (with optional weights and quarantine counts),
``edge_table_from_parts``, ``quarantine_nonfinite_weights``,
``from_arrays`` and ``load_edge_list``. By default the streaming C++ parser
(:mod:`graphmine_tpu_torch.io.native`) reads the file; ``use_native=False``
takes the NumPy paths (bulk, and chunked above 256 MB). Each path assigns
the ids its JAX counterpart assigns on the same file: the native parser
line by line, the NumPy paths column by column. Parquet waits for a later
slice (ROADMAP.md).
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
    weights: np.ndarray | None = None  # float32 [E], optional edge weights
    # Rows set aside instead of failing the load (keys bad_rows,
    # nan_weights); None when the loader kept no such count.
    quarantine: dict | None = None

    @property
    def num_vertices(self) -> int:
        return len(self.names)

    @property
    def num_edges(self) -> int:
        return len(self.src)


def _add_quarantine(et: EdgeTable, key: str, count: int) -> EdgeTable:
    """Add ``count`` to the table's ``key`` counter (0 is recorded too)."""
    et.quarantine = {**(et.quarantine or {}), key: count + (et.quarantine or {}).get(key, 0)}
    return et


def quarantine_nonfinite_weights(et: EdgeTable) -> EdgeTable:
    """Drop edges whose weight is NaN or infinite, counting them as
    ``nan_weights`` (a NaN sum would defeat weighted LPA's argmax). No-op
    on unweighted tables."""
    if et.weights is None:
        return et
    bad = ~np.isfinite(et.weights)
    n = int(bad.sum())
    if n:
        keep = ~bad
        et.src, et.dst = et.src[keep], et.dst[keep]
        et.weights = et.weights[keep]
    return _add_quarantine(et, "nan_weights", n)


def edge_table_from_parts(src_parts, dst_parts, names, num_rows_raw,
                          w_parts=None) -> EdgeTable:
    """Assemble an EdgeTable from per-chunk part lists (weights ``None``
    when ``w_parts`` is)."""
    cat = lambda parts, dt: np.concatenate(parts) if parts else np.empty(0, dt)
    return EdgeTable(
        src=cat(src_parts, np.int32), dst=cat(dst_parts, np.int32),
        names=np.asarray(names), num_rows_raw=num_rows_raw,
        weights=None if w_parts is None else cat(w_parts, np.float32),
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


# Above this file size the NumPy path streams in bounded chunks instead of
# materializing every row as Python strings at once. The native path
# always streams.
_AUTO_STREAM_BYTES = 256 << 20
_DEFAULT_CHUNK_BYTES = 64 << 20


def load_edge_list(path: str, comments: str = "#", use_native: bool = True,
                   weight_col: int | None = None, chunk_bytes: int | None = None,
                   quarantine: bool = False) -> EdgeTable:
    """Load a SNAP-style whitespace edge list (``src dst [weight ...]``).

    Ids may be arbitrary integers or strings; they are densified to int32
    in first-appearance order. ``weight_col``: 0-based column of a float
    edge weight (>= 2). ``chunk_bytes``: the streaming chunk size (64 MB).

    ``quarantine``: rows that fail the strict parse (too few columns, an
    unparseable weight) are counted as ``bad_rows`` and set aside by a
    tolerant per-line parser, and edges with non-finite weights as
    ``nan_weights``, on ``EdgeTable.quarantine``. A clean file takes the
    strict path; a file whose every row fails raises.
    """
    if weight_col is not None and weight_col < 2:
        raise ValueError(f"weight_col={weight_col} invalid: columns 0-1 are the endpoints")
    if quarantine:
        try:
            et = load_edge_list(path, comments=comments, use_native=use_native,
                                weight_col=weight_col, chunk_bytes=chunk_bytes)
            _add_quarantine(et, "bad_rows", 0)
        except ValueError as strict_err:
            et = _load_edge_list_tolerant(path, comments, weight_col,
                                          chunk_bytes or _DEFAULT_CHUNK_BYTES)
            if et.num_rows_raw and et.quarantine.get("bad_rows") == et.num_rows_raw:
                raise ValueError(
                    f"every data row of {path!r} failed to parse under "
                    "the current options — this is a misconfiguration "
                    "(e.g. wrong weight_col), not dirty data"
                ) from strict_err
        return quarantine_nonfinite_weights(et)
    if use_native:
        from graphmine_tpu_torch.io import native

        return native.load_edge_list_chunked(path, comments=comments, weight_col=weight_col,
                                             chunk_bytes=chunk_bytes or _DEFAULT_CHUNK_BYTES)
    big = os.path.exists(path) and os.path.getsize(path) > _AUTO_STREAM_BYTES
    if chunk_bytes is not None or big:
        return _load_edge_list_numpy_chunked(path, comments, weight_col,
                                             chunk_bytes or _DEFAULT_CHUNK_BYTES)
    raw = np.loadtxt(path, comments=comments, dtype=str, ndmin=2)
    if len(raw) == 0:
        return edge_table_from_parts([], [], np.empty(0, dtype=object), 0,
                                     [] if weight_col is not None else None)
    if raw.shape[1] < 2:
        raise ValueError(f"edge list {path!r} needs >= 2 columns")
    weights = None
    if weight_col is not None:
        if weight_col >= raw.shape[1]:
            raise ValueError(
                f"weight_col={weight_col} out of range for a "
                f"{raw.shape[1]}-column edge list (and columns 0-1 are the "
                "endpoints)"
            )
        weights = raw[:, weight_col].astype(np.float32)
    (src, dst), names = factorize(raw[:, 0], raw[:, 1])
    return EdgeTable(src=src, dst=dst, names=names, num_rows_raw=len(raw), weights=weights)


def _load_edge_list_numpy_chunked(path: str, comments: str, weight_col: int | None,
                                  chunk_bytes: int) -> EdgeTable:
    """NumPy streaming path: newline-aligned chunks through one incremental
    interner, each chunk's columns interned source first."""
    interner = IncrementalFactorizer()
    src_parts, dst_parts, w_parts = [], [], []
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
        if weight_col is not None:
            if weight_col >= raw.shape[1]:
                raise ValueError(
                    f"weight_col={weight_col} out of range for "
                    f"a {raw.shape[1]}-column edge list"
                )
            w_parts.append(raw[:, weight_col].astype(np.float32))
    return edge_table_from_parts(src_parts, dst_parts, interner.names(), num_rows,
                                 w_parts if weight_col is not None else None)


def _load_edge_list_tolerant(path: str, comments: str, weight_col: int | None,
                             chunk_bytes: int = _DEFAULT_CHUNK_BYTES) -> EdgeTable:
    """Per-line parser that counts malformed rows as ``bad_rows`` and sets
    them aside; reached only after a strict parse failed. Each chunk's
    well-formed rows are interned column by column, source first."""
    interner = IncrementalFactorizer()
    cmt = comments.encode() if comments else None
    need = 2 if weight_col is None else weight_col + 1
    src_parts, dst_parts, w_parts = [], [], []
    num_rows = 0
    bad_rows = 0
    for buf in iter_line_chunks(path, chunk_bytes):
        src_l, dst_l, w_l = [], [], []
        for line in buf.splitlines():
            line = line.strip()
            if not line or (cmt and line.startswith(cmt)):
                continue
            num_rows += 1
            parts = line.split()
            if len(parts) < need:
                bad_rows += 1
                continue
            if weight_col is not None:
                try:
                    w_l.append(float(parts[weight_col]))
                except ValueError:
                    bad_rows += 1
                    continue
            # backslashreplace keeps distinct invalid byte sequences
            # distinct vertex ids
            src_l.append(parts[0].decode("utf-8", "backslashreplace"))
            dst_l.append(parts[1].decode("utf-8", "backslashreplace"))
        if src_l:
            src_parts.append(interner.add(np.asarray(src_l, dtype=object)))
            dst_parts.append(interner.add(np.asarray(dst_l, dtype=object)))
            if weight_col is not None:
                w_parts.append(np.asarray(w_l, dtype=np.float32))
    et = edge_table_from_parts(src_parts, dst_parts, interner.names(), num_rows,
                               w_parts if weight_col is not None else None)
    return _add_quarantine(et, "bad_rows", bad_rows)


def from_arrays(src, dst, names=None) -> EdgeTable:
    """Build an EdgeTable from pre-densified integer endpoint arrays."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1 if len(src) else 0
    if names is None:
        names = np.array([str(i) for i in range(n)])
    return EdgeTable(src=src, dst=dst, names=np.asarray(names), num_rows_raw=len(src))
