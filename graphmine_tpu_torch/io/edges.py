"""Edge-table ingestion from parquet and whitespace edge lists (host side).

Counterpart of ``graphmine_tpu/io/edges.py``: ``EdgeTable`` (with
optional weights and quarantine counts), ``edge_table_from_parts``,
``quarantine_nonfinite_weights``, ``from_arrays``, ``load_parquet_edges``
and ``load_edge_list``. Edge lists: by default the streaming C++ parser
(:mod:`graphmine_tpu_torch.io.native`) reads the file; ``use_native=False``
takes the NumPy paths (bulk, and chunked above 256 MB). Each path assigns
the ids its JAX counterpart assigns on the same file: the native parser
line by line, the NumPy paths column by column, and parquet column by
column over the dictionary values (per batch with ``batch_rows``).
"""

from __future__ import annotations

import glob as _glob
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
    # Rows set aside instead of failing the load (keys null_rows,
    # bad_rows, nan_weights); None when the loader kept no such count.
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


def _isnull(col: np.ndarray) -> np.ndarray:
    """``None`` cells of an object column (other dtypes hold no nulls)."""
    if col.dtype == object:
        return np.frompyfunc(lambda v: v is None, 1, 1)(col).astype(bool)
    return np.zeros(len(col), dtype=bool)


def _from_string_columns(parent_dom: np.ndarray, child_dom: np.ndarray,
                         num_rows_raw: int) -> EdgeTable:
    """An :class:`EdgeTable` of two host columns (``Table.to_edge_table``):
    rows with a null endpoint dropped, the rest factorized over the union
    of both columns in first-appearance order, source column first (the
    JAX package's ids)."""
    valid = ~(_isnull(parent_dom) | _isnull(child_dom))
    parent_dom, child_dom = parent_dom[valid], child_dom[valid]
    (src, dst), names = factorize(parent_dom, child_dom)
    return EdgeTable(src=src, dst=dst, names=names, num_rows_raw=num_rows_raw)


def _column_codes(col, interner: IncrementalFactorizer) -> np.ndarray:
    """Intern one Arrow column (Array or ChunkedArray) into int32 codes,
    through the dictionary indices where the column is dictionary-encoded
    (the same ids as the per-row strings, without building one Python
    string per row). Nulls are dropped here too, so none is ever interned
    as a vertex; callers that pair columns filter null rows first."""
    import pyarrow as pa

    chunks = col.chunks if isinstance(col, pa.ChunkedArray) else [col]
    parts = []
    for c in chunks:
        if c.null_count:
            c = c.drop_null()
        if pa.types.is_dictionary(c.type):
            parts.append(interner.add_dictionary(np.asarray(c.indices),
                                                 c.dictionary.to_numpy(zero_copy_only=False)))
        else:
            parts.append(interner.add(c.to_numpy(zero_copy_only=False)))
    if not parts:
        return np.empty(0, np.int32)
    return (np.concatenate(parts) if len(parts) != 1 else parts[0]).astype(np.int32, copy=False)


def load_parquet_edges(path: str, batch_rows: int | None = None) -> EdgeTable:
    """Read a parquet file, directory or glob of outlinks: edges are
    (``_c1`` -> ``_c2``) string columns, duplicates kept, rows with a null
    endpoint set aside and counted as ``null_rows``. Columns are read
    dictionary-encoded and interned through their indices, source column
    first, so ids follow first appearance over the dictionary values.

    ``batch_rows``: stream the files in batches of at most this many rows
    through one incremental interner (host memory O(batch + vocabulary +
    edges)); ids then come batch by batch, source column first in each.
    """
    if batch_rows is not None:
        return _load_parquet_edges_streaming(path, batch_rows)
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    tables = [pq.read_table(p, columns=["_c1", "_c2"], read_dictionary=["_c1", "_c2"])
              for p in _resolve_paths(path)]
    try:
        table = pa.concat_tables(tables, promote_options="permissive")
    except TypeError:
        # pyarrow < 14 has no promote_options; promote=True is its
        # permissive schema unification
        table = pa.concat_tables(tables, promote=True)
    num_rows_raw = table.num_rows
    valid = pc.and_(pc.is_valid(table.column("_c1")), pc.is_valid(table.column("_c2")))
    table = table.filter(valid)
    interner = IncrementalFactorizer()
    src = _column_codes(table.column("_c1"), interner)
    dst = _column_codes(table.column("_c2"), interner)
    et = EdgeTable(src=src, dst=dst, names=interner.names(), num_rows_raw=num_rows_raw)
    return _add_quarantine(et, "null_rows", num_rows_raw - table.num_rows)


def _load_parquet_edges_streaming(path: str, batch_rows: int) -> EdgeTable:
    """Batched parquet scan through one incremental interner."""
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    if batch_rows <= 0:
        raise ValueError(f"batch_rows must be positive, got {batch_rows}")
    interner = IncrementalFactorizer()
    src_parts, dst_parts = [], []
    num_rows_raw = 0
    for p in _resolve_paths(path):
        pf = pq.ParquetFile(p, read_dictionary=["_c1", "_c2"])
        for batch in pf.iter_batches(batch_size=batch_rows, columns=["_c1", "_c2"]):
            num_rows_raw += batch.num_rows
            valid = pc.and_(pc.is_valid(batch.column(0)), pc.is_valid(batch.column(1)))
            batch = batch.filter(valid)
            src_parts.append(_column_codes(batch.column(0), interner))
            dst_parts.append(_column_codes(batch.column(1), interner))
    et = edge_table_from_parts(src_parts, dst_parts, interner.names(), num_rows_raw)
    return _add_quarantine(et, "null_rows", num_rows_raw - et.num_edges)


def _resolve_paths(path: str) -> list[str]:
    """The parquet files of a directory (``*.parquet``, sorted), of a glob,
    or the path itself."""
    if os.path.isdir(path):
        paths = sorted(_glob.glob(os.path.join(path, "*.parquet")))
    else:
        paths = sorted(_glob.glob(path)) or [path]
    if not paths:
        raise FileNotFoundError(f"no parquet files at {path!r}")
    return paths


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
