"""pyspark / graphframes compatibility shim — run the reference script verbatim.

The port's own copy of ``graphmine_tpu/compat.py``, over the PyTorch
engine. The reference (``CommunityDetection/Graphframes.py``) drives
everything through pyspark and GraphFrames call sites. This module fakes
exactly that surface — ``pyspark``, ``pyspark.sql``,
``pyspark.sql.functions``, ``graphframes`` — so the *unmodified* script
executes here: parquet read (``Graphframes.py:16``), DataFrame preprocessing
(``:26-32``), the RDD vertex-dictionary idiom (``:53, :67``), per-row UDFs
(``:61, :71-72``), ``GraphFrame(v, e)`` + ``labelPropagation`` (``:78-81``),
and the driver-side census loops (``:100-120``).

Design stance: this is the **plugin boundary**, not the engine. DataFrame ops
delegate to :class:`graphmine_tpu_torch.table.Table` (vectorized NumPy);
graph algorithms run on the device through
:class:`graphmine_tpu_torch.frames.GraphFrame`, on CUDA unless
``install(device=...)`` or ``--device`` names another device. Only the RDD lambda surface runs
per-element Python — it exists to honor the reference's own driver-side
idioms, and `collect()` results are cached per DataFrame so the reference's
re-collect-per-iteration loops (``:102, :110``) don't repay row construction.

Usage::

    python -m graphmine_tpu_torch.compat [--device cuda|cpu] /path/to/Graphframes.py
    # or programmatically:
    from graphmine_tpu_torch import compat
    compat.install()          # registers the fake modules in sys.modules
    import pyspark            # -> the shim

``install()`` refuses to shadow a real pyspark installation, or the JAX
package's shim, unless ``force=True``.
"""

from __future__ import annotations

import os
import runpy
import sys
import types
from typing import Sequence

import numpy as np

from graphmine_tpu_torch import frames as _frames
from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.table import Table, _isnull

# The device the shim's GraphFrames run on, set by install(); None = CUDA.
_DEVICE = None

__all__ = [
    "Column", "DataFrame", "GraphFrame", "RDD", "Row", "SQLContext",
    "SparkConf", "SparkContext", "SparkSession", "asc", "col", "collect_list",
    "collect_set", "column", "count", "countDistinct", "desc", "first",
    "install", "lit", "main", "mean", "monotonically_increasing_id", "udf",
    "when",
]


# ---------------------------------------------------------------------------
# Row — Spark's tuple-with-field-names (subscript by index or column name)
# ---------------------------------------------------------------------------


class Row(tuple):
    """Spark ``Row``: a tuple whose elements are also reachable by field
    name via ``row['col']`` / ``row.col`` (``Graphframes.py:103, :111``).

    Constructor matches pyspark: ``Row(id='a', n=1)`` (named fields, order
    preserved) or ``Row('a', 1)`` (positional, no field names)."""

    def __new__(cls, *args, **kwargs):
        if args and kwargs:
            raise ValueError("cannot mix positional and named Row arguments")
        r = tuple.__new__(cls, kwargs.values() if kwargs else args)
        r._fields_ = tuple(kwargs) if kwargs else None
        return r

    @classmethod
    def _make(cls, values, fields: Sequence[str]) -> "Row":
        r = tuple.__new__(cls, values)
        r._fields_ = tuple(fields)
        return r

    def __getitem__(self, key):
        if isinstance(key, str):
            if self._fields_ is None:
                raise KeyError(f"Row has no named fields: {key!r}")
            return tuple.__getitem__(self, self._fields_.index(key))
        return tuple.__getitem__(self, key)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return tuple.__getitem__(self, (self._fields_ or ()).index(name))
        except ValueError:
            raise AttributeError(name) from None

    def asDict(self) -> dict:
        if self._fields_ is None:
            raise TypeError("Row has no named fields")
        return dict(zip(self._fields_, self))

    def __repr__(self) -> str:
        if self._fields_ is None:
            return "Row(" + ", ".join(repr(v) for v in self) + ")"
        return "Row(" + ", ".join(
            f"{k}={v!r}" for k, v in zip(self._fields_, self)
        ) + ")"


# ---------------------------------------------------------------------------
# Column expressions — pyspark.sql.Column / functions surface
# ---------------------------------------------------------------------------


class Column:
    """Lazy column expression: evaluated against a :class:`Table` at use
    time (``df.filter(F.col("age") > 30)``, ``df.withColumn("y", ...)``).

    Comparisons follow SQL three-valued logic collapsed to ``False`` for
    null operands (matching ``Table.filter``'s predicate strings)."""

    def __init__(self, eval_fn, name: str = "col"):
        self._eval = eval_fn
        self._name = name

    # construction helpers --------------------------------------------------

    @staticmethod
    def _coerce(other) -> "Column":
        if isinstance(other, Column):
            return other
        return lit(other)

    def _binop(self, other, fn, name) -> "Column":
        other = Column._coerce(other)
        return Column(
            lambda t: fn(_numeric_view(self._eval(t)), _numeric_view(other._eval(t))),
            f"({self._name} {name} {other._name})",
        )

    def _cmp(self, other, op) -> "Column":
        from graphmine_tpu_torch.table import _compare

        other = Column._coerce(other)
        return Column(
            lambda t: _compare(_as_arr(self._eval(t)), op, _as_arr(other._eval(t))),
            f"({self._name} {op} {other._name})",
        )

    # comparisons (SQL null semantics) --------------------------------------

    def __eq__(self, other):  # noqa: D105
        return self._cmp(other, "=")

    def __ne__(self, other):  # noqa: D105
        return self._cmp(other, "!=")

    def __lt__(self, other):
        return self._cmp(other, "<")

    def __le__(self, other):
        return self._cmp(other, "<=")

    def __gt__(self, other):
        return self._cmp(other, ">")

    def __ge__(self, other):
        return self._cmp(other, ">=")

    __hash__ = None  # mirrors pyspark: Column is unhashable

    # boolean algebra over masks --------------------------------------------

    def __and__(self, other):
        return self._binop(other, lambda a, b: _as_bool(a) & _as_bool(b), "AND")

    def __or__(self, other):
        return self._binop(other, lambda a, b: _as_bool(a) | _as_bool(b), "OR")

    def __invert__(self):
        return Column(lambda t: ~_as_bool(self._eval(t)), f"(NOT {self._name})")

    # arithmetic -------------------------------------------------------------

    def __add__(self, other):
        return self._binop(other, lambda a, b: a + b, "+")

    def __radd__(self, other):
        return Column._coerce(other).__add__(self)

    def __sub__(self, other):
        return self._binop(other, lambda a, b: a - b, "-")

    def __rsub__(self, other):
        return Column._coerce(other).__sub__(self)

    def __mul__(self, other):
        return self._binop(other, lambda a, b: a * b, "*")

    def __rmul__(self, other):
        return Column._coerce(other).__mul__(self)

    def __truediv__(self, other):
        return self._binop(other, lambda a, b: a / b, "/")

    def __neg__(self):
        return Column(lambda t: -self._eval(t), f"(- {self._name})")

    # pyspark Column methods -------------------------------------------------

    def isNull(self) -> "Column":
        return Column(lambda t: _isnull(_as_arr(self._eval(t))),
                      f"({self._name} IS NULL)")

    def isNotNull(self) -> "Column":
        return Column(lambda t: ~_isnull(_as_arr(self._eval(t))),
                      f"({self._name} IS NOT NULL)")

    def isin(self, *values) -> "Column":
        vals = list(values[0]) if len(values) == 1 and isinstance(
            values[0], (list, tuple, set)) else list(values)

        def ev(t):
            a = _as_arr(self._eval(t))
            try:
                arr = np.asarray(vals, dtype=object if a.dtype == object
                                 else a.dtype)
                m = np.isin(a, arr)
            except (ValueError, TypeError):  # incomparable types: SQL false
                sv = set(vals)
                m = np.frompyfunc(lambda x: x in sv, 1, 1)(a).astype(bool)
            return m & ~_isnull(a)

        return Column(ev, f"({self._name} IN ...)")

    def like(self, pattern: str) -> "Column":
        from graphmine_tpu_torch.table import _like

        return Column(lambda t: _like(_as_arr(self._eval(t)), pattern),
                      f"({self._name} LIKE {pattern!r})")

    def contains(self, sub: str) -> "Column":
        return self.like(f"%{sub}%")

    def startswith(self, prefix: str) -> "Column":
        return self.like(f"{prefix}%")

    def endswith(self, suffix: str) -> "Column":
        return self.like(f"%{suffix}")

    def alias(self, name: str) -> "Column":
        c = Column(self._eval, name)
        return c

    def cast(self, dtype) -> "Column":
        np_t = {"int": np.int64, "long": np.int64, "bigint": np.int64,
                "float": np.float32, "double": np.float64,
                "string": object}.get(dtype, dtype)

        def ev(t):
            a = _as_arr(self._eval(t))
            null = _isnull(a)
            if np_t is object:  # nulls stay null, never the string 'nan'/'None'
                out = np.frompyfunc(lambda v: str(v), 1, 1)(a).astype(object)
                out[null] = None
                return out
            base = np.where(null, 0, a).astype(np_t)
            if not null.any():
                return base
            if np.issubdtype(np_t, np.floating):
                out = base.copy()
                out[null] = np.nan
                return out
            out = base.astype(object)  # nullable-int convention
            out[null] = None
            return out

        return Column(ev, self._name)

    def asc(self) -> "_SortKey":
        return _SortKey(self._name, ascending=True)

    def desc(self) -> "_SortKey":
        return _SortKey(self._name, ascending=False)

    def otherwise(self, value) -> "Column":
        raise TypeError("otherwise() follows when(); use F.when(cond, v).otherwise(...)")


class _SortKey:
    def __init__(self, name: str, ascending: bool):
        self.name, self.ascending = name, ascending


class _WhenColumn(Column):
    """``F.when(cond, value)`` chain; closes with ``.otherwise(value)``."""

    def __init__(self, branches):
        self._branches = branches  # list of (cond Column, value Column)
        super().__init__(self._evaluate, "CASE WHEN")

    def when(self, cond: Column, value) -> "_WhenColumn":
        return _WhenColumn(self._branches + [(cond, Column._coerce(value))])

    def otherwise(self, value) -> Column:
        other = Column._coerce(value)

        def ev(t):
            out = _as_arr(other._eval(t))
            return self._fold(t, out)

        return Column(ev, "CASE WHEN")

    def _evaluate(self, t):
        # un-terminated when(): missing branches are null (pyspark semantics)
        first = _as_arr(self._branches[0][1]._eval(t))
        base = (np.full(len(t), np.nan)
                if first.dtype != object else np.full(len(t), None, object))
        return self._fold(t, base, first_arr=first)

    def _fold(self, t, out, first_arr=None):
        for i, (cond, val) in reversed(list(enumerate(self._branches))):
            arr = first_arr if (i == 0 and first_arr is not None) else _as_arr(
                val._eval(t))
            out = np.where(_as_bool(cond._eval(t)), arr, out)
        return out


def _as_arr(v) -> np.ndarray:
    a = np.asarray(v)
    if a.dtype.kind in ("U", "S"):
        a = a.astype(object)
    return a


def _numeric_view(v) -> np.ndarray:
    """Arithmetic view of a column: object-promoted nullable-int columns
    (None for null) become float64 with NaN so null propagates through
    +,-,*,/ as in Spark; non-numeric object columns pass through."""
    from graphmine_tpu_torch.table import _object_as_float

    a = _as_arr(v)
    if a.dtype == object:
        num = _object_as_float(a, _isnull(a))
        if num is not None:
            return num
    return a


def _as_bool(v) -> np.ndarray:
    a = np.asarray(v)
    if a.dtype == object:
        return np.frompyfunc(lambda x: bool(x) if x is not None else False,
                             1, 1)(a).astype(bool)
    return a.astype(bool)


def col(name: str) -> Column:
    return Column(lambda t: t[name], name)


column = col


def lit(value) -> Column:
    return Column(
        lambda t: np.full(len(t), None, object) if value is None
        else np.full(len(t), value), repr(value)
    )


def when(cond: Column, value) -> _WhenColumn:
    return _WhenColumn([(cond, Column._coerce(value))])


def desc(name: str) -> _SortKey:
    return _SortKey(name, ascending=False)


def asc(name: str) -> _SortKey:
    return _SortKey(name, ascending=True)


class _AggColumn:
    """Marker from aggregate functions, consumed by ``GroupedData.agg``."""

    def __init__(self, fn: str, col_name: str, out: str):
        self.fn, self.col_name, self.out = fn, col_name, out

    def alias(self, name: str) -> "_AggColumn":
        return _AggColumn(self.fn, self.col_name, name)


def _agg_fn(fn: str):
    def make(col_name="*") -> _AggColumn:
        name = col_name if isinstance(col_name, str) else getattr(
            col_name, "_name", "col")
        return _AggColumn(fn, name, f"{fn}({name})")

    make.__name__ = fn
    return make


count = _agg_fn("count")
spark_sum = _agg_fn("sum")
spark_min = _agg_fn("min")
spark_max = _agg_fn("max")
avg = _agg_fn("mean")
mean = avg
first = _agg_fn("first")
countDistinct = _agg_fn("count_distinct")
collect_list = _agg_fn("collect_list")
collect_set = _agg_fn("collect_set")


class _UDFCol(Column):
    """Pending ``udf(...)(column)`` application (``Graphframes.py:71-72``)."""

    def __init__(self, fn, col):
        self.fn, self.col = fn, col
        super().__init__(self.evaluate, "udf")

    def evaluate(self, table: Table) -> np.ndarray:
        if isinstance(self.col, Column):
            vals = _as_arr(self.col._eval(table))
        elif isinstance(self.col, str):
            vals = table[self.col]
        else:
            vals = np.asarray(self.col)
        out = np.frompyfunc(
            lambda v: None if v is None else self.fn(v), 1, 1
        )(vals)
        return out.astype(object)


def udf(f, returnType=None):
    """``pyspark.sql.functions.udf`` (``Graphframes.py:61``). The wrapped
    function is applied per row host-side — the reference's semantics; the
    vectorized path is ``Table.to_edge_table`` / ``GraphFrame`` factorize."""
    return lambda col: _UDFCol(f, col)


class _MonotonicId:
    """Marker from ``monotonically_increasing_id()`` (``Graphframes.py:38``)."""


def monotonically_increasing_id() -> _MonotonicId:
    return _MonotonicId()


# ---------------------------------------------------------------------------
# RDD — the driver-side element view (Graphframes.py:53, :67)
# ---------------------------------------------------------------------------


class RDD:
    """List-backed RDD: the reference uses it only for the vertex-dictionary
    idiom (``flatMap``/``distinct``/``map``/``toDF``), all driver-side."""

    def __init__(self, elems):
        self._e = list(elems)

    def flatMap(self, f) -> "RDD":
        out = []
        for x in self._e:
            out.extend(f(x))
        return RDD(out)

    def map(self, f) -> "RDD":
        return RDD([f(x) for x in self._e])

    def filter(self, f) -> "RDD":
        return RDD([x for x in self._e if f(x)])

    def distinct(self) -> "RDD":
        return RDD(dict.fromkeys(self._e))

    def count(self) -> int:
        return len(self._e)

    def collect(self) -> list:
        return list(self._e)

    def toDF(self, names: Sequence[str]) -> "DataFrame":
        rows = [x if isinstance(x, (tuple, list)) else (x,) for x in self._e]
        return DataFrame(Table.from_records(rows, names))


# ---------------------------------------------------------------------------
# DataFrame — pyspark.sql.DataFrame facade over Table
# ---------------------------------------------------------------------------


class DataFrame:
    """Facade over :class:`Table` with Spark method spellings and Row-based
    ``collect`` (cached: the reference re-collects inside loops,
    ``Graphframes.py:102, :110``)."""

    def __init__(self, table: Table):
        self._t = table
        self._rows: list | None = None

    # table delegation ------------------------------------------------------

    @property
    def columns(self) -> list:
        return self._t.columns

    def count(self) -> int:
        return self._t.count()

    def withColumnRenamed(self, a: str, b: str) -> "DataFrame":
        return DataFrame(self._t.with_column_renamed(a, b))

    def filter(self, cond) -> "DataFrame":
        if isinstance(cond, Column):
            cond = _as_bool(cond._eval(self._t))
        return DataFrame(self._t.filter(cond))

    where = filter

    def select(self, *exprs) -> "DataFrame":
        if not any(isinstance(e, Column) for e in exprs):
            return DataFrame(self._t.select(*exprs))
        cols: dict = {}

        def put(name, values):
            if name in cols:  # a dict cannot hold Spark's duplicate columns
                raise ValueError(
                    f"duplicate output column {name!r} in select; alias() one"
                )
            cols[name] = values

        for e in exprs:
            if isinstance(e, Column):
                put(e._name, _as_arr(e._eval(self._t)))
            else:
                for name in [e] if isinstance(e, str) else e:
                    put(name, self._t[name])
        return DataFrame(Table(cols))

    def withColumn(self, name: str, value) -> "DataFrame":
        if isinstance(value, _MonotonicId):
            return DataFrame(self._t.with_row_ids(name))
        if isinstance(value, Column):
            value = _as_arr(value._eval(self._t))
        return DataFrame(self._t.with_column(name, value))

    def __getitem__(self, name: str) -> Column:
        if name not in self._t.columns:
            raise KeyError(name)
        return col(name)

    def __getattr__(self, name: str) -> Column:
        if name.startswith("_"):
            raise AttributeError(name)
        if name in self._t.columns:
            return col(name)
        raise AttributeError(name)

    def distinct(self) -> "DataFrame":
        return DataFrame(self._t.distinct())

    def dropDuplicates(self, subset=None) -> "DataFrame":
        return DataFrame(self._t.drop_duplicates(subset))

    def drop(self, *names) -> "DataFrame":
        return DataFrame(self._t.drop(*names))

    def dropna(self, how: str = "any", thresh: int | None = None,
               subset=None) -> "DataFrame":
        cols = subset or self._t.columns
        nulls = np.column_stack([_isnull(self._t[c]) for c in cols])
        if thresh is not None:  # Spark: keep rows with >= thresh non-nulls
            keep = (~nulls).sum(axis=1) >= thresh
        elif how == "all":
            keep = ~nulls.all(axis=1)
        else:
            keep = ~nulls.any(axis=1)
        return DataFrame(self._t.filter(keep))

    def fillna(self, value, subset=None) -> "DataFrame":
        return DataFrame(self._t.fillna(value, subset))

    def sort(self, *by, ascending=True) -> "DataFrame":
        """pyspark forms: names, Columns, F.desc/F.asc keys, or
        ``ascending=[bool, ...]`` (one per key)."""
        if isinstance(ascending, (list, tuple)):
            defaults = [bool(a) for a in ascending]
            if len(defaults) != len(by):
                raise ValueError(
                    f"ascending has {len(defaults)} entries for {len(by)} keys"
                )
        else:
            defaults = [bool(ascending)] * len(by)
        names, flags = [], []
        for b, d in zip(by, defaults):
            if isinstance(b, _SortKey):
                names.append(b.name)
                flags.append(b.ascending)
            elif isinstance(b, Column):
                names.append(b._name)
                flags.append(d)
            else:
                names.append(b)
                flags.append(d)
        return DataFrame(self._t.sort(*names, ascending=flags))

    orderBy = sort

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._t.limit(n))

    def subtract(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._t.subtract(other._t))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(self._t.union(other._t))

    unionAll = union

    def join(self, other: "DataFrame", on, how: str = "inner") -> "DataFrame":
        return DataFrame(self._t.join(other._t, on, how))

    def groupBy(self, *names):
        grouped = self._t.group_by(*names)
        return _GroupedData(grouped)

    groupby = groupBy

    def agg(self, *specs, **named) -> "DataFrame":
        plain = []
        for s in specs:  # pyspark: df.agg(F.sum("v"), ...) markers
            if isinstance(s, _AggColumn):
                named[s.out] = (s.col_name, s.fn)
            else:
                plain.append(s)
        return DataFrame(self._t.agg(*plain, **named))

    def show(self, n: int = 20, truncate=True) -> None:
        width = 20 if truncate is True else (0 if truncate is False else int(truncate))
        self._t.show(n, truncate=width)

    def persist(self, *a) -> "DataFrame":
        return self  # eager engine: materialize-once is automatic

    cache = persist

    def unpersist(self, *a) -> "DataFrame":
        return self

    def collect(self) -> list:
        if self._rows is None:
            names = self._t.columns
            cols = [self._t[c] for c in names]
            self._rows = [Row._make(vals, names) for vals in zip(*cols)]
        return list(self._rows)  # fresh list per call, as in pyspark

    def head(self, n: int | None = None):
        """pyspark semantics: ``head()`` → first Row or None; ``head(n)`` →
        list of Rows."""
        if n is None:
            rows = self.limit(1).collect()
            return rows[0] if rows else None
        return self.limit(n).collect()

    def first(self):
        return self.head()

    def take(self, n: int) -> list:
        return self.head(n)

    def toPandas(self):
        import pandas as pd

        return pd.DataFrame(self._t.to_dict())

    @property
    def rdd(self) -> RDD:
        return RDD(self.collect())

    @property
    def write(self) -> "_DataFrameWriter":
        return _DataFrameWriter(self)

    @property
    def schema(self):
        return self._t.schema

    def __repr__(self) -> str:
        return "DataFrame[" + ", ".join(
            f"{c}: {self._t.schema[c]}" for c in self.columns
        ) + "]"


class _GroupedData:
    def __init__(self, grouped):
        self._g = grouped

    def count(self) -> DataFrame:
        return DataFrame(self._g.count())

    def agg(self, *specs, **named) -> DataFrame:
        plain = []
        for s in specs:  # F.sum("v").alias("total") markers → kwargs form
            if isinstance(s, _AggColumn):
                named[s.out] = (s.col_name, s.fn)
            else:
                plain.append(s)
        return DataFrame(self._g.agg(*plain, **named))

    def sum(self, *cols) -> DataFrame:
        return DataFrame(self._g.sum(*cols))

    def min(self, *cols) -> DataFrame:
        return DataFrame(self._g.min(*cols))

    def max(self, *cols) -> DataFrame:
        return DataFrame(self._g.max(*cols))

    def mean(self, *cols) -> DataFrame:
        return DataFrame(self._g.mean(*cols))

    avg = mean


# ---------------------------------------------------------------------------
# Session objects (Graphframes.py:12-14)
# ---------------------------------------------------------------------------


class SparkConf:
    def __init__(self):
        self._conf: dict = {}

    def set(self, k, v) -> "SparkConf":
        self._conf[k] = v
        return self

    def setAppName(self, name) -> "SparkConf":
        return self.set("spark.app.name", name)

    def setMaster(self, master) -> "SparkConf":
        return self.set("spark.master", master)

    def get(self, k, default=None):
        return self._conf.get(k, default)


class SparkContext:
    """``SparkContext("local[*]")`` (``Graphframes.py:12``). There is no JVM
    to launch: the shim's device is the runtime."""

    def __init__(self, master: str | None = None, appName: str | None = None,
                 conf: SparkConf | None = None, **kw):
        self.master = master or "local[*]"
        self.appName = appName or "graphmine_tpu_torch"

    def parallelize(self, data, numSlices=None) -> RDD:
        return RDD(data)

    def stop(self) -> None:
        pass

    def setLogLevel(self, level) -> None:
        pass


class _DataFrameReader:
    def parquet(self, *paths: str) -> DataFrame:
        tables = [Table.read_parquet(p) for p in paths]
        out = tables[0]
        for t in tables[1:]:
            out = out.union(t)
        return DataFrame(out)

    def csv(self, path: str, header: bool = False, sep: str = ",",
            inferSchema: bool = False) -> DataFrame:
        # Spark default: all-string columns unless inferSchema=True
        return DataFrame(Table.read_csv(path, header=header, sep=sep,
                                        infer_schema=inferSchema))


class _DataFrameWriter:
    """``df.write.mode("overwrite").parquet(path)`` — Spark's writer chain.

    Default mode is ``error`` (refuse to clobber an existing path), as in
    Spark; the target is a single file, not a part-file directory."""

    def __init__(self, df: DataFrame, mode: str = "error"):
        self._df = df
        self._mode = mode

    def mode(self, m: str) -> "_DataFrameWriter":
        if m not in ("error", "errorifexists", "overwrite", "ignore"):
            raise ValueError(f"unsupported write mode {m!r}")
        return _DataFrameWriter(self._df, m)

    def _check(self, path: str) -> bool:
        if os.path.exists(path):
            if self._mode in ("error", "errorifexists"):
                raise FileExistsError(f"path already exists: {path!r}")
            if self._mode == "ignore":
                return False
        return True

    def parquet(self, path: str, compression: str = "snappy") -> None:
        if self._check(path):
            self._df._t.write_parquet(path, compression=compression)

    def csv(self, path: str, header: bool = False) -> None:
        if self._check(path):
            self._df._t.write_csv(path, header=header)


class _SessionBuilder:
    def __init__(self):
        self._conf: dict = {}

    def appName(self, name) -> "_SessionBuilder":
        self._conf["spark.app.name"] = name
        return self

    def master(self, master) -> "_SessionBuilder":
        self._conf["spark.master"] = master
        return self

    def config(self, key=None, value=None, conf=None) -> "_SessionBuilder":
        if key is not None:
            self._conf[key] = value
        return self

    def enableHiveSupport(self) -> "_SessionBuilder":
        return self

    def getOrCreate(self) -> "SparkSession":
        return SparkSession()


class SparkSession:
    """``SparkSession.builder.appName(...).getOrCreate()``
    (``Graphframes.py:13``)."""

    builder = _SessionBuilder()

    def __init__(self):
        self.sparkContext = SparkContext()

    @property
    def read(self) -> _DataFrameReader:
        return _DataFrameReader()

    def createDataFrame(self, data, schema: Sequence[str]) -> DataFrame:
        return DataFrame(Table.from_records(list(data), list(schema)))

    def stop(self) -> None:
        pass


class SQLContext:
    """Legacy ``SQLContext(sc)`` (``Graphframes.py:14``)."""

    def __init__(self, sparkContext: SparkContext | None = None):
        self._session = SparkSession()

    @property
    def read(self) -> _DataFrameReader:
        return _DataFrameReader()

    def createDataFrame(self, data, schema: Sequence[str]) -> DataFrame:
        return self._session.createDataFrame(data, schema)


# ---------------------------------------------------------------------------
# graphframes.GraphFrame facade (Graphframes.py:78-81)
# ---------------------------------------------------------------------------


class GraphFrame:
    """GraphFrames' result convention over the PyTorch engine: algorithms return
    *DataFrames* of the vertex table plus a result column (``label``,
    ``component``, ``pagerank``, ...), exactly what the reference consumes at
    ``Graphframes.py:82-104``."""

    def __init__(self, v: DataFrame, e: DataFrame):
        v_t = v._t if isinstance(v, DataFrame) else Table(v)
        e_t = e._t if isinstance(e, DataFrame) else Table(e)
        self._gf = _frames.GraphFrame(v_t, e_t, device=_DEVICE)  # string-id factorize path
        self._v = DataFrame(Table(self._gf.vertices))
        self._e = e if isinstance(e, DataFrame) else DataFrame(e_t)

    @property
    def vertices(self) -> DataFrame:
        return self._v

    @property
    def edges(self) -> DataFrame:
        return self._e

    def _with_result(self, name: str, values: np.ndarray) -> DataFrame:
        cols = _visible_vertex_cols(self._gf)
        cols[name] = np.asarray(values)
        return DataFrame(Table(cols))

    def labelPropagation(self, maxIter: int = 5) -> DataFrame:
        labels = _host(self._gf.label_propagation(max_iter=maxIter))
        return self._with_result("label", labels.astype(np.int64))

    def connectedComponents(self, **kw) -> DataFrame:
        comp = _host(self._gf.connected_components(**kw))
        return self._with_result("component", comp.astype(np.int64))

    def stronglyConnectedComponents(self, maxIter: int | None = None) -> DataFrame:
        comp = _host(self._gf.strongly_connected_components())
        return self._with_result("component", comp.astype(np.int64))

    def pageRank(self, resetProbability: float = 0.15, maxIter: int = 100,
                 tol: float = 1e-6, sourceId=None) -> "GraphFrame":
        """GraphFrames convention: returns a *GraphFrame* whose vertices
        carry ``pagerank`` and whose edges carry ``weight`` (the uniform
        transition probability 1/outdeg(src))."""
        if sourceId is not None:
            reset = np.zeros(self._gf.num_vertices, dtype=np.float32)
            reset[self._vertex_index(sourceId)] = 1.0
            ranks = self._gf.pagerank(alpha=1.0 - resetProbability,
                                      max_iter=maxIter, tol=tol, reset=reset)
        else:
            ranks = self._gf.pagerank(alpha=1.0 - resetProbability,
                                      max_iter=maxIter, tol=tol)
        out = _host(self._gf.out_degrees()).astype(np.float64)
        weight = 1.0 / np.maximum(out, 1.0)[self._gf.edges["src"]]
        return self._result_frame(
            "pagerank", _host(ranks).astype(np.float64), "weight", weight
        )

    def _result_frame(self, vname, vvalues, ename=None, evalues=None) -> "GraphFrame":
        g = object.__new__(GraphFrame)
        g._gf = self._gf
        vcols = _visible_vertex_cols(self._gf)
        vcols[vname] = vvalues
        g._v = DataFrame(Table(vcols))
        ecols = dict(self._e._t.to_dict())
        if ename is not None:
            ecols[ename] = evalues
        g._e = DataFrame(Table(ecols))
        return g

    def triangleCount(self) -> DataFrame:
        tri, _total = self._gf.triangle_count()
        return self._with_result("count", _host(tri).astype(np.int64))

    @property
    def degrees(self) -> DataFrame:
        return self._with_result("degree", _host(self._gf.degrees()))

    @property
    def inDegrees(self) -> DataFrame:
        return self._with_result("inDegree", _host(self._gf.in_degrees()))

    @property
    def outDegrees(self) -> DataFrame:
        return self._with_result("outDegree", _host(self._gf.out_degrees()))

    def shortestPaths(self, landmarks) -> DataFrame:
        idx = [self._vertex_index(l) for l in landmarks]
        dist = _host(self._gf.shortest_paths(np.asarray(idx, np.int32)))
        unreachable = np.iinfo(np.int32).max
        dcol = np.empty(self._gf.num_vertices, dtype=object)
        for v in range(self._gf.num_vertices):
            dcol[v] = {
                lm: int(dist[v, j]) for j, lm in enumerate(landmarks)
                if 0 <= dist[v, j] < unreachable
            }
        return self._with_result("distances", dcol)

    def aggregateMessages(self, *aggs, sendToSrc=None, sendToDst=None) -> DataFrame:
        """GraphFrames ``aggregateMessages``: message expressions over the
        triplet namespace (``AM.src["attr"]``, ``AM.dst["attr"]``,
        ``AM.edge["attr"]``), aggregated per receiving vertex with
        ``F.<fn>(AM.msg)`` markers. Returns ``[id, <agg columns...>]`` for
        vertices that received at least one message (GraphFrames drops the
        rest)."""
        if sendToSrc is None and sendToDst is None:
            raise ValueError("provide sendToSrc and/or sendToDst")
        if not aggs:
            raise ValueError("provide at least one aggregate (e.g. F.sum(AM.msg))")
        for expr in (sendToSrc, sendToDst):
            if expr is not None and not isinstance(expr, Column):
                raise TypeError(
                    "sendToSrc/sendToDst must be Columns over the AM "
                    "namespace (AM.src['attr'], AM.dst['attr'], ...), got "
                    f"{expr!r}"
                )
        ids = self._ids()
        e_src = np.asarray(self._gf.edges["src"])
        e_dst = np.asarray(self._gf.edges["dst"])
        tcols: dict = {}
        for name, col in _visible_vertex_cols(self._gf).items():
            arr = np.asarray(col)
            tcols[f"src_{name}"] = arr[e_src]
            tcols[f"dst_{name}"] = arr[e_dst]
        for name, col in self._gf.edges.items():
            if name not in ("src", "dst"):
                tcols[f"edge_{name}"] = np.asarray(col)
        triplets = Table(tcols)

        recv_parts, msg_parts = [], []
        if sendToDst is not None:
            msg_parts.append(_as_arr(sendToDst._eval(triplets)))
            recv_parts.append(ids[e_dst])
        if sendToSrc is not None:
            msg_parts.append(_as_arr(sendToSrc._eval(triplets)))
            recv_parts.append(ids[e_src])
        msg_table = Table({
            "id": np.concatenate(recv_parts),
            "msg": np.concatenate(msg_parts),
        })
        named = {}
        for a in aggs:
            if not isinstance(a, _AggColumn):
                raise TypeError(
                    f"aggregates must be F.<fn>(AM.msg) markers, got {a!r}"
                )
            if a.col_name != "msg":
                raise TypeError(
                    "aggregateMessages aggregates operate on AM.msg, got "
                    f"a reference to {a.col_name!r}"
                )
            named[a.out] = ("msg", a.fn)
        return DataFrame(msg_table.group_by("id").agg(**named))

    # -- expression-driven surfaces (GraphFrames SQL strings) --------------

    def _ids(self) -> np.ndarray:
        ids = self._gf.vertices.get("id")
        return np.arange(self._gf.num_vertices) if ids is None else np.asarray(ids)

    def _vertex_sql_mask(self, expr) -> np.ndarray:
        return _sql_mask(expr, self._gf.vertices, self._gf.num_vertices)

    def bfs(self, fromExpr, toExpr, edgeFilter=None,
            maxPathLength: int = 10) -> DataFrame:
        """GraphFrames ``bfs``: SQL expression strings (or boolean masks)
        select the endpoint sets; returns the paths DataFrame with columns
        ``from, e0, v1, e1, ..., to`` — vertex cells hold the vertex id,
        edge cells ``(src_id, dst_id)`` pairs. ``edgeFilter``: SQL
        expression (or mask) over the edge columns (id-valued ``src``/
        ``dst``, GraphFrames semantics) restricting traversable edges;
        the vertex set is unchanged."""
        if edgeFilter is not None:
            return self.filterEdges(edgeFilter).bfs(
                fromExpr, toExpr, maxPathLength=maxPathLength
            )
        from graphmine_tpu_torch.ops.paths import bfs as _bfs

        src_ids = np.flatnonzero(self._vertex_sql_mask(fromExpr))
        dst_ids = np.flatnonzero(self._vertex_sql_mask(toExpr))
        ids = self._ids()
        if maxPathLength <= 0:  # GraphFrames: no traversal, zero-hop only
            paths = [np.array([v], np.int32)
                     for v in np.intersect1d(src_ids, dst_ids)]
        else:
            paths = _bfs(self._gf.graph(symmetric=False), src_ids, dst_ids,
                         max_path_length=maxPathLength)
        if not paths:
            return DataFrame(Table({"from": np.empty(0, object),
                                    "to": np.empty(0, object)}))
        hops = len(paths[0]) - 1
        names = ["from"] + [
            x for i in range(1, hops) for x in (f"e{i-1}", f"v{i}")
        ] + ([f"e{hops-1}"] if hops else []) + ["to"]
        rows = []
        for p in paths:
            cells = [ids[p[0]]]
            for i in range(hops):
                cells.append((ids[p[i]], ids[p[i + 1]]))
                cells.append(ids[p[i + 1]])
            rows.append(cells if hops else [ids[p[0]], ids[p[0]]])
        cols = {}
        for j, name in enumerate(names):  # object columns: cells may be tuples
            col = np.empty(len(rows), dtype=object)
            for i, r in enumerate(rows):
                col[i] = r[j]
            cols[name] = col
        return DataFrame(Table(cols))

    def find(self, pattern: str) -> DataFrame:
        """GraphFrames motif ``find``: one row per match; named vertices
        are id columns, named edges ``(src_id, dst_id)`` pairs."""
        res = self._gf.find(pattern)
        ids = self._ids()
        cols: dict = {}
        for name, vals in res.vertices.items():
            cols[name] = ids[np.asarray(vals)]
        e_src = np.asarray(self._gf.edges["src"])
        e_dst = np.asarray(self._gf.edges["dst"])
        for name, rows_ in res.edges.items():
            idx = np.asarray(rows_, dtype=np.int64)
            pair_src, pair_dst = ids[e_src[idx]], ids[e_dst[idx]]
            cols[name] = np.fromiter(
                zip(pair_src, pair_dst), dtype=object, count=len(idx)
            )
        return DataFrame(Table(cols))

    def filterVertices(self, condition) -> "GraphFrame":
        sub = self._gf.filter_vertices(self._vertex_sql_mask(condition))
        return _wrap_engine(sub)

    def filterEdges(self, condition) -> "GraphFrame":
        # Predicates see id-valued src/dst (GraphFrames semantics), not the
        # engine's dense indices.
        ids = self._ids()
        view = dict(self._gf.edges)
        view["src"] = ids[np.asarray(view["src"])]
        view["dst"] = ids[np.asarray(view["dst"])]
        mask = _sql_mask(condition, view, self._gf.num_edges)
        return _wrap_engine(self._gf.filter_edges(mask))

    def dropIsolatedVertices(self) -> "GraphFrame":
        return _wrap_engine(self._gf.drop_isolated_vertices())

    def _vertex_index(self, vid) -> int:
        ids = self._gf.vertices.get("id")
        if ids is None:
            return int(vid)
        hits = np.flatnonzero(ids == vid)
        if len(hits) == 0:
            raise KeyError(f"vertex id {vid!r} not found")
        return int(hits[0])

    def persist(self, *a) -> "GraphFrame":
        return self

    cache = persist

    def __repr__(self) -> str:
        return repr(self._gf)


class _AMSide:
    """``AM.src`` / ``AM.dst`` / ``AM.edge``: attribute access yields a
    Column over the triplet namespace of :meth:`GraphFrame.aggregateMessages`."""

    def __init__(self, side: str):
        self._side = side

    def __getitem__(self, attr: str) -> Column:
        side = self._side
        return Column(lambda tr: tr[f"{side}_{attr}"], f"{side}[{attr!r}]")

    def __getattr__(self, attr: str) -> Column:
        if attr.startswith("_"):
            raise AttributeError(attr)
        return self[attr]


class AggregateMessages:
    """``graphframes.lib.AggregateMessages`` — the triplet column namespace."""

    src = _AMSide("src")
    dst = _AMSide("dst")
    edge = _AMSide("edge")
    msg = Column(lambda tr: tr["msg"], "msg")


def _friends_graph() -> "GraphFrame":
    """``graphframes.examples.Graphs.friends()`` — the canonical GraphFrames
    docs graph (7 people, 8 relationship edges)."""
    v = Table(
        id=np.array(list("abcdefg"), dtype=object),
        name=np.array(["Alice", "Bob", "Charlie", "David", "Esther",
                       "Fanny", "Gabby"], dtype=object),
        age=np.array([34, 36, 30, 29, 32, 36, 60]),
    )
    e = Table(
        src=np.array(list("abcfeeda"), dtype=object),
        dst=np.array(list("bcbcfdae"), dtype=object),
        relationship=np.array(["friend", "follow", "follow", "follow",
                               "follow", "friend", "friend", "friend"],
                              dtype=object),
    )
    return GraphFrame(DataFrame(v), DataFrame(e))


class _Graphs:
    def __init__(self, *a):  # GraphFrames: Graphs(spark).friends()
        pass

    @staticmethod
    def friends() -> "GraphFrame":
        return _friends_graph()


def _host(values) -> np.ndarray:
    """An engine result on the host: a tensor copied off its device."""
    if hasattr(values, "detach"):
        return values.detach().cpu().numpy()
    return np.asarray(values)


def _sql_mask(expr, columns, n: int) -> np.ndarray:
    """SQL predicate string (GraphFrames expression surface) or boolean
    mask/callable → boolean mask over ``columns``."""
    if isinstance(expr, str):
        from graphmine_tpu_torch.table import _PredicateParser, _tokenize

        return _PredicateParser(_tokenize(expr), columns, n).parse()
    if callable(expr) and not isinstance(expr, np.ndarray):
        return np.asarray(expr(columns), dtype=bool)
    return np.asarray(expr, dtype=bool)


def _visible_vertex_cols(gf: "_frames.GraphFrame") -> dict:
    """Vertex columns a GraphFrames user should see: engine bookkeeping
    (the ``orig`` root-frame index threaded through filters) stays hidden."""
    cols = {k: v for k, v in gf.vertices.items() if k != "orig"}
    return cols or {"id": np.arange(gf.num_vertices, dtype=np.int64)}


def _wrap_engine(gf: "_frames.GraphFrame") -> "GraphFrame":
    """Wrap an engine GraphFrame (e.g. a filtered subgraph) without
    re-running id factorization. Edges are shown with id-valued src/dst
    (the GraphFrames convention), not the engine's dense indices."""
    g = object.__new__(GraphFrame)
    g._gf = gf
    vcols = _visible_vertex_cols(gf)
    g._v = DataFrame(Table(vcols))
    ids = vcols.get("id")
    ecols = dict(gf.edges)
    if ids is not None:
        ids = np.asarray(ids)
        ecols["src"] = ids[np.asarray(ecols["src"])]
        ecols["dst"] = ids[np.asarray(ecols["dst"])]
    g._e = DataFrame(Table(ecols))
    return g


# ---------------------------------------------------------------------------
# module installation + script runner
# ---------------------------------------------------------------------------


# The shim's pyspark module says what it is; install() recognizes its own.
_MARKER = "graphmine_tpu_torch compat shim"


def _build_modules() -> dict:
    pyspark = types.ModuleType("pyspark")
    sql = types.ModuleType("pyspark.sql")
    functions = types.ModuleType("pyspark.sql.functions")
    graphframes = types.ModuleType("graphframes")

    pyspark.SparkContext = SparkContext
    pyspark.SparkConf = SparkConf
    pyspark.sql = sql
    pyspark.__all__ = ["SparkContext", "SparkConf", "sql"]
    pyspark.__doc__ = f"{_MARKER} (not real pyspark)"

    sql.SparkSession = SparkSession
    sql.SQLContext = SQLContext
    sql.DataFrame = DataFrame
    sql.Row = Row
    sql.Column = Column
    sql.functions = functions
    sql.__all__ = ["SparkSession", "SQLContext", "DataFrame", "Row", "Column",
                   "functions"]

    functions.udf = udf
    functions.monotonically_increasing_id = monotonically_increasing_id
    functions.col = col
    functions.column = column
    functions.lit = lit
    functions.when = when
    functions.desc = desc
    functions.asc = asc
    functions.count = count
    functions.sum = spark_sum
    functions.min = spark_min
    functions.max = spark_max
    functions.avg = avg
    functions.mean = mean
    functions.first = first
    functions.countDistinct = countDistinct
    functions.collect_list = collect_list
    functions.collect_set = collect_set
    functions.__all__ = [
        "udf", "monotonically_increasing_id", "col", "column", "lit", "when",
        "desc", "asc", "count", "sum", "min", "max", "avg", "mean", "first",
        "countDistinct", "collect_list", "collect_set",
    ]

    graphframes.GraphFrame = GraphFrame
    graphframes.__all__ = ["GraphFrame"]
    gf_lib = types.ModuleType("graphframes.lib")
    gf_lib.AggregateMessages = AggregateMessages
    gf_lib.__all__ = ["AggregateMessages"]
    graphframes.lib = gf_lib
    gf_examples = types.ModuleType("graphframes.examples")
    gf_examples.Graphs = _Graphs
    gf_examples.__all__ = ["Graphs"]
    graphframes.examples = gf_examples

    return {
        "pyspark": pyspark,
        "pyspark.sql": sql,
        "pyspark.sql.functions": functions,
        "graphframes": graphframes,
        "graphframes.lib": gf_lib,
        "graphframes.examples": gf_examples,
    }


def install(force: bool = False, device=None) -> dict:
    """Register the shim modules in ``sys.modules``; returns them. The
    shim's graphs run on ``device`` (CUDA unless named; raises when CUDA is
    asked for and absent).

    Refuses to shadow a real pyspark — imported *or* merely installed —
    or another package's shim unless ``force=True``. All existing
    ``pyspark*``/``graphframes*`` entries are purged first so forced
    installs can't leave a mix of real submodules under shim parents."""
    global _DEVICE
    dev = resolve_device(device)
    mod = sys.modules.get("pyspark")
    ours = mod is not None and _MARKER in (mod.__doc__ or "")
    if not force and not ours:
        if mod is not None:
            raise RuntimeError(
                "a real pyspark (or another package's pyspark shim) is already "
                "imported; pass force=True to shadow it"
            )
        import importlib.util

        try:
            spec = importlib.util.find_spec("pyspark")
        except (ImportError, ValueError):
            spec = None
        if spec is not None:
            raise RuntimeError(
                "a real pyspark is installed; pass force=True to shadow it"
            )
    for name in list(sys.modules):
        if name.split(".", 1)[0] in ("pyspark", "graphframes"):
            del sys.modules[name]
    _DEVICE = dev
    mods = _build_modules()
    sys.modules.update(mods)
    return mods


def main(argv: Sequence[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Run an unmodified pyspark/GraphFrames script on the "
        "PyTorch engine (reference parity: CommunityDetection/Graphframes.py)"
    )
    p.add_argument("script", help="path to the pyspark script")
    p.add_argument(
        "--cwd", default=None,
        help="directory to run in (default: the script's own directory, so "
        "relative data paths like the reference's resolve)",
    )
    p.add_argument(
        "--device", default=None,
        help="device the graphs run on (default: cuda; cpu runs on the host)",
    )
    args = p.parse_args(argv)
    path = os.path.abspath(args.script)
    # Invoking this runner IS the request to use the shim, so shadow any
    # real pyspark for this process.
    install(force=True, device=args.device)
    os.chdir(args.cwd or os.path.dirname(path) or ".")
    runpy.run_path(path, run_name="__main__")


if __name__ == "__main__":
    main()
