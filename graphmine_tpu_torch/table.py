"""Columnar ``Table`` — the relational layer (Spark DataFrame contract).

The reference drives its whole preprocessing phase through Spark SQL
DataFrame ops (SURVEY §2.2 "DataFrame ops" row): ``read.parquet``
(``Graphframes.py:16``), ``withColumnRenamed`` ×4 (``:26-29``), a SQL-string
``filter("ParentDomain is not null and ChildDomain is not null")`` (``:30``),
``select``/``withColumn`` (``:70-73``), ``distinct``/``count``
(``:18,:54,:85``), ``show(10)`` (``:32,:68,:74,:82``), ``persist`` (``:82``)
and ``collect`` (``:100-110``). The dead data-slicer (``:34-47``) also used
``monotonically_increasing_id`` + ``sort``/``limit``/``subtract``.

This module is the port's own copy of ``graphmine_tpu/table.py`` (host
NumPy, the same results; its edge-table bridge is the port's
``io/edges.py::_from_string_columns``). It reproduces that contract as a
**host-side columnar table** (NumPy arrays per column — the Arrow/Catalyst equivalent) whose ops
are all vectorized, with a small SQL predicate parser so the reference's
literal filter strings run unchanged. There is no lazy DAG and no shuffle:
every op materializes eagerly (``persist`` is therefore the identity, kept
for call-site parity), and ``collect`` is a plain host read rather than a
JVM→driver boundary. Device code never sees strings — the bridge to the
engine is :meth:`Table.to_edge_table`, which factorizes to dense int32.

Both snake_case and Spark's camelCase method names are provided.
"""

from __future__ import annotations

import re
from collections import namedtuple
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

__all__ = ["Table", "read_parquet"]


# ---------------------------------------------------------------------------
# SQL predicate parser (the `filter("...")` surface, Graphframes.py:30)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<num>-?\d+\.\d+|-?\d+)
      | '(?P<str>(?:[^'\\]|\\.)*)'
      | "(?P<dstr>(?:[^"\\]|\\.)*)"
      | (?P<op><=|>=|!=|<>|==|=|<|>)
      | (?P<lp>\()
      | (?P<rp>\))
      | (?P<comma>,)
      | (?P<word>[A-Za-z_][A-Za-z0-9_.]*)
    )""",
    re.VERBOSE,
)

_KEYWORDS = {"and", "or", "not", "is", "null", "in", "like", "true", "false"}


def _tokenize(expr: str) -> list[tuple[str, Any]]:
    tokens, pos = [], 0
    while pos < len(expr):
        m = _TOKEN_RE.match(expr, pos)
        if not m or m.end() == pos:
            if expr[pos:].strip() == "":
                break
            raise ValueError(f"cannot parse filter expression at: {expr[pos:]!r}")
        pos = m.end()
        if m.group("num") is not None:
            text = m.group("num")
            tokens.append(("lit", float(text) if "." in text else int(text)))
        elif m.group("str") is not None:
            tokens.append(("lit", m.group("str").replace("\\'", "'")))
        elif m.group("dstr") is not None:
            tokens.append(("lit", m.group("dstr").replace('\\"', '"')))
        elif m.group("op") is not None:
            tokens.append(("op", m.group("op")))
        elif m.group("lp"):
            tokens.append(("lp", "("))
        elif m.group("rp"):
            tokens.append(("rp", ")"))
        elif m.group("comma"):
            tokens.append(("comma", ","))
        else:
            word = m.group("word")
            low = word.lower()
            if low in _KEYWORDS:
                tokens.append(("kw", low))
            else:
                tokens.append(("ident", word))
    return tokens


class _Tri:
    """SQL three-valued logic: a boolean vector plus an ``unknown`` (null)
    vector. ``true``/``false``/``unknown`` are disjoint; a row passes a
    filter only when the predicate is *true* (unknown rows drop, and
    ``NOT unknown`` stays unknown — Spark semantics)."""

    __slots__ = ("v", "u")

    def __init__(self, v: np.ndarray, u: np.ndarray | None = None):
        self.v = v
        self.u = np.zeros(len(v), bool) if u is None else u

    def __and__(self, o: "_Tri") -> "_Tri":
        false = (~self.v & ~self.u) | (~o.v & ~o.u)
        v = self.v & o.v
        return _Tri(v, ~v & ~false)

    def __or__(self, o: "_Tri") -> "_Tri":
        v = self.v | o.v
        return _Tri(v, ~v & (self.u | o.u))

    def __invert__(self) -> "_Tri":
        return _Tri(~self.v & ~self.u, self.u)


class _PredicateParser:
    """Recursive-descent parser for the SQL predicate subset Spark-style
    ``filter`` strings use: comparisons, ``is [not] null``, ``like``,
    ``in (...)``, ``and``/``or``/``not``, parentheses. Evaluates under SQL
    three-valued logic (comparisons against null are *unknown*, not false)."""

    def __init__(self, tokens: list[tuple[str, Any]], columns: Mapping[str, np.ndarray], n: int):
        self.toks = tokens
        self.i = 0
        self.cols = columns
        self.n = n

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def take(self, kind=None, value=None):
        tok = self.peek()
        if kind is not None and tok[0] != kind:
            raise ValueError(f"expected {kind}, got {tok}")
        if value is not None and tok[1] != value:
            raise ValueError(f"expected {value!r}, got {tok}")
        self.i += 1
        return tok

    def parse(self) -> np.ndarray:
        tri = self.or_expr()
        if self.peek()[0] is not None:
            raise ValueError(f"trailing tokens: {self.toks[self.i:]}")
        return tri.v  # rows where the predicate is TRUE (unknown drops)

    def or_expr(self) -> _Tri:
        left = self.and_expr()
        while self.peek() == ("kw", "or"):
            self.take()
            left = left | self.and_expr()
        return left

    def and_expr(self) -> _Tri:
        left = self.not_expr()
        while self.peek() == ("kw", "and"):
            self.take()
            left = left & self.not_expr()
        return left

    def not_expr(self) -> _Tri:
        if self.peek() == ("kw", "not"):
            self.take()
            return ~self.not_expr()
        return self.comparison()

    def _operand(self):
        kind, val = self.peek()
        if kind == "lp":
            self.take()
            out = self.or_expr()
            self.take("rp")
            return ("mask", out)
        if kind == "ident":
            self.take()
            if val not in self.cols:
                raise KeyError(f"unknown column {val!r} in filter expression")
            return ("col", val)
        if kind == "lit":
            self.take()
            return ("lit", val)
        if kind == "kw" and val in ("true", "false"):
            self.take()
            return ("lit", val == "true")
        raise ValueError(f"unexpected token {self.peek()} in filter expression")

    def comparison(self) -> _Tri:
        left_kind, left = self._operand()
        if left_kind == "mask":
            return left
        kind, val = self.peek()
        if kind == "kw" and val == "is":
            self.take()
            negate = False
            if self.peek() == ("kw", "not"):
                self.take()
                negate = True
            self.take("kw", "null")
            mask = _isnull(self._resolve(left_kind, left))
            return _Tri(~mask if negate else mask)  # IS NULL is never unknown
        if kind == "kw" and val == "like":
            self.take()
            _, pat = self.take("lit")
            arr = self._resolve(left_kind, left)
            null = _isnull(arr)
            return _Tri(_like(arr, str(pat)) & ~null, null)
        if kind == "kw" and val == "in":
            self.take()
            self.take("lp")
            lits = []
            while True:
                _, lit = self.take("lit")
                lits.append(lit)
                if self.peek()[0] == "comma":
                    self.take()
                    continue
                self.take("rp")
                break
            arr = self._resolve(left_kind, left)
            hit = np.isin(
                arr, np.array(lits, dtype=arr.dtype if arr.dtype != object else object)
            )
            null = _isnull(arr)
            return _Tri(hit & ~null, null)
        if kind == "op":
            self.take()
            right_kind, right = self._operand()
            a = self._resolve(left_kind, left)
            b = self._resolve(right_kind, right)
            return _Tri(_compare(a, val, b), _isnull(a) | _isnull(b))
        if left_kind == "col":
            col = self.cols[left]
            if col.dtype == np.bool_:
                return _Tri(col.copy())
        raise ValueError(f"column {left!r} used as a predicate but is not boolean")

    def _resolve(self, kind, val):
        if kind == "col":
            return self.cols[val]
        return np.full(self.n, val, dtype=object if isinstance(val, str) else None)


def _isnull(col: np.ndarray) -> np.ndarray:
    if col.dtype == object:
        return np.frompyfunc(lambda v: v is None, 1, 1)(col).astype(bool)
    if np.issubdtype(col.dtype, np.floating):
        return np.isnan(col)
    return np.zeros(len(col), dtype=bool)


def _object_as_float(col: np.ndarray, null: np.ndarray) -> np.ndarray | None:
    """float64 view of an object column whose non-null values are all
    numeric — the nullable-int representation joins produce — with NaN at
    nulls; ``None`` if any non-null value is non-numeric."""
    is_num = np.frompyfunc(
        lambda v: isinstance(v, (int, float, np.integer, np.floating))
        and not isinstance(v, bool), 1, 1,
    )(col).astype(bool)
    if not (is_num | null).all():
        return None
    return np.where(null, np.nan, np.where(is_num, col, 0.0)).astype(np.float64)


def _like(col: np.ndarray, pattern: str) -> np.ndarray:
    rx = re.compile(
        "^"
        + "".join(".*" if c == "%" else "." if c == "_" else re.escape(c) for c in pattern)
        + "$"
    )
    f = np.frompyfunc(lambda v: v is not None and rx.match(str(v)) is not None, 1, 1)
    return f(col).astype(bool)


def _compare(a: np.ndarray, op: str, b: np.ndarray) -> np.ndarray:
    null = _isnull(a) | _isnull(b)
    if a.dtype == object or b.dtype == object:
        a = np.where(null, "", a).astype(object)
        b = np.where(null, "", b).astype(object)
    if op in ("=", "=="):
        out = a == b
    elif op in ("!=", "<>"):
        out = a != b
    elif op == "<":
        out = a < b
    elif op == ">":
        out = a > b
    elif op == "<=":
        out = a <= b
    else:
        out = a >= b
    return np.asarray(out, dtype=bool) & ~null  # SQL: comparisons with null are false


# ---------------------------------------------------------------------------
# Table
# ---------------------------------------------------------------------------


class Table:
    """Immutable host-side columnar table with the Spark DataFrame op set.

    Columns are NumPy arrays of equal length; string columns use
    ``dtype=object`` with ``None`` as SQL null (matching the Arrow read
    path). All ops return new ``Table`` objects; none mutate.
    """

    def __init__(self, columns: Mapping[str, np.ndarray] | None = None, **kw):
        cols = dict(columns or {}, **kw)
        self._cols: dict[str, np.ndarray] = {}
        n = None
        for name, values in cols.items():
            arr = _as_column(values)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"column {name!r} has length {len(arr)}, expected {n}"
                )
            self._cols[name] = arr
        self._n = n or 0

    # -- structure ----------------------------------------------------------

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    @property
    def schema(self) -> dict[str, np.dtype]:
        return {k: v.dtype for k, v in self._cols.items()}

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def __repr__(self) -> str:
        return f"Table[{self._n} x {len(self._cols)}: {', '.join(self._cols)}]"

    def _replace(self, cols: dict[str, np.ndarray]) -> "Table":
        t = Table.__new__(Table)
        t._cols = cols
        t._n = len(next(iter(cols.values()))) if cols else 0
        return t

    # -- the reference's op surface -----------------------------------------

    def count(self) -> int:
        """Row count (``Graphframes.py:18,:54,:85``)."""
        return self._n

    def with_column_renamed(self, existing: str, new: str) -> "Table":
        """``withColumnRenamed`` (``Graphframes.py:26-29``)."""
        if existing not in self._cols:
            return self  # Spark semantics: silently no-op on missing column
        if new in self._cols and new != existing:
            # Spark would produce duplicate column names; a dict cannot, and
            # silently dropping a column loses data — fail loudly instead.
            raise ValueError(f"cannot rename {existing!r}: column {new!r} already exists")
        return self._replace(
            {(new if k == existing else k): v for k, v in self._cols.items()}
        )

    def filter(self, cond: "str | np.ndarray | Callable[[Table], np.ndarray]") -> "Table":
        """Row filter: SQL predicate string (``Graphframes.py:30``), boolean
        mask, or callable over the table."""
        if isinstance(cond, str):
            mask = _PredicateParser(_tokenize(cond), self._cols, self._n).parse()
        elif callable(cond) and not isinstance(cond, np.ndarray):
            mask = np.asarray(cond(self), dtype=bool)
        else:
            mask = np.asarray(cond, dtype=bool)
        return self._replace({k: v[mask] for k, v in self._cols.items()})

    where = None  # assigned below (alias)

    def select(self, *names: str) -> "Table":
        """Column projection (``Graphframes.py:53,:70,:92``)."""
        flat: list[str] = []
        for n in names:
            flat.extend(n if isinstance(n, (list, tuple)) else [n])
        missing = [n for n in flat if n not in self._cols]
        if missing:
            raise KeyError(f"unknown columns {missing}; have {self.columns}")
        return self._replace({n: self._cols[n] for n in flat})

    def with_column(self, name: str, values) -> "Table":
        """``withColumn`` (``Graphframes.py:71-73``): add/replace a column.
        ``values`` may be an array or a vectorized fn of the table."""
        arr = values(self) if callable(values) else values
        arr = _as_column(arr)
        if len(arr) != self._n:
            raise ValueError(f"column {name!r} length {len(arr)} != {self._n}")
        cols = dict(self._cols)
        cols[name] = arr
        return self._replace(cols)

    def distinct(self) -> "Table":
        """Distinct rows (``Graphframes.py:53,:85,:92``). Order of first
        appearance is preserved (deterministic, unlike Spark)."""
        if not self._cols:
            return self
        keys = _row_keys(list(self._cols.values()))
        _, idx = np.unique(keys, return_index=True)
        idx.sort()
        return self._replace({k: v[idx] for k, v in self._cols.items()})

    def drop_duplicates(self, subset: Sequence[str] | None = None) -> "Table":
        if subset is None:
            return self.distinct()
        keys = _row_keys([self._cols[c] for c in subset])
        _, idx = np.unique(keys, return_index=True)
        idx.sort()
        return self._replace({k: v[idx] for k, v in self._cols.items()})

    def show(self, n: int = 20, truncate: int = 20) -> str:
        """Pretty-print the first ``n`` rows (``Graphframes.py:32`` etc.);
        returns the rendered string (also printed)."""
        names = self.columns
        rows = [
            [_render(self._cols[c][i], truncate) for c in names]
            for i in range(min(n, self._n))
        ]
        widths = [
            max(len(c), *(len(r[j]) for r in rows)) if rows else len(c)
            for j, c in enumerate(names)
        ]
        sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
        out = [sep, "|" + "|".join(f" {c:<{w}} " for c, w in zip(names, widths)) + "|", sep]
        for r in rows:
            out.append("|" + "|".join(f" {v:<{w}} " for v, w in zip(r, widths)) + "|")
        out.append(sep)
        if self._n > n:
            out.append(f"only showing top {n} rows")
        text = "\n".join(out)
        print(text)
        return text

    def persist(self) -> "Table":
        """Parity no-op: ops here are eager, so the materialize-once caching
        the reference needed (``Graphframes.py:82-83``) is automatic."""
        return self

    cache = persist

    def collect(self) -> list:
        """All rows as named tuples — the driver-gather boundary
        (``Graphframes.py:100-110``), here a plain host read."""
        Row = namedtuple("Row", [re.sub(r"\W", "_", c) for c in self.columns])
        cols = [self._cols[c] for c in self.columns]
        return [Row(*(c[i] for c in cols)) for i in range(self._n)]

    def to_dict(self) -> dict[str, np.ndarray]:
        return dict(self._cols)

    # -- the dead data-slicer's surface (Graphframes.py:34-47) ---------------

    def with_row_ids(self, name: str = "_row_id") -> "Table":
        """``monotonically_increasing_id`` analog: contiguous int64 row ids."""
        return self.with_column(name, np.arange(self._n, dtype=np.int64))

    monotonically_increasing_id = with_row_ids

    def sort(self, *by: str, ascending: "bool | Sequence[bool]" = True) -> "Table":
        """Stable multi-column sort; ``ascending`` may be one bool or one
        per key (Spark's list form). Nulls order first ascending / last
        descending (asc_nulls_first / desc_nulls_last defaults).

        Descending keys are implemented by inverting a dense rank rather
        than reversing the sorted order, so every key direction is stable
        (reversal would flip tie order)."""
        if isinstance(ascending, (list, tuple)):
            flags = [bool(a) for a in ascending]
            if len(flags) != len(by):
                raise ValueError(
                    f"ascending has {len(flags)} entries for {len(by)} sort keys"
                )
        else:
            flags = [bool(ascending)] * len(by)
        keys = []
        for c, asc_ in zip(reversed(by), reversed(flags)):
            col = self._cols[c]
            null = _isnull(col)
            if col.dtype == object:
                vals = np.where(null, "", col).astype(str)
            elif np.issubdtype(col.dtype, np.floating):
                vals = np.where(null, 0.0, col)
            else:
                vals = col
            if asc_:
                keys.append(vals)
                keys.append(~null)  # more significant than the value: nulls first
            else:
                _, inv = np.unique(vals, return_inverse=True)
                keys.append(-inv)  # inverted dense rank = descending, any dtype
                keys.append(null)  # nulls last
        order = np.lexsort(tuple(keys))
        return self._replace({k: v[order] for k, v in self._cols.items()})

    orderBy = None  # assigned below

    def limit(self, n: int) -> "Table":
        return self._replace({k: v[:n] for k, v in self._cols.items()})

    def subtract(self, other: "Table") -> "Table":
        """Rows of self not present in ``other`` (set difference)."""
        if self.columns != other.columns:
            raise ValueError("subtract requires identical schemas")
        mine = _row_keys(list(self._cols.values()))
        theirs = _row_keys([other._cols[c] for c in self.columns])
        mask = ~np.isin(mine, theirs)
        return self._replace({k: v[mask] for k, v in self._cols.items()})

    def union(self, other: "Table") -> "Table":
        if self.columns != other.columns:
            raise ValueError("union requires identical schemas")
        return self._replace(
            {k: np.concatenate([v, other._cols[k]]) for k, v in self._cols.items()}
        )

    # -- relational ops (Spark DataFrame surface beyond the reference) -------

    def drop(self, *names: str) -> "Table":
        """Drop columns; missing names are ignored (Spark semantics)."""
        t = self._replace({k: v for k, v in self._cols.items() if k not in names})
        t._n = self._n  # dropping every column must not collapse the row count
        return t

    def dropna(self, subset: Sequence[str] | None = None) -> "Table":
        """Drop rows with a null in any of ``subset`` (default: all columns)."""
        mask = np.ones(self._n, dtype=bool)
        for c in subset or self.columns:
            mask &= ~_isnull(self._cols[c])
        return self._replace({k: v[mask] for k, v in self._cols.items()})

    def fillna(self, value, subset: Sequence[str] | None = None) -> "Table":
        """Replace nulls with ``value`` in type-matching columns (Spark
        semantics: a string value fills only string columns, a number only
        numeric columns; other columns pass through unchanged)."""
        out = dict(self._cols)
        for name in subset or self.columns:
            col = out[name]
            null = _isnull(col)
            if not null.any():
                continue
            numeric_value = isinstance(value, (int, float)) and not isinstance(value, bool)
            if col.dtype == object and isinstance(value, str):
                if _object_as_float(col, null) is None:  # genuinely a string col
                    out[name] = np.where(null, value, col)
            elif np.issubdtype(col.dtype, np.floating) and numeric_value:
                out[name] = np.where(null, col.dtype.type(value), col)
            elif (col.dtype == object and numeric_value
                  and _object_as_float(col, null) is not None):
                # nullable-int columns (object-promoted by joins)
                out[name] = np.where(null, value, col)
        return self._replace(out)

    def join(self, other: "Table", on, how: str = "inner",
             suffix: str = "_r") -> "Table":
        """Equi-join with SQL null semantics (null keys never match).

        ``on`` is a key column name or list present on both sides; output
        has one copy of each key column (coalesced, Spark USING-clause
        semantics), then the remaining left columns, then the remaining
        right columns (renamed with ``suffix`` on collision). Row order:
        left rows in order (each repeated per match), then — for
        right/full joins — unmatched right rows. ``how``: inner, left,
        right, full/outer, left_semi, left_anti (Spark names; ``_outer``
        suffixes accepted)."""
        how = _JOIN_ALIASES.get(how.lower())
        if how is None:
            raise ValueError(
                f"unknown join type; supported: {sorted(set(_JOIN_ALIASES))}"
            )
        on = [on] if isinstance(on, str) else list(on)
        for c in on:
            if c not in self._cols or c not in other._cols:
                raise KeyError(f"join key {c!r} must exist on both sides")

        lnull = np.zeros(self._n, dtype=bool)
        rnull = np.zeros(other._n, dtype=bool)
        for c in on:
            lnull |= _isnull(self._cols[c])
            rnull |= _isnull(other._cols[c])
        lk_cols, rk_cols = [], []
        for c in on:  # coerce mixed int/float key pairs so 1 matches 1.0
            a, b = self._cols[c], other._cols[c]
            if a.dtype != b.dtype and all(
                np.issubdtype(x.dtype, np.number) for x in (a, b)
            ):
                a, b = a.astype(np.float64), b.astype(np.float64)
            lk_cols.append(a)
            rk_cols.append(b)
        lkeys = _row_keys(lk_cols) if on else None
        rkeys = _row_keys(rk_cols) if on else None

        if how == "cross":
            if on:
                raise ValueError("cross join takes no key columns")
            li = np.repeat(np.arange(self._n), other._n)
            ri = np.tile(np.arange(other._n), self._n)
            return self._join_emit(other, on, li, ri, suffix)
        if not on:
            raise ValueError("equi-join requires key columns; use how='cross'")

        r_order = np.argsort(rkeys, kind="stable")
        r_valid = r_order[~rnull[r_order]]  # null keys never match
        rk = rkeys[r_valid]
        lo = np.searchsorted(rk, lkeys, "left")
        hi = np.searchsorted(rk, lkeys, "right")
        cnt = np.where(lnull, 0, hi - lo)

        if how == "left_semi":
            return self.filter(cnt > 0)
        if how == "left_anti":
            return self.filter(cnt == 0)

        # One output row per match; left/full keep unmatched left rows as a
        # single null-padded row (ri = -1 sentinel), in left-row position.
        keep_unmatched_left = how in ("left", "full")
        cnt2 = np.maximum(cnt, 1) if keep_unmatched_left else cnt
        total = int(cnt2.sum())
        starts = (np.cumsum(cnt2) - cnt2).astype(np.int64)  # exclusive cumsum
        li = np.repeat(np.arange(self._n), cnt2)
        ri = np.full(total, -1, dtype=np.int64)
        has = np.repeat(cnt > 0, cnt2)
        pos = np.arange(total) - np.repeat(starts, cnt2)
        ri[has] = r_valid[np.repeat(lo, cnt2)[has] + pos[has]]

        if how in ("right", "full"):
            rmatched = np.zeros(other._n, dtype=bool)
            rmatched[ri[ri >= 0]] = True
            extra = np.flatnonzero(~rmatched)
            li = np.concatenate([li, np.full(len(extra), -1, dtype=np.int64)])
            ri = np.concatenate([ri, extra])
        return self._join_emit(other, on, li, ri, suffix)

    def _join_emit(self, other: "Table", on: list, li: np.ndarray,
                   ri: np.ndarray, suffix: str) -> "Table":
        cols: dict[str, np.ndarray] = {}
        for c in on:  # coalesced key columns (USING semantics)
            kl = _take_nullable(self._cols[c], li)
            if (li < 0).any():  # rows from the right side only (right/full)
                kr = _take_nullable(other._cols[c], ri)
                kl = np.where(li < 0, kr, kl)
            cols[c] = kl
        for c in self.columns:
            if c not in on:
                cols[c] = _take_nullable(self._cols[c], li)
        for c in other.columns:
            if c not in on:
                name = c + suffix if c in cols else c
                if name in cols:
                    raise ValueError(f"column collision after suffixing: {name!r}")
                cols[name] = _take_nullable(other._cols[c], ri)
        return self._replace(cols)

    def group_by(self, *names: str) -> "GroupedTable":
        """Group rows by key columns (null keys group together, as in SQL
        GROUP BY); with no keys, one global group (``df.agg`` semantics)."""
        flat: list[str] = []
        for n in names:
            flat.extend(n if isinstance(n, (list, tuple)) else [n])
        return GroupedTable(self, flat)

    def agg(self, *specs, **named) -> "Table":
        """Global aggregation over the whole table (one output row)."""
        return self.group_by().agg(*specs, **named)

    # -- bridges -------------------------------------------------------------

    def flat_map_distinct(self, *names: str) -> np.ndarray:
        """The reference's vertex-set idiom ``.rdd.flatMap(...).distinct()``
        (``Graphframes.py:53``), vectorized: union of the given columns'
        values with nulls dropped, sorted."""
        cols = [self._cols[n] for n in (names or self.columns)]
        stacked = np.concatenate([c[~_isnull(c)] for c in cols])
        return np.unique(stacked)

    def to_edge_table(self, src_col: str, dst_col: str, num_rows_raw: int | None = None):
        """Factorize two string/int columns into a dense-int32
        :class:`~graphmine_tpu_torch.io.edges.EdgeTable` — the device boundary.
        Replaces the sha1 UDF scheme (``Graphframes.py:57-74``); duplicate
        rows are kept, matching the reference.

        ``num_rows_raw``: the pre-null-filter row count for the EdgeTable's
        provenance field (this table cannot know how many rows an earlier
        ``filter`` removed); defaults to this table's current row count."""
        from graphmine_tpu_torch.io.edges import _from_string_columns

        return _from_string_columns(
            self._cols[src_col],
            self._cols[dst_col],
            num_rows_raw=self._n if num_rows_raw is None else num_rows_raw,
        )

    # -- io ------------------------------------------------------------------

    @classmethod
    def read_parquet(cls, path: str, columns: Sequence[str] | None = None) -> "Table":
        """Glob/dir/file parquet read (``Graphframes.py:16``)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        from graphmine_tpu_torch.io.edges import _resolve_paths

        paths = _resolve_paths(path)
        table = pa.concat_tables(
            [pq.read_table(p, columns=list(columns) if columns else None) for p in paths]
        )
        cols = {
            name: table.column(name).to_numpy(zero_copy_only=False)
            for name in table.column_names
        }
        return cls(cols)

    @classmethod
    def from_records(cls, rows: Iterable[Sequence], names: Sequence[str]) -> "Table":
        data = list(zip(*rows)) or [[] for _ in names]
        return cls({n: np.asarray(list(v)) for n, v in zip(names, data)})

    def write_parquet(self, path: str, compression: str = "snappy") -> None:
        """Write one parquet file; ``None`` stays a parquet null (so the
        reference's null-domain rows round-trip, ``Graphframes.py:30``)."""
        import pyarrow as pa
        import pyarrow.parquet as pq

        pq.write_table(pa.table(self._to_arrow_cols()), path,
                       compression=compression)

    def write_csv(self, path: str, header: bool = True) -> None:
        import pyarrow as pa
        import pyarrow.csv as pacsv

        pacsv.write_csv(
            pa.table(self._to_arrow_cols()), path,
            write_options=pacsv.WriteOptions(include_header=header),
        )

    def _to_arrow_cols(self) -> dict:
        import pyarrow as pa

        out = {}
        for name, col in self._cols.items():
            if col.dtype == object:
                out[name] = pa.array(col.tolist())  # None -> null
            else:
                out[name] = pa.array(col)
        return out

    @classmethod
    def read_csv(cls, path: str, header: bool = True, sep: str = ",",
                 infer_schema: bool = True) -> "Table":
        """CSV read (``spark.read.csv``); without a header row, columns are
        named ``_c0..`` as Spark does. ``infer_schema=False`` keeps every
        column as strings (Spark's CSV default)."""
        import pyarrow as pa
        import pyarrow.csv as pacsv

        opts = pacsv.ReadOptions(autogenerate_column_names=not header)
        table = pacsv.read_csv(
            path, read_options=opts,
            parse_options=pacsv.ParseOptions(delimiter=sep),
        )
        if not header:
            table = table.rename_columns(
                [f"_c{i}" for i in range(table.num_columns)]
            )
        if not infer_schema:
            table = pa.table({
                name: table.column(name).cast(pa.string())
                for name in table.column_names
            })
        return cls({
            name: table.column(name).to_numpy(zero_copy_only=False)
            for name in table.column_names
        })


# Spark join-type names (and their no-underscore forms) → canonical type.
_JOIN_ALIASES = {
    "inner": "inner", "cross": "cross",
    "left": "left", "leftouter": "left", "left_outer": "left",
    "right": "right", "rightouter": "right", "right_outer": "right",
    "full": "full", "outer": "full", "fullouter": "full", "full_outer": "full",
    "semi": "left_semi", "leftsemi": "left_semi", "left_semi": "left_semi",
    "anti": "left_anti", "leftanti": "left_anti", "left_anti": "left_anti",
}


class GroupedTable:
    """Result of :meth:`Table.group_by` — Spark ``GroupedData`` surface.

    Group order in every output is first appearance in the source table
    (deterministic, unlike Spark). Aggregates ignore nulls except
    ``count("*")``; an all-null group yields a null result cell."""

    _FNS = ("count", "sum", "min", "max", "mean", "avg", "first",
            "count_distinct", "collect_list", "collect_set")

    def __init__(self, table: Table, keys: list):
        self._t = table
        self._keys = keys
        n = len(table)
        if keys:
            rk = _row_keys([table[c] for c in keys])
            _, first_idx, inv = np.unique(rk, return_index=True, return_inverse=True)
            order = np.argsort(first_idx, kind="stable")
            rank = np.empty(len(order), dtype=np.int64)
            rank[order] = np.arange(len(order))
            self._gid = rank[inv]
            self._first = first_idx[order]
            self._ngroups = len(order)
        else:  # global aggregation: one group, even over an empty table
            self._gid = np.zeros(n, dtype=np.int64)
            self._first = np.zeros(0, dtype=np.int64)
            self._ngroups = 1

    def count(self) -> Table:
        """Rows per group, Spark ``groupBy(...).count()`` (counts nulls)."""
        if "count" in self._keys:
            raise ValueError("grouping key is named 'count'; use agg() to name the output")
        cols = {c: self._t[c][self._first] for c in self._keys}
        cols["count"] = np.bincount(self._gid, minlength=self._ngroups).astype(np.int64)
        return self._t._replace(cols)

    def agg(self, *specs, **named) -> Table:
        """Aggregate. Specs: Spark dict style ``{"col": "fn"}`` (output
        named ``fn(col)``), tuples ``("col", "fn")``, or kwargs
        ``out=("col", "fn")``. Fns: count, sum, min, max, mean/avg,
        first, count_distinct, collect_list, collect_set."""
        items: list[tuple[str, str, str]] = []  # (out_name, col, fn)
        for spec in specs:
            if isinstance(spec, Mapping):
                for col, fn in spec.items():
                    items.append((f"{fn}({col})", col, fn))
            elif isinstance(spec, (tuple, list)) and len(spec) == 2:
                col, fn = spec
                items.append((f"{fn}({col})", col, fn))
            else:
                raise TypeError(f"bad agg spec {spec!r}")
        for out, (col, fn) in named.items():
            items.append((out, col, fn))
        if not items:
            return self.count()
        cols = {c: self._t[c][self._first] for c in self._keys}
        for out, col, fn in items:
            if out in cols:
                raise ValueError(f"duplicate output column {out!r}")
            cols[out] = self._agg_one(col, fn.lower())
        return self._t._replace(cols)

    def _numeric_value_cols(self, names) -> list:
        if names:
            return list(names)
        return [c for c in self._t.columns
                if c not in self._keys and self._t[c].dtype != object]

    def sum(self, *cols) -> Table:
        return self.agg({c: "sum" for c in self._numeric_value_cols(cols)})

    def min(self, *cols) -> Table:
        return self.agg({c: "min" for c in self._numeric_value_cols(cols)})

    def max(self, *cols) -> Table:
        return self.agg({c: "max" for c in self._numeric_value_cols(cols)})

    def mean(self, *cols) -> Table:
        return self.agg({c: "mean" for c in self._numeric_value_cols(cols)})

    avg = mean

    def _agg_one(self, col_name: str, fn: str) -> np.ndarray:
        g, n = self._gid, self._ngroups
        if fn == "count" and col_name == "*":
            return np.bincount(g, minlength=n).astype(np.int64)
        col = self._t[col_name]
        null = _isnull(col)
        nonnull_per_group = np.bincount(g[~null], minlength=n).astype(np.int64)
        if fn == "count":
            return nonnull_per_group
        if fn in ("count_distinct", "countdistinct", "nunique"):
            m = ~null
            if not m.any():
                return np.zeros(n, dtype=np.int64)
            pk = _row_keys([g[m], col[m]])
            _, idx = np.unique(pk, return_index=True)
            return np.bincount(g[m][idx], minlength=n).astype(np.int64)
        if fn in ("sum", "mean", "avg"):
            if col.dtype == object:
                # nullable-int columns (object-promoted by joins) still sum
                num = _object_as_float(col, null)
                if num is None:
                    raise TypeError(f"{fn} on non-numeric column {col_name!r}")
                col = num
            empty = nonnull_per_group == 0
            if fn == "sum" and np.issubdtype(col.dtype, np.integer) and not empty.any():
                s_int = np.zeros(n, dtype=np.int64)  # exact above 2**53
                np.add.at(s_int, g, col.astype(np.int64))
                return s_int
            vals = np.where(null, 0, col).astype(np.float64)
            s = np.bincount(g, weights=vals, minlength=n)
            if fn == "sum":
                return np.where(empty, np.nan, s)  # null for all-null groups
            return np.where(empty, np.nan, s / np.maximum(nonnull_per_group, 1))
        if fn in ("min", "max"):
            return _segment_extreme(col, null, g, n, largest=fn == "max")
        if fn == "first":
            # First row of each group (Spark first(), ignoreNulls=False).
            if len(col) == 0:
                return np.full(n, None, dtype=object)
            first = self._first if len(self._first) else np.zeros(n, dtype=np.int64)
            return col[first]
        if fn in ("collect_list", "collect_set"):
            order = np.argsort(g[~null], kind="stable")
            vals, gs = col[~null][order], g[~null][order]
            bounds = np.concatenate([[0], np.cumsum(np.bincount(gs, minlength=n))])
            out = np.empty(n, dtype=object)
            for i in range(n):
                chunk = vals[bounds[i]:bounds[i + 1]].tolist()
                out[i] = list(dict.fromkeys(chunk)) if fn == "collect_set" else chunk
            return out
        raise ValueError(f"unknown aggregate {fn!r}; supported: {self._FNS}")


def _take_nullable(col: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Gather ``col[idx]`` where ``idx == -1`` yields SQL null (int/bool
    columns are promoted to object to hold ``None``)."""
    miss = idx < 0
    if len(col) == 0:  # gather from an empty side: every row is null
        if np.issubdtype(col.dtype, np.floating):
            return np.full(len(idx), np.nan, dtype=col.dtype)
        return np.full(len(idx), None, dtype=object)
    out = col[np.where(miss, 0, idx)]
    if not miss.any():
        return out
    if col.dtype == object:
        out = out.copy()
        out[miss] = None
    elif np.issubdtype(col.dtype, np.floating):
        out = out.copy()
        out[miss] = np.nan
    else:
        out = out.astype(object)
        out[miss] = None
    return out


def _segment_extreme(col: np.ndarray, null: np.ndarray, gid: np.ndarray,
                     n: int, largest: bool) -> np.ndarray:
    """Per-group min/max ignoring nulls, any dtype, via one lexsort.

    Ascending sort within each group with nulls pushed to the far end from
    the answer: min = group's first element, max = group's last."""
    if len(col) == 0:
        if col.dtype == object:
            return np.full(n, None, dtype=object)
        return np.full(n, np.nan, dtype=np.float64)
    if col.dtype == object:
        # nullable-int columns (object-promoted by joins) compare
        # numerically; genuine string columns compare lexicographically
        num = _object_as_float(col, null)
        if num is not None:
            vals = np.where(null, 0.0, num)
        else:
            vals = np.where(null, "", col).astype(str)
    else:
        vals = np.where(null, col[~null][0] if (~null).any() else 0, col)
    null_key = ~null if largest else null  # nulls first for max, last for min
    order = np.lexsort((vals, null_key, gid))
    gs = gid[order]
    starts = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1]])
    if largest:
        pick = np.r_[starts[1:] - 1, len(gs) - 1]
    else:
        pick = starts
    present = np.unique(gs)
    result = col[order[pick]]  # exact values in the column's own dtype
    res_null = null[order[pick]]
    if col.dtype == object:
        out = np.full(n, None, dtype=object)
        out[present] = np.where(res_null, None, result)
        return out
    if len(present) == n and not res_null.any():
        out = np.empty(n, dtype=col.dtype)  # no nulls: keep exact int dtype
        out[present] = result
        return out
    # all-null groups (or the keyless-empty case) become NaN
    out = np.full(n, np.nan, dtype=np.float64)
    out[present] = np.where(res_null, np.nan, result.astype(np.float64))
    return out


def _as_column(values) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype.kind in ("U", "S"):
        arr = arr.astype(object)
    if arr.ndim != 1:
        raise ValueError(f"columns must be 1-D, got shape {arr.shape}")
    return arr


def _row_keys(cols: list[np.ndarray]) -> np.ndarray:
    """Hashable per-row keys for distinct/subtract, vectorized.

    Values are escaped before joining so the delimiter (and the null
    sentinel) can never collide with data content."""
    if not cols or len(cols[0]) == 0:
        return np.empty(0, dtype="U1")
    parts = []
    for c in cols:
        s = np.char.replace(c.astype(str).astype("U"), "\\", "\\\\")
        s = np.char.replace(s, "\x1f", "\\u")
        s = np.where(_isnull(c), "\\0", s).astype(object)
        parts.append(s)
    out = parts[0]
    for p in parts[1:]:
        out = out + "\x1f" + p
    return out.astype(str)


def _render(v, truncate: int) -> str:
    s = "null" if v is None else str(v)
    return s if truncate <= 0 or len(s) <= truncate else s[: truncate - 3] + "..."


# Spark camelCase aliases (call-site parity for migrating code).
Table.withColumnRenamed = Table.with_column_renamed
Table.withColumn = Table.with_column
Table.where = Table.filter
Table.orderBy = Table.sort
Table.dropDuplicates = Table.drop_duplicates
Table.toDict = Table.to_dict
Table.groupBy = Table.group_by
Table.groupby = Table.group_by


def read_parquet(path: str, columns: Sequence[str] | None = None) -> Table:
    """Module-level alias of :meth:`Table.read_parquet`."""
    return Table.read_parquet(path, columns)
