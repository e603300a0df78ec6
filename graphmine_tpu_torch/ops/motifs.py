"""Motif finding — the GraphFrames ``find()`` pattern DSL (host NumPy).

Counterpart of ``graphmine_tpu/ops/motifs.py``, a copy of its host code:
the JAX package runs motif search on the host too, as vectorized NumPy
sort/searchsorted joins over the edge table (duplicate edge rows yield
duplicate matches, and distinct names may bind the same vertex), so the
match tables are equal to the JAX package's row for row. Patterns:

    "(a)-[e]->(b); (b)-[e2]->(c); !(c)-[]->(a)"

- ``(a)-[e]->(b)``: an edge bound to name ``e`` from vertex ``a`` to ``b``;
- names may be omitted: ``(a)-[]->(b)``, ``(a)-[e]->()`` — anonymous
  elements constrain the match but produce no output column;
- ``!(...)``: negated term — no such edge may exist; it must use an
  anonymous edge, and its vertices must be bound by positive terms.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from graphmine_tpu_torch.graph.container import Graph

_TERM = re.compile(r"^(!?)\s*\(\s*(\w*)\s*\)\s*-\s*\[\s*(\w*)\s*\]\s*->\s*\(\s*(\w*)\s*\)$")


@dataclass(frozen=True)
class _Term:
    negated: bool
    a: str  # source vertex name ('' = anonymous)
    e: str  # edge name ('' = anonymous)
    b: str  # destination vertex name ('' = anonymous)


def parse_pattern(pattern: str) -> list[_Term]:
    """Parse the motif DSL into terms; raises ``ValueError`` on bad syntax."""
    terms = []
    for raw in pattern.split(";"):
        raw = raw.strip()
        if not raw:
            continue
        m = _TERM.match(raw)
        if m is None:
            raise ValueError(f"cannot parse motif term {raw!r}")
        neg, a, e, b = m.groups()
        if neg and e:
            raise ValueError(f"negated term {raw!r} cannot name its edge")
        terms.append(_Term(negated=bool(neg), a=a, e=e, b=b))
    if not terms:
        raise ValueError("empty motif pattern")
    vertex_names = {n for t in terms for n in (t.a, t.b) if n}
    edge_names = [t.e for t in terms if t.e]
    if vertex_names & set(edge_names):
        raise ValueError(
            f"names used for both a vertex and an edge: {vertex_names & set(edge_names)}"
        )
    if len(edge_names) != len(set(edge_names)):
        raise ValueError("each edge name may appear in only one term")
    pos_names = {n for t in terms if not t.negated for n in (t.a, t.b) if n}
    for t in terms:
        if t.negated:
            for n in (t.a, t.b):
                if n and n not in pos_names:
                    raise ValueError(
                        f"vertex {n!r} appears only in a negated term; bind it "
                        "in a positive term first"
                    )
    return terms


@dataclass
class MotifResult:
    """Match table: one row per motif occurrence.

    ``vertices[name]`` — int32 vertex ids ``[N]`` per named vertex;
    ``edges[name]`` — int64 edge-row indices ``[N]`` into ``graph.src/dst``
    per named edge.
    """

    vertices: dict
    edges: dict
    num_matches: int

    def __len__(self) -> int:
        return self.num_matches

    def column(self, name: str) -> np.ndarray:
        if name in self.vertices:
            return self.vertices[name]
        if name in self.edges:
            return self.edges[name]
        raise KeyError(name)


class _Joiner:
    """Edge table indexed for vectorized expand-joins."""

    def __init__(self, graph: Graph):
        self.src = graph.src.cpu().numpy().astype(np.int64)
        self.dst = graph.dst.cpu().numpy().astype(np.int64)
        self.v = graph.num_vertices
        self.e = len(self.src)
        # Sort indexes and the unique-edge-key table cost O(E log E) each;
        # built on first use — src-chained patterns never pay for the dst
        # index, and only negated terms need edge_keys.
        self._by_src = self._src_sorted = None
        self._by_dst = self._dst_sorted = None
        self._edge_keys = None

    @property
    def by_src(self):
        if self._by_src is None:
            self._by_src = np.argsort(self.src, kind="stable")
            self._src_sorted = self.src[self._by_src]
        return self._by_src

    @property
    def src_sorted(self):
        self.by_src
        return self._src_sorted

    @property
    def by_dst(self):
        if self._by_dst is None:
            self._by_dst = np.argsort(self.dst, kind="stable")
            self._dst_sorted = self.dst[self._by_dst]
        return self._by_dst

    @property
    def dst_sorted(self):
        self.by_dst
        return self._dst_sorted

    @property
    def edge_keys(self):
        if self._edge_keys is None:
            self._edge_keys = np.unique(self.src * self.v + self.dst)
        return self._edge_keys

    def expand(self, bound: np.ndarray, by: str):
        """For each bound endpoint value, enumerate matching edge rows.

        Returns ``(row_idx, edge_idx)``: ``row_idx`` repeats each input row
        once per matching edge; ``edge_idx`` is the matched edge row.
        """
        sorted_vals = self.src_sorted if by == "src" else self.dst_sorted
        order = self.by_src if by == "src" else self.by_dst
        start = np.searchsorted(sorted_vals, bound, side="left")
        stop = np.searchsorted(sorted_vals, bound, side="right")
        counts = stop - start
        row_idx = np.repeat(np.arange(len(bound)), counts)
        total = int(counts.sum())
        offsets = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        edge_idx = order[np.repeat(start, counts) + offsets]
        return row_idx, edge_idx

    def has_edge(self, a_vals: np.ndarray, b_vals: np.ndarray) -> np.ndarray:
        return np.isin(a_vals * self.v + b_vals, self.edge_keys, assume_unique=False)


def find(graph: Graph, pattern: str) -> MotifResult:
    """Find all occurrences of a structural motif (GraphFrames ``find``)."""
    terms = parse_pattern(pattern)
    jn = _Joiner(graph)

    # Binding table: columns -> int64 arrays of equal length. Vertex columns
    # hold vertex ids, edge columns edge-row indices. Anonymous elements get
    # fresh internal names (constrain the join, dropped from the output).
    cols: dict[str, np.ndarray] = {}
    n_rows = 1  # empty-pattern convention: one all-unbound row
    fresh = 0

    def take(idx):
        nonlocal cols
        cols = {k: v[idx] for k, v in cols.items()}

    for t in terms:
        if t.negated:
            continue  # applied after all positive terms
        a, b = t.a, t.b
        if not a:
            a, fresh = f"__anon{fresh}", fresh + 1
        if not b:
            b, fresh = f"__anon{fresh}", fresh + 1
        a_bound, b_bound = a in cols, b in cols
        if not cols:
            # first term: bind directly to the edge table
            edge_idx = np.arange(jn.e, dtype=np.int64)
            cols[a] = jn.src.copy()
            if b == a:
                keep = jn.dst == jn.src
                take(np.nonzero(keep)[0])
                edge_idx = edge_idx[keep]
            else:
                cols[b] = jn.dst.copy()
            if t.e:
                cols[t.e] = edge_idx
            n_rows = len(cols[a])
            continue
        if a_bound:
            row_idx, edge_idx = jn.expand(cols[a], by="src")
            take(row_idx)
            if b_bound or b == a:
                keep = jn.dst[edge_idx] == cols[b if b_bound else a]
                take(np.nonzero(keep)[0])
                edge_idx = edge_idx[keep]
            else:
                cols[b] = jn.dst[edge_idx]
        elif b_bound:
            row_idx, edge_idx = jn.expand(cols[b], by="dst")
            take(row_idx)
            cols[a] = jn.src[edge_idx]
        else:
            # cross join: every current row x every edge
            row_idx = np.repeat(np.arange(n_rows), jn.e)
            edge_idx = np.tile(np.arange(jn.e, dtype=np.int64), n_rows)
            take(row_idx)
            cols[a] = jn.src[edge_idx]
            if b == a:
                keep = jn.dst[edge_idx] == cols[a]
                take(np.nonzero(keep)[0])
                edge_idx = edge_idx[keep]
            else:
                cols[b] = jn.dst[edge_idx]
        if t.e:
            cols[t.e] = edge_idx
        n_rows = len(next(iter(cols.values())))

    for t in terms:
        if not t.negated:
            continue
        if n_rows == 0:
            break
        a_vals = cols[t.a] if t.a else None
        b_vals = cols[t.b] if t.b else None
        if a_vals is None and b_vals is None:
            # "no edge at all exists" — degenerate but well-defined
            exists = jn.e > 0
            keep = np.zeros(n_rows, bool) if exists else np.ones(n_rows, bool)
        elif a_vals is None:
            # no edge into b from anywhere
            keep = ~np.isin(b_vals, jn.dst)
        elif b_vals is None:
            keep = ~np.isin(a_vals, jn.src)
        else:
            keep = ~jn.has_edge(a_vals, b_vals)
        take(np.nonzero(keep)[0])
        # all-negated patterns have no binding columns; the row count is
        # carried by the mask itself
        n_rows = len(next(iter(cols.values()))) if cols else int(keep.sum())

    edge_names = {t.e for t in terms if t.e}
    vertices = {
        k: v.astype(np.int32)
        for k, v in cols.items()
        if not k.startswith("__anon") and k not in edge_names
    }
    edges = {k: cols[k] for k in edge_names if k in cols}
    return MotifResult(vertices=vertices, edges=edges, num_matches=n_rows)
