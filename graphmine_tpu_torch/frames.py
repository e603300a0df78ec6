"""High-level ``GraphFrame`` API — the GraphFrames user's one-stop surface.

Counterpart of ``graphmine_tpu/frames.py`` over the PyTorch engine. The
reference drives everything through a GraphFrames ``GraphFrame``
(``GraphFrame(v, e)`` then ``.labelPropagation(maxIter=5)``); this
module gives a migrating user the same shaped object:

==============================  =======================================
GraphFrames                     graphmine_tpu_torch.frames.GraphFrame
==============================  =======================================
``GraphFrame(v_df, e_df)``      ``GraphFrame(v_table, e_table)``: an
                                ``id`` vertex column plus string/int
                                ``src``/``dst`` endpoints are factorized
                                to dense indices on the spot
``g.vertices / g.edges``        ``g.vertices / g.edges`` (dict of columns)
``g.degrees/inDegrees/...``     ``g.degrees()/in_degrees()/out_degrees()``
``g.labelPropagation(5)``       ``g.label_propagation(max_iter=5)``
``g.connectedComponents()``     ``g.connected_components()``
``g.stronglyConnectedComponents()``  ``g.strongly_connected_components()``
``g.pageRank(0.15, 20)``        ``g.pagerank(alpha=0.85, max_iter=20)``
``g.shortestPaths(landmarks)``  ``g.shortest_paths(landmarks)``
``g.triangleCount()``           ``g.triangle_count()``
``g.bfs(from, to)``             ``g.bfs(from_, to)``
``g.find(motif)``               ``g.find(motif)``
``g.aggregateMessages(...)``    ``g.aggregate_messages(...)``
``g.filterVertices(expr)``      ``g.filter_vertices(mask_or_fn)``
``g.filterEdges(expr)``         ``g.filter_edges(mask_or_fn)``
``g.dropIsolatedVertices()``    ``g.drop_isolated_vertices()``
==============================  =======================================

camelCase aliases are provided for every row above. Where GraphFrames
takes SQL expression strings, this API takes boolean masks or callables
over the column dict (host NumPy).

The frame holds its graphs as torch tensors on one device, CUDA unless
the caller names another (``GraphFrame(..., device="cpu")``), built on
first use and cached per ``(symmetric, weighted)``; every op runs on that
device and returns torch tensors there, where the JAX package returns
arrays (k-truss and link prediction return host arrays in both). The
vertex and edge columns stay host NumPy. Filtering re-indexes densely
and threads an ``"orig"`` vertex column through, so ids always map back
to the root frame.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping

import numpy as np

import torch

from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.graph.container import Graph, build_graph
from graphmine_tpu_torch.io.edges import EdgeTable
from graphmine_tpu_torch.table import Table

_MaskLike = Any  # bool array [N], int index array, or fn(columns) -> mask


def _endpoint_lookup(ids: np.ndarray):
    """id value → dense vertex index, vectorized via one sort; raises on
    duplicate ids or endpoints absent from ``ids``."""
    ids = np.asarray(ids)
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    if len(sorted_ids) > 1 and (sorted_ids[1:] == sorted_ids[:-1]).any():
        dup = sorted_ids[:-1][sorted_ids[1:] == sorted_ids[:-1]][:5]
        raise ValueError(f"duplicate vertex ids: {list(dup)!r}")

    def lookup(col: np.ndarray) -> np.ndarray:
        col = np.asarray(col)
        pos = np.clip(np.searchsorted(sorted_ids, col), 0, max(len(sorted_ids) - 1, 0))
        ok = sorted_ids[pos] == col if len(sorted_ids) else np.zeros(len(col), bool)
        if not np.all(ok):
            missing = col[~ok][:5]
            raise ValueError(
                f"edge endpoints not found in the vertex 'id' column: {list(missing)!r}"
            )
        return order[pos].astype(np.int32)

    return lookup


def _factorize_by_id(vertex_cols: Mapping, edge_cols: Mapping):
    """GraphFrames-style (vertices_df, edges_df) → dense-index columns.

    Vertex row ``i`` becomes vertex index ``i``; src/dst are re-written by
    looking endpoints up in the ``id`` column (string or int — replaces the
    reference's sha1 ``NodeHash`` join, ``Graphframes.py:57-74``). The
    ``id`` column is kept as a vertex attribute so results map back."""
    v = {k: np.asarray(c) for k, c in vertex_cols.items()}
    e = {k: np.asarray(c) for k, c in edge_cols.items()}
    look = _endpoint_lookup(v["id"])
    e["src"] = look(e["src"])
    e["dst"] = look(e["dst"])
    return e, v


class GraphFrame:
    """A property graph bound to the PyTorch engine on one device.

    Parameters
    ----------
    edges : ``(src, dst)`` int array pair, a mapping with ``"src"``/``"dst"``
        plus optional edge-attribute columns, or an
        :class:`~graphmine_tpu_torch.io.edges.EdgeTable`.
    vertices : optional mapping of vertex-attribute columns, each ``[V]``.
    num_vertices : optional; inferred from endpoints/columns otherwise.
    device : where the graphs live and the ops run; CUDA unless named.
    """

    def __init__(self, edges, vertices: Mapping[str, np.ndarray] | None = None,
                 num_vertices: int | None = None, device=None):
        self.device = resolve_device(device)
        if isinstance(edges, Table):
            edges = edges.to_dict()
        if isinstance(vertices, Table):
            vertices = vertices.to_dict()
        # GraphFrames positional shape — ``GraphFrame(vertices_df, edges_df)``
        # with an "id" vertex column and (possibly string) src/dst endpoints:
        # the reference's literal call site (``Graphframes.py:78``).
        if (
            isinstance(edges, Mapping) and "id" in edges and "src" not in edges
            and isinstance(vertices, Mapping) and "src" in vertices and "dst" in vertices
        ):
            edges, vertices = _factorize_by_id(vertex_cols=edges, edge_cols=vertices)
        if isinstance(edges, EdgeTable):
            if vertices is None:
                vertices = {"name": edges.names}
            edges = {"src": edges.src, "dst": edges.dst}
        if isinstance(edges, Mapping):
            cols = {k: np.asarray(v) for k, v in edges.items()}
            if "src" not in cols or "dst" not in cols:
                raise ValueError("edge mapping needs 'src' and 'dst' columns")
        else:
            src, dst = edges
            cols = {"src": np.asarray(src), "dst": np.asarray(dst)}
        if cols["src"].dtype.kind in "OUS":  # string endpoints, no vertex df:
            if vertices is not None and "id" in vertices:
                edges2, vertices = _factorize_by_id(vertex_cols=vertices, edge_cols=cols)
                cols = {k: np.asarray(v) for k, v in edges2.items()}
            else:  # factorize the union of endpoints into dense ids
                uniq = np.unique(np.concatenate([cols["src"], cols["dst"]]))
                look = _endpoint_lookup(uniq)
                cols = dict(cols, src=look(cols["src"]), dst=look(cols["dst"]))
                vertices = dict(vertices or {}, id=uniq)
        cols["src"] = cols["src"].astype(np.int32)
        cols["dst"] = cols["dst"].astype(np.int32)
        if len(cols["src"]) != len(cols["dst"]):
            raise ValueError("src/dst length mismatch")
        self.edges: dict[str, np.ndarray] = cols

        if num_vertices is None:
            hi = int(max(cols["src"].max(initial=-1), cols["dst"].max(initial=-1))) + 1
            if vertices is not None and vertices:
                hi = max(hi, max(len(np.asarray(c)) for c in vertices.values()))
            num_vertices = hi
        self.num_vertices = int(num_vertices)
        self.vertices: dict[str, np.ndarray] = (
            {k: np.asarray(v) for k, v in vertices.items()} if vertices else {}
        )
        for k, c in self.vertices.items():
            if len(c) != self.num_vertices:
                raise ValueError(f"vertex column {k!r} has length {len(c)}, want {self.num_vertices}")
        self.weight_col: str | None = "weight"  # set None to opt out
        self._graphs: dict = {}  # (symmetric, weighted) -> Graph
        self._tri = None  # cached ops.triangles._triangles result

    # -- engine binding ----------------------------------------------------

    @property
    def num_edges(self) -> int:
        return len(self.edges["src"])

    def edge_weights(self) -> np.ndarray | None:
        """The numeric ``weight`` edge column (GraphFrames convention), or
        None. Non-numeric 'weight' columns stay inert metadata; set
        ``self.weight_col`` to another name or ``None`` to opt out."""
        col = self.edges.get(self.weight_col) if self.weight_col else None
        if col is None or not np.issubdtype(np.asarray(col).dtype, np.number):
            return None
        return col

    def graph(self, symmetric: bool = True, weighted: bool = False) -> Graph:
        """The device-resident :class:`Graph` (cached per mode).

        ``weighted=True`` attaches :meth:`edge_weights` to the graph, as
        the weight-aware wrappers ask (louvain, leiden, modularity and
        ``label_propagation(weighted=True)``; LPA defaults to unweighted
        for GraphX parity)."""
        w = self.edge_weights() if weighted else None
        key = (symmetric, w is not None)
        if key not in self._graphs:
            self._graphs[key] = build_graph(
                self.edges["src"], self.edges["dst"],
                num_vertices=self.num_vertices, symmetric=symmetric,
                edge_weights=w, device=self.device,
            )
        return self._graphs[key]

    @classmethod
    def from_edge_table(cls, table: EdgeTable, device=None) -> "GraphFrame":
        return cls(table, device=device)

    def _tensor(self, values, dtype=torch.int32) -> torch.Tensor:
        """``values`` (a host array or a tensor) on the frame's device."""
        if torch.is_tensor(values):
            return values.to(self.device)
        return torch.as_tensor(np.asarray(values), device=self.device).to(dtype)

    def __repr__(self) -> str:
        vcols = list(self.vertices) or "-"
        ecols = [c for c in self.edges if c not in ("src", "dst")] or "-"
        return (
            f"GraphFrame(V={self.num_vertices}, E={self.num_edges}, "
            f"vertex_cols={vcols}, edge_cols={ecols}, device={self.device})"
        )

    # -- masks -------------------------------------------------------------

    def _vertex_mask(self, cond: _MaskLike) -> np.ndarray:
        return self._mask(cond, self.vertices, self.num_vertices)

    def _edge_mask(self, cond: _MaskLike) -> np.ndarray:
        return self._mask(cond, self.edges, self.num_edges)

    @staticmethod
    def _mask(cond, columns, n) -> np.ndarray:
        if callable(cond):
            cond = cond(columns)
        cond = np.asarray(cond)
        if cond.dtype == bool:
            if len(cond) != n:
                raise ValueError(f"mask length {len(cond)} != {n}")
            return cond
        mask = np.zeros(n, dtype=bool)
        mask[cond] = True
        return mask

    # -- degrees -----------------------------------------------------------

    def degrees(self):
        from graphmine_tpu_torch.ops.degrees import degrees
        return degrees(self.graph())

    def in_degrees(self):
        from graphmine_tpu_torch.ops.degrees import in_degrees
        return in_degrees(self.graph())

    def out_degrees(self):
        from graphmine_tpu_torch.ops.degrees import out_degrees
        return out_degrees(self.graph())

    # -- algorithms (GraphFrames parity) -----------------------------------

    def label_propagation(self, max_iter: int = 5, weighted: bool = False, **kw):
        """GraphX/GraphFrames parity: unweighted by default even when a
        'weight' column exists (their labelPropagation ignores weights).
        ``weighted=True`` opts into weight-sum LPA."""
        from graphmine_tpu_torch.ops.lpa import label_propagation
        max_iter = kw.pop("maxIter", max_iter)  # GraphFrames kwarg spelling
        return label_propagation(
            self.graph(weighted=weighted), max_iter=max_iter, **kw
        )

    def connected_components(self, **kw):
        from graphmine_tpu_torch.ops.cc import connected_components
        return connected_components(self.graph(), **kw)

    def strongly_connected_components(self):
        from graphmine_tpu_torch.ops.scc import strongly_connected_components
        return strongly_connected_components(self.graph(symmetric=False))

    def pagerank(self, alpha: float = 0.85, max_iter: int = 100, tol: float = 1e-6,
                 reset=None, weights=None, **kw):
        """``weights``: optional [E] non-negative edge weights aligned with
        the edge table order (rank splits across out-edges by weight);
        defaults to the numeric ``"weight"`` edge column when present.
        Note parallelPersonalizedPageRank is unweighted.

        GraphFrames kwarg spellings accepted: ``maxIter``,
        ``resetProbability`` (damping ``alpha = 1 - resetProbability``)."""
        from graphmine_tpu_torch.ops.pagerank import pagerank
        max_iter = kw.pop("maxIter", max_iter)
        if "resetProbability" in kw:
            alpha = 1.0 - kw.pop("resetProbability")
        unknown = sorted(set(kw) - {"plan", "sink"})
        if unknown:
            raise TypeError(f"unknown pagerank arguments: {unknown}")
        if weights is None:
            weights = self.edge_weights()
        return pagerank(self.graph(symmetric=False), alpha=alpha, max_iter=max_iter,
                        tol=tol, reset=reset, weights=weights, **kw)

    def shortest_paths(self, landmarks, direction: str = "out"):
        from graphmine_tpu_torch.ops.paths import shortest_paths
        g = self.graph(symmetric=direction == "both")
        return shortest_paths(g, landmarks, direction=direction)

    def _triangle_cache(self):
        from graphmine_tpu_torch.ops.triangles import _triangles
        if self._tri is None:
            self._tri = _triangles(self.graph())
        return self._tri

    def triangle_count(self):
        tri, total, _ = self._triangle_cache()
        return tri, total

    def bfs(self, from_: _MaskLike, to: _MaskLike, direction: str = "out",
            max_path_length: int = 10):
        """Shortest paths between vertex sets (GraphFrames ``bfs``).

        ``from_``/``to`` are boolean masks, id arrays, or callables over the
        vertex columns (the expression-string replacement).
        """
        from graphmine_tpu_torch.ops.paths import bfs
        src_ids = np.nonzero(self._vertex_mask(from_))[0]
        dst_ids = np.nonzero(self._vertex_mask(to))[0]
        g = self.graph(symmetric=direction == "both")
        return bfs(g, src_ids, dst_ids, direction=direction,
                   max_path_length=max_path_length)

    def find(self, pattern: str):
        from graphmine_tpu_torch.ops.motifs import find
        return find(self.graph(symmetric=False), pattern)

    def aggregate_messages(self, vertex_values, edge_values=None, *, to_dst=None,
                           to_src=None, reduce: str = "sum"):
        """Messages travel along directed edges; undirected flow is expressed
        by giving both ``to_dst`` and ``to_src`` (GraphFrames semantics)."""
        from graphmine_tpu_torch.ops.aggregate import aggregate_messages
        return aggregate_messages(self.graph(symmetric=False), vertex_values,
                                  edge_values, to_dst=to_dst, to_src=to_src,
                                  reduce=reduce)

    def pregel(self, init_state, **kw):
        from graphmine_tpu_torch.ops.aggregate import pregel
        return pregel(self.graph(symmetric=False), init_state, **kw)

    # -- subgraphs ---------------------------------------------------------

    def filter_vertices(self, cond: _MaskLike) -> "GraphFrame":
        """Induced subgraph on the vertices where ``cond`` holds.

        Ids are re-indexed densely; the ``"orig"`` vertex column maps back
        to ids of the frame this one was filtered from (threaded through
        repeated filters, so it always refers to the *root* frame).
        """
        keep = self._vertex_mask(cond)
        new_of_old = np.cumsum(keep, dtype=np.int64) - 1
        ekeep = keep[self.edges["src"]] & keep[self.edges["dst"]]
        edges = {k: c[ekeep] for k, c in self.edges.items()}
        edges["src"] = new_of_old[edges["src"]].astype(np.int32)
        edges["dst"] = new_of_old[edges["dst"]].astype(np.int32)
        vertices = {k: c[keep] for k, c in self.vertices.items()}
        if "orig" not in vertices:
            vertices["orig"] = np.nonzero(keep)[0].astype(np.int32)
        return GraphFrame(edges, vertices, num_vertices=int(keep.sum()), device=self.device)

    def filter_edges(self, cond: _MaskLike) -> "GraphFrame":
        """Same vertex set, only the edges where ``cond`` holds."""
        keep = self._edge_mask(cond)
        edges = {k: c[keep] for k, c in self.edges.items()}
        return GraphFrame(edges, dict(self.vertices), num_vertices=self.num_vertices,
                          device=self.device)

    def drop_isolated_vertices(self) -> "GraphFrame":
        present = np.zeros(self.num_vertices, dtype=bool)
        present[self.edges["src"]] = True
        present[self.edges["dst"]] = True
        return self.filter_vertices(present)

    # -- framework extras --------------------------------------------------

    def leiden(self, **kw):
        """Leiden-style refinement over Louvain: comparable modularity,
        guaranteed internally connected communities."""
        from graphmine_tpu_torch.ops.louvain import leiden
        return leiden(self.graph(weighted=True), **kw)

    def louvain(self, **kw):
        from graphmine_tpu_torch.ops.louvain import louvain
        return louvain(self.graph(weighted=True), **kw)

    def modularity(self, labels, **kw):
        from graphmine_tpu_torch.ops.modularity import modularity
        return modularity(self._tensor(labels), self.graph(weighted=True), **kw)

    def core_numbers(self, **kw):
        from graphmine_tpu_torch.ops.kcore import core_numbers
        return core_numbers(self.graph(), **kw)

    def hits(self, **kw):
        """HITS (hubs, authorities) on the directed edges — NetworkX parity."""
        from graphmine_tpu_torch.ops.centrality import hits
        return hits(self.graph(symmetric=False), **kw)

    def closeness_centrality(self, vertices=None, **kw):
        """Undirected closeness centrality (NetworkX parity); pass a
        landmark sample as ``vertices`` on large graphs."""
        from graphmine_tpu_torch.ops.centrality import closeness_centrality
        return closeness_centrality(self.graph(), vertices=vertices, **kw)

    def betweenness_centrality(self, sources=None, **kw):
        """Brandes betweenness (NetworkX parity); pass a source sample on
        large graphs for the standard approximation."""
        from graphmine_tpu_torch.ops.centrality import betweenness_centrality
        return betweenness_centrality(self.graph(), sources=sources, **kw)

    def eigenvector_centrality(self, **kw):
        from graphmine_tpu_torch.ops.centrality import eigenvector_centrality
        return eigenvector_centrality(self.graph(), **kw)

    def katz_centrality(self, alpha: float = 0.1, **kw):
        from graphmine_tpu_torch.ops.centrality import katz_centrality
        return katz_centrality(self.graph(), alpha=alpha, **kw)

    def maximal_independent_set(self, **kw):
        from graphmine_tpu_torch.ops.mis import maximal_independent_set
        return maximal_independent_set(self.graph(), **kw)

    def greedy_color(self, **kw):
        from graphmine_tpu_torch.ops.mis import greedy_color
        return greedy_color(self.graph(), **kw)

    def link_prediction(self, pairs, method: str = "jaccard"):
        from graphmine_tpu_torch.ops.linkpred import link_prediction
        return link_prediction(self.graph(), pairs, method=method)

    def k_truss(self, k: int):
        from graphmine_tpu_torch.ops.ktruss import k_truss
        return k_truss(self.graph(), k)

    def spectral_embedding(self, dim: int = 8, **kw):
        from graphmine_tpu_torch.ops.embedding import spectral_embedding
        return spectral_embedding(self.graph(), dim=dim, **kw)

    def clustering_coefficient(self):
        from graphmine_tpu_torch.ops.triangles import clustering_coefficient
        return clustering_coefficient(self.graph(), _cached=self._triangle_cache())

    def census(self, labels):
        from graphmine_tpu_torch.ops.census import census_table
        return census_table(self._tensor(labels), self.graph())

    def recursive_lpa_outliers(self, labels, **kw):
        from graphmine_tpu_torch.ops.outliers import recursive_lpa_outliers
        return recursive_lpa_outliers(self.graph(), self._tensor(labels), **kw)

    def lof_scores(self, labels=None, k: int = 20, **kw):
        """kNN+LOF outlier score per vertex from structural features;
        ``**kw`` goes to :func:`~graphmine_tpu_torch.ops.lof.lof_scores`,
        whose ``impl`` may also be given under the pipeline's name
        ``lof_impl`` (``"exact"`` runs the ``knn_topk`` kernel on CUDA)."""
        from graphmine_tpu_torch.ops.features import _vertex_features, standardize
        from graphmine_tpu_torch.ops.lof import lof_scores
        from graphmine_tpu_torch.ops.triangles import clustering_coefficient
        if "lof_impl" in kw:
            kw["impl"] = kw.pop("lof_impl")
        labels = self.label_propagation() if labels is None else self._tensor(labels)
        graph = self.graph()
        clust = clustering_coefficient(graph, _cached=self._triangle_cache())
        feats = standardize(_vertex_features(graph, labels, clust))
        return lof_scores(feats, k=k, **kw)

    def triplets(self):
        """GraphFrames ``triplets``: one row per edge with src/dst vertex
        attributes joined in (columns ``src``, ``dst``, then ``src_<attr>``
        / ``dst_<attr>`` for every vertex column)."""
        from graphmine_tpu_torch.table import Table

        src, dst = self.edges["src"], self.edges["dst"]
        cols = dict(self.edges)
        for name, vals in self.vertices.items():
            vals = np.asarray(vals)
            cols[f"src_{name}"] = vals[src]
            cols[f"dst_{name}"] = vals[dst]
        return Table(cols)

    def parallel_personalized_pagerank(self, sources, **kw):
        from graphmine_tpu_torch.ops.pagerank import parallel_personalized_pagerank
        return parallel_personalized_pagerank(self.graph(symmetric=False), sources, **kw)

    def svd_plus_plus(self, ratings, **kw):
        """Train SVD++ on this graph's edges with per-edge ``ratings``."""
        from graphmine_tpu_torch.ops.svdpp import svd_plus_plus
        return svd_plus_plus(
            self.edges["src"], self.edges["dst"], ratings,
            num_vertices=self.num_vertices, device=self.device, **kw,
        )

    def persist(self) -> "GraphFrame":
        """GraphFrames ``persist``/``cache`` parity: results here are eager
        and the frame caches its device graphs per mode, so this is the
        identity."""
        return self

    cache = persist

    def unpersist(self) -> "GraphFrame":
        """Drop the cached device graphs (frees device memory)."""
        self._graphs.clear()
        self._tri = None
        return self

    # -- GraphFrames camelCase aliases -------------------------------------

    labelPropagation = label_propagation
    connectedComponents = connected_components
    stronglyConnectedComponents = strongly_connected_components
    pageRank = pagerank
    shortestPaths = shortest_paths
    triangleCount = triangle_count
    aggregateMessages = aggregate_messages
    filterVertices = filter_vertices
    filterEdges = filter_edges
    dropIsolatedVertices = drop_isolated_vertices
    inDegrees = in_degrees
    outDegrees = out_degrees
    parallelPersonalizedPageRank = parallel_personalized_pagerank
    svdPlusPlus = svd_plus_plus
