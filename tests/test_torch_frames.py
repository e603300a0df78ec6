"""Port parity: every ``GraphFrame`` method against the JAX package's
``GraphFrame`` (CPU), on the same columns.

Results come back as torch tensors in the port and as arrays in the JAX
package. Integers (labels, components, degrees, masks, colours, counts,
k-truss edges, motif rows, census) must be equal; floats within rtol 1e-5
/ atol 1e-6 (PageRank, the centralities, SVD++, the embedding per column
after sign alignment); LOF within rtol 1e-4 (its features round apart in
the last place on a near-tie, as in the pipeline parity tests). The
graphs hold several communities (a constant feature column standardizes
differently in the two packages, ROADMAP §3).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphmine_tpu.frames import GraphFrame as JGraphFrame
from graphmine_tpu.io.edges import EdgeTable as JEdgeTable
from graphmine_tpu.table import Table as JTable

from graphmine_tpu_torch.frames import GraphFrame
from graphmine_tpu_torch.io.edges import EdgeTable
from graphmine_tpu_torch.table import Table
from _torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def _host(x):
    if torch.is_tensor(x):
        return x.numpy()
    if isinstance(x, (tuple, list)):
        return [_host(y) for y in x]
    if dataclasses.is_dataclass(x):
        return {f.name: _host(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.asarray(x)
    return x


def _same(got, want, what="", rtol=RTOL, atol=ATOL):
    got, want = _host(got), _host(want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}", rtol, atol)
        return
    if isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]", rtol, atol)
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    if np.issubdtype(w.dtype, np.floating):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=what)
    else:
        assert np.array_equal(g, w), what


def _blocks(seed=0, blocks=4, size=40, p_in=0.25, p_out=0.01):
    rng = np.random.default_rng(seed)
    lab = np.repeat(np.arange(blocks), size)
    n = len(lab)
    a, b = np.where(rng.random((n, n)) < np.where(lab[:, None] == lab[None, :], p_in, p_out))
    keep = a != b
    src, dst = a[keep].astype(np.int32), b[keep].astype(np.int32)
    # a pendant chain and an isolated vertex past the blocks
    src = np.concatenate([src, [n, n + 1]]).astype(np.int32)
    dst = np.concatenate([dst, [n + 1, n + 2]]).astype(np.int32)
    w = (rng.integers(1, 9, len(src)) / 4).astype(np.float32)
    names = np.array([f"v{i}" for i in range(n + 4)], dtype=object)
    return {"src": src, "dst": dst, "weight": w}, {"name": names}, n + 4


@pytest.fixture(scope="module")
def frames():
    edges, vertices, v = _blocks()
    return (JGraphFrame(edges, vertices, num_vertices=v),
            GraphFrame(edges, vertices, num_vertices=v, device="cpu"))


CALLS = {
    "degrees": lambda g, J: g.degrees(),
    "in_degrees": lambda g, J: g.inDegrees(),
    "out_degrees": lambda g, J: g.outDegrees(),
    "label_propagation": lambda g, J: g.labelPropagation(maxIter=5),
    "label_propagation_weighted": lambda g, J: g.label_propagation(max_iter=4, weighted=True),
    "connected_components": lambda g, J: g.connectedComponents(),
    "strongly_connected_components": lambda g, J: g.stronglyConnectedComponents(),
    "pagerank": lambda g, J: g.pageRank(resetProbability=0.15, maxIter=30, tol=0.0),
    "pagerank_default": lambda g, J: g.pagerank(),
    "pagerank_unweighted_reset": lambda g, J: g.pagerank(
        weights=np.ones(g.num_edges, np.float32), reset=np.arange(g.num_vertices) % 3 == 0),
    "shortest_paths": lambda g, J: g.shortestPaths([0, 50, 163]),
    "shortest_paths_both": lambda g, J: g.shortest_paths([1, 161], direction="both"),
    "triangle_count": lambda g, J: list(g.triangleCount()),
    "bfs": lambda g, J: g.bfs(lambda c: c["name"] == "v0", [70, 120, 162]),
    "find": lambda g, J: (lambda r: {"n": r.num_matches, **r.vertices, **r.edges})(
        g.find("(a)-[e]->(b); (b)-[]->(a)")),
    "aggregate_messages": lambda g, J: g.aggregateMessages(
        (jnp if J else torch).arange(g.num_vertices, dtype=(jnp if J else torch).float32),
        to_dst=lambda s, d, e: s, to_src=lambda s, d, e: d, reduce="max"),
    "pregel": lambda g, J: g.pregel(
        (jnp if J else torch).arange(g.num_vertices, dtype=(jnp if J else torch).int32),
        to_dst=lambda s, d, e: s, reduce="min",
        update=jnp.minimum if J else torch.minimum, max_iter=4),
    "leiden": lambda g, J: list(g.leiden()),
    "louvain": lambda g, J: list(g.louvain()),
    "modularity": lambda g, J: g.modularity(np.arange(g.num_vertices) // 40),
    "core_numbers": lambda g, J: g.core_numbers(),
    "hits": lambda g, J: list(g.hits(tol=0.0, max_iter=25)),
    "closeness_centrality": lambda g, J: g.closeness_centrality(vertices=[0, 41, 99, 162]),
    "betweenness_centrality": lambda g, J: g.betweenness_centrality(),
    "betweenness_sampled": lambda g, J: g.betweenness_centrality(sources=[0, 5, 80],
                                                                 source_batch=2),
    "eigenvector_centrality": lambda g, J: g.eigenvector_centrality(tol=0.0, max_iter=60),
    "katz_centrality": lambda g, J: g.katz_centrality(alpha=0.02, tol=0.0, max_iter=60),
    "maximal_independent_set": lambda g, J: g.maximal_independent_set(seed=2),
    "greedy_color": lambda g, J: g.greedy_color(seed=1),
    "link_prediction": lambda g, J: [g.link_prediction([[0, 1], [5, 90], [160, 161]], method=m)
                                     for m in ("jaccard", "adamic_adar", "common_neighbors",
                                               "resource_allocation",
                                               "preferential_attachment")],
    "k_truss": lambda g, J: list(g.k_truss(4)),
    "clustering_coefficient": lambda g, J: g.clustering_coefficient(),
    "census": lambda g, J: list(g.census(np.arange(g.num_vertices) // 40)),
    "recursive_lpa_outliers": lambda g, J: g.recursive_lpa_outliers(
        np.arange(g.num_vertices) // 40, max_iter=3),
    "parallel_personalized_pagerank": lambda g, J: g.parallelPersonalizedPageRank(
        [0, 7, 150], max_iter=30, tol=0.0),
    "triplets": lambda g, J: g.triplets().to_dict(),
    "svd_plus_plus": lambda g, J: (lambda m, h: [h, m.p, m.q, m.y, m.bu, m.bi, m.mu])(
        *g.svdPlusPlus(np.arange(g.num_edges) % 5 + 1.0, rank=4, max_iter=8)),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_method_matches_jax(frames, name):
    jg, g = frames
    _same(CALLS[name](g, False), CALLS[name](jg, True), name)


def test_spectral_embedding_columns_align(frames):
    jg, g = frames
    want, got = np.asarray(jg.spectral_embedding(dim=3)), g.spectral_embedding(dim=3).numpy()
    cos = np.abs((want * got).sum(0)) / (np.linalg.norm(want, axis=0) * np.linalg.norm(got, axis=0))
    assert cos.min() >= 0.9999


@pytest.mark.parametrize("kw", [{"k": 10}, {"k": 15, "lof_impl": "exact"}], ids=["auto", "exact"])
def test_lof_scores(frames, kw):
    jg, g = frames
    jkw = {"k": kw["k"], "impl": "xla"} if "lof_impl" in kw else kw
    labels = np.arange(g.num_vertices) // 40
    _same(g.lof_scores(labels, **kw), jg.lof_scores(labels, **jkw), "lof", rtol=1e-4, atol=0)
    _same(g.lof_scores(**kw), jg.lof_scores(**jkw), "lof (LPA labels)", rtol=1e-4, atol=0)


@pytest.mark.parametrize("how", ["mask", "callable", "ids"])
def test_filters_reindex_and_thread_orig(frames, how):
    jg, g = frames
    keep = np.arange(g.num_vertices) % 3 != 1
    cond = {"mask": keep, "callable": lambda c: np.array([int(n[1:]) % 3 != 1 for n in c["name"]]),
            "ids": np.flatnonzero(keep)}[how]
    jsub, sub = jg.filter_vertices(cond), g.filterVertices(cond)
    assert sub.device == g.device and sub.num_vertices == jsub.num_vertices
    _same(sub.vertices, jsub.vertices, "vertices")
    _same(sub.edges, jsub.edges, "edges")
    jsub2, sub2 = jsub.filter_vertices(lambda c: c["orig"] > 30), sub.filter_vertices(
        lambda c: c["orig"] > 30)
    _same(sub2.vertices["orig"], jsub2.vertices["orig"], "orig threads to the root")
    _same(sub2.label_propagation(), jsub2.label_propagation(), "labels on the subgraph")
    je, e = jg.filterEdges(lambda c: c["weight"] > 1.0), g.filter_edges(lambda c: c["weight"] > 1.0)
    _same(e.edges, je.edges, "filtered edges")
    _same(e.pagerank(), je.pagerank(), "pagerank, filtered edges")
    _same(g.dropIsolatedVertices().vertices, jg.drop_isolated_vertices().vertices, "isolated")


def test_graphframes_positional_string_ids():
    ids = np.array(["a", "b", "c", "d"], dtype=object)
    e = {"src": np.array(["a", "b", "c", "a"], dtype=object),
         "dst": np.array(["b", "c", "a", "d"], dtype=object)}
    j, t = JGraphFrame({"id": ids}, e), GraphFrame({"id": ids}, e, device="cpu")
    _same(t.edges, j.edges, "edges")
    _same(t.label_propagation(), j.label_propagation(), "labels")
    # string endpoints without a vertex table factorize the union
    j2, t2 = JGraphFrame(e), GraphFrame(e, device="cpu")
    _same(t2.vertices, j2.vertices, "ids")
    _same(t2.connected_components(), j2.connected_components(), "cc")
    # Tables in, as the shim passes them
    j3 = JGraphFrame(JTable({"id": ids}), JTable(e))
    t3 = GraphFrame(Table({"id": ids}), Table(e), device="cpu")
    _same(t3.degrees(), j3.degrees(), "degrees from Tables")
    with pytest.raises(ValueError, match="not found"):
        GraphFrame({"id": ids[:2]}, e, device="cpu")


def test_from_edge_table_and_device():
    src, dst = np.array([0, 1, 2], np.int32), np.array([1, 2, 0], np.int32)
    names = np.array(["a.com", "b.com", "c.com"])
    g = GraphFrame.from_edge_table(EdgeTable(src=src, dst=dst, names=names), device="cpu")
    j = JGraphFrame.from_edge_table(JEdgeTable(src=src, dst=dst, names=names))
    _same(g.vertices, j.vertices, "names")
    assert g.graph().device.type == "cpu" and "device=cpu" in repr(g)
    assert g.graph() is g.graph() and g.persist() is g and g.cache() is g
    g.unpersist()
    assert not g._graphs
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            GraphFrame((src, dst))


def test_aliases_and_kwarg_spellings(frames):
    jg, g = frames
    for alias in ("labelPropagation", "connectedComponents", "stronglyConnectedComponents",
                  "pageRank", "shortestPaths", "triangleCount", "aggregateMessages",
                  "filterVertices", "filterEdges", "dropIsolatedVertices", "inDegrees",
                  "outDegrees", "parallelPersonalizedPageRank", "svdPlusPlus"):
        assert hasattr(g, alias) and hasattr(jg, alias), alias
    with pytest.raises(TypeError, match="unknown pagerank arguments"):
        g.pagerank(dampingFactor=0.8)
    g.weight_col = None
    try:
        assert g.edge_weights() is None
    finally:
        g.weight_col = "weight"
