"""Port parity: HITS, eigenvector, Katz, betweenness and closeness
centrality against the JAX package (CPU).

Betweenness sums path counts and dependencies in float32 in message
order on both sides, and closeness sums integer distances: both are
bit-equal. The power iterations agree within rtol 1e-5 / atol 1e-7
(full reductions in another order), compared at a fixed iteration count
(``tol=0``) and at the defaults on graphs whose delta does not land near
``tol``.
"""

import importlib

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import centrality as tc

jc = importlib.import_module("graphmine_tpu.ops.centrality")
RTOL, ATOL = 1e-5, 1e-7


def _graphs(src, dst, v, symmetric):
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    return (jbuild_graph(src, dst, num_vertices=v, symmetric=symmetric),
            build_graph(src, dst, num_vertices=v, symmetric=symmetric, device="cpu"))


def _random(seed, v=300, e=1500, symmetric=True):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, v, e), rng.integers(0, v, e)
    return _graphs(src, dst, v, symmetric)


GRAPHS = {
    "random_sym": lambda: _random(0),
    "random_dir": lambda: _random(1, symmetric=False),
    # a path with a pendant star, a self-loop, a duplicate edge and two
    # isolated vertices
    "shapes": lambda: _graphs([0, 1, 2, 3, 3, 3, 3, 5, 0], [1, 2, 3, 4, 5, 6, 3, 6, 1], 9, True),
    "shapes_dir": lambda: _graphs([0, 1, 2, 3, 3, 3, 3, 5, 0], [1, 2, 3, 4, 5, 6, 3, 6, 1], 9,
                                  False),
}


def _close(want, got):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [{}, {"tol": 0.0, "max_iter": 20}], ids=["default", "fixed"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_hits(name, kw):
    jg, g = GRAPHS[name]()
    (jh, ja), (h, a) = jc.hits(jg, **kw), tc.hits(g, **kw)
    _close(jh, h)
    _close(ja, a)


@pytest.mark.parametrize("kw", [{}, {"tol": 0.0, "max_iter": 40}], ids=["default", "fixed"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_eigenvector(name, kw):
    jg, g = GRAPHS[name]()
    _close(jc.eigenvector_centrality(jg, **kw), tc.eigenvector_centrality(g, **kw))


@pytest.mark.parametrize("kw", [{"alpha": 0.02}, {"alpha": 0.05, "beta": 2.0, "tol": 0.0,
                                                  "max_iter": 50},
                                {"alpha": 0.02, "normalized": False}],
                         ids=["default", "fixed", "raw"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_katz(name, kw):
    jg, g = GRAPHS[name]()
    _close(jc.katz_centrality(jg, **kw), tc.katz_centrality(g, **kw))


@pytest.mark.parametrize("kw", [{}, {"normalized": False}, {"directed": False},
                                {"sources": [0, 3, 5, 8], "source_batch": 3},
                                {"source_batch": 1}],
                         ids=["exact", "raw", "undirected", "sampled", "batch1"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_betweenness_bit_equal(name, kw):
    jg, g = GRAPHS[name]()
    want = np.asarray(jc.betweenness_centrality(jg, **kw))
    got = tc.betweenness_centrality(g, **kw).numpy()
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_betweenness_over_a_mesh_names_a7():
    _, g = _random(2, v=20, e=40)
    with pytest.raises(NotImplementedError, match=r"A7b \(multi-device\)"):
        tc.betweenness_centrality(g, mesh=object())


@pytest.mark.parametrize("kw", [{}, {"wf_improved": False}, {"vertices": [0, 4, 8, 2]}],
                         ids=["all", "plain", "landmarks"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_closeness_bit_equal(name, kw):
    jg, g = GRAPHS[name]()
    want = np.asarray(jc.closeness_centrality(jg, **kw))
    got = tc.closeness_centrality(g, **kw).numpy()
    assert np.array_equal(got, want)
