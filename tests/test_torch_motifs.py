"""Port parity: motif finding against the JAX package (CPU), on the
patterns and graphs of ``tests/test_motifs.py``. The match tables (vertex
and edge columns, row order included) must be equal."""

import importlib

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import motifs
from _torch_threads import one_torch_thread  # noqa: F401

jmotifs = importlib.import_module("graphmine_tpu.ops.motifs")


def _random_edges(seed, e=40):
    rng = np.random.default_rng(seed)
    return list(zip(rng.integers(0, 12, e).tolist(), rng.integers(0, 12, e).tolist()))


CASES = [
    ([(0, 1), (1, 2), (1, 2), (2, 0)], "(a)-[e]->(b)"),
    ([(0, 1), (1, 2), (1, 3), (3, 0), (2, 2)], "(a)-[]->(b); (b)-[]->(c)"),
    ([(0, 1), (1, 2), (2, 0), (0, 2), (3, 0)], "(a)-[]->(b); (b)-[]->(c); (c)-[]->(a)"),
    ([(0, 1), (1, 0), (1, 2), (2, 3), (3, 2)], "(a)-[]->(b); !(b)-[]->(a)"),
    ([(0, 1), (0, 2), (1, 2)], "(a)-[]->()"),
    ([(0, 0), (0, 1), (1, 1)], "(a)-[]->(a)"),
    ([(0, 1), (2, 3)], "(a)-[]->(b); (c)-[]->(d)"),
    ([(0, 1), (2, 0), (3, 0)], "(a)-[]->(b); (c)-[]->(a)"),
    ([(0, 1), (1, 2)], "(a)-[]->(b); (b)-[]->(c); (c)-[]->(d)"),
    ([(0, 1)], "!()-[]->()"),
    ([], "!()-[]->()"),
    (_random_edges(0), "(x)-[]->(y); (y)-[]->(z)"),
    (_random_edges(1), "(x)-[e1]->(y); (y)-[e2]->(z); !(z)-[]->(x)"),
    (_random_edges(2), "(a)-[]->(b); (b)-[]->(a); !(a)-[]->()"),
]


@pytest.mark.parametrize("edges, pattern", CASES, ids=[f"{i}" for i in range(len(CASES))])
def test_find_equals_the_jax_package(edges, pattern):
    src = np.array([e[0] for e in edges], np.int32)
    dst = np.array([e[1] for e in edges], np.int32)
    v = int(max(src.max(initial=0), dst.max(initial=0))) + 2
    want = jmotifs.find(jbuild_graph(src, dst, num_vertices=v), pattern)
    got = motifs.find(build_graph(src, dst, num_vertices=v, device="cpu"), pattern)
    assert got.num_matches == want.num_matches == len(got)
    assert list(got.vertices) == list(want.vertices) and list(got.edges) == list(want.edges)
    for name in want.vertices:
        assert got.column(name).dtype == np.int32
        np.testing.assert_array_equal(got.column(name), want.column(name))
    for name in want.edges:
        np.testing.assert_array_equal(got.column(name), want.column(name))


@pytest.mark.parametrize("pattern", [
    "(a)->(b)", "!(a)-[e]->(b)", "!(a)-[]->(b)", "(a)-[a]->(b)",
    "(a)-[e]->(b); (b)-[e]->(c)", "",
])
def test_parse_errors_equal(pattern):
    with pytest.raises(ValueError) as want:
        jmotifs.parse_pattern(pattern)
    with pytest.raises(ValueError) as got:
        motifs.parse_pattern(pattern)
    assert str(got.value) == str(want.value)
