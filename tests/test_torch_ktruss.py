"""Port parity: k-truss against the JAX package (CPU). The peel counts
integer triangle support, so the surviving edges are bit-equal."""

import importlib

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import ktruss as tk
from graphmine_tpu_torch.ops.triangles import triangle_count
from _torch_threads import one_torch_thread  # noqa: F401

jk = importlib.import_module("graphmine_tpu.ops.ktruss")


def _graphs(src, dst, v):
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    return (jbuild_graph(src, dst, num_vertices=v),
            build_graph(src, dst, num_vertices=v, device="cpu"))


def _random(seed, v, e):
    rng = np.random.default_rng(seed)
    return _graphs(rng.integers(0, v, e), rng.integers(0, v, e), v)


def _cliques():
    # K5 and K4 sharing a vertex, a triangle hanging off, a self-loop and
    # a duplicate
    k5 = [(a, b) for a in range(5) for b in range(a + 1, 5)]
    k4 = [(a, b) for a in range(4, 8) for b in range(a + 1, 8)]
    extra = [(7, 8), (8, 9), (9, 7), (3, 3), (0, 1)]
    s, d = zip(*(k5 + k4 + extra))
    return _graphs(s, d, 11)


GRAPHS = {
    "random": lambda: _random(0, 300, 3000),
    "dense": lambda: _random(1, 120, 2500),
    "cliques": _cliques,
    "no_triangles": lambda: _graphs([0, 1, 2, 3], [1, 2, 3, 4], 5),
}


@pytest.mark.parametrize("k", [2, 3, 4, 5, 6])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_k_truss_bit_equal(name, k):
    jg, g = GRAPHS[name]()
    (ja, jb), (a, b) = jk.k_truss(jg, k), tk.k_truss(g, k)
    assert a.dtype == np.int32 and b.dtype == np.int32
    assert np.array_equal(a, ja) and np.array_equal(b, jb)
    assert (a < b).all()


def test_k_below_two_raises():
    _, g = GRAPHS["cliques"]()
    with pytest.raises(ValueError, match="k must be >= 2"):
        tk.k_truss(g, 1)


def test_triangle_counts_unchanged_by_the_wedge_edge_ids():
    # the oriented CSR now also returns each wedge's edge ids; the
    # triangle counts it feeds stay the JAX package's
    from graphmine_tpu.ops.triangles import triangle_count as jtriangle_count

    jg, g = GRAPHS["random"]()
    (jt, jtotal), (t, total) = jtriangle_count(jg), triangle_count(g)
    assert np.array_equal(t.numpy(), np.asarray(jt)) and total == int(jtotal)
