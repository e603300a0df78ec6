"""Port parity: degrees and k-core against the JAX package (CPU), on the
inputs of ``tests/test_graph_ops.py``. Integer outputs must be equal;
``out_weights`` sums float weights in message order on both sides and is
equal too."""

import importlib

import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import degrees, kcore

jdegrees = importlib.import_module("graphmine_tpu.ops.degrees")
jkcore = importlib.import_module("graphmine_tpu.ops.kcore")


def _random(seed, v, e):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, e).astype(np.int32), rng.integers(0, v, e).astype(np.int32), v)


def _clique_plus_tail():
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3), (3, 4)]
    src, dst = np.array(edges, np.int32).T
    return src, dst, 6


CASES = {
    "random_40_160": lambda: _random(0, 40, 160),
    "random_60_400": lambda: _random(1, 60, 400),
    "clique_plus_tail": _clique_plus_tail,
    "self_loops_only": lambda: (np.array([0, 1], np.int32), np.array([0, 1], np.int32), 3),
}


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_degree_views_equal(case, symmetric):
    src, dst, v = CASES[case]()
    w = np.random.default_rng(5).uniform(0.1, 3.0, len(src)).astype(np.float32)
    for weights in (None, w):
        jg = jbuild_graph(src, dst, num_vertices=v, symmetric=symmetric, edge_weights=weights)
        g = build_graph(src, dst, num_vertices=v, symmetric=symmetric, edge_weights=weights,
                        device="cpu")
        for name in ("degrees", "in_degrees", "out_degrees"):
            got = getattr(degrees, name)(g)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jdegrees, name)(jg)))
        got = degrees.out_weights(g)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jdegrees.out_weights(jg)))


@pytest.mark.parametrize("max_iter", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_core_numbers_equal(case, max_iter):
    src, dst, v = CASES[case]()
    want = np.asarray(jkcore.core_numbers(jbuild_graph(src, dst, num_vertices=v),
                                          max_iter=max_iter))
    got = kcore.core_numbers(build_graph(src, dst, num_vertices=v, device="cpu"),
                             max_iter=max_iter)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_core_numbers_of_an_edgeless_graph():
    g = build_graph(np.array([], np.int32), np.array([], np.int32), num_vertices=4,
                    device="cpu")
    assert kcore.core_numbers(g).tolist() == [0, 0, 0, 0]
