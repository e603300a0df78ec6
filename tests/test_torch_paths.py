"""Port parity: BFS, shortest paths and BFS paths against the JAX package
(CPU), on the inputs of ``tests/test_bfs_paths.py``,
``tests/test_graph_ops.py`` (BFS, landmarks) and
``tests/test_cluster_metrics.py`` (weighted shortest paths).

Distances and parents are integers (or float minima, exact in any
order): they must be equal, UNREACHABLE and inf included.
"""

import importlib

import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import paths
from _torch_threads import one_torch_thread  # noqa: F401

jpaths = importlib.import_module("graphmine_tpu.ops.paths")


def _graphs(src, dst, v, symmetric=True):
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    return (jbuild_graph(src, dst, num_vertices=v, symmetric=symmetric),
            build_graph(src, dst, num_vertices=v, symmetric=symmetric, device="cpu"))


def _chain():
    # 0->1->2->3->4 chain plus shortcut 0->3, and 5 isolated
    return _graphs([0, 1, 2, 3, 0], [1, 2, 3, 4, 3], 6)


def _random(seed, v, e, symmetric=True):
    rng = np.random.default_rng(seed)
    return _graphs(rng.integers(0, v, e), rng.integers(0, v, e), v, symmetric)


GRAPHS = {
    "chain": _chain,
    "random_60_150": lambda: _random(0, 60, 150),
    "random_50_120": lambda: _random(1, 50, 120),
    "random_directed": lambda: _random(2, 80, 200, symmetric=False),
}


def test_unreachable_is_the_jax_sentinel():
    assert paths.UNREACHABLE == int(jpaths.UNREACHABLE)


@pytest.mark.parametrize("direction", ["out", "both"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_distances_and_parents(name, direction):
    jg, g = GRAPHS[name]()
    if direction == "both" and not g.symmetric:
        with pytest.raises(ValueError, match="symmetric"):
            paths.bfs_distances(g, [0], direction="both")
        return
    for sources, depth in (([0], 0), ([4, 7 % g.num_vertices], 0), ([1], 2)):
        want = np.asarray(jpaths.bfs_distances(jg, np.array(sources), direction=direction,
                                               max_depth=depth))
        got = paths.bfs_distances(g, np.array(sources), direction=direction, max_depth=depth)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        jd, jp = jpaths.bfs_parents(jg, np.array(sources), direction=direction, max_depth=depth)
        d, p = paths.bfs_parents(g, np.array(sources), direction=direction, max_depth=depth)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))


@pytest.mark.parametrize("batch", [1, 2, 16])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_shortest_paths_landmark_tiles(name, batch):
    jg, g = GRAPHS[name]()
    landmarks = [2, 5, 0] if g.num_vertices < 10 else [2, 11, 29, 7, 40]
    want = np.asarray(jpaths.shortest_paths(jg, landmarks, landmark_batch=batch))
    got = paths.shortest_paths(g, landmarks, landmark_batch=batch)
    assert got.shape == (g.num_vertices, len(landmarks)) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", [
    ([0], [4], "out", 10), ([0], [3, 4], "out", 10), ([0], [5], "out", 10),
    ([1], [4], "out", 2), ([1], [4], "out", 3), ([2, 0], [2], "out", 10),
    ([4], [0], "both", 10),
])
def test_bfs_paths_equal(case):
    jg, g = _chain()
    src, dst, direction, max_len = case
    want = jpaths.bfs(jg, src, dst, direction=direction, max_path_length=max_len)
    got = paths.bfs(g, src, dst, direction=direction, max_path_length=max_len)
    assert [p.tolist() for p in got] == [p.tolist() for p in want]
    assert all(p.dtype == np.int32 for p in got)


@pytest.mark.parametrize("direction", ["out", "both"])
def test_weighted_shortest_paths(direction):
    rng = np.random.default_rng(2)
    v, e = 40, 160
    src, dst = rng.integers(0, v, e), rng.integers(0, v, e)
    w = rng.uniform(0.1, 5.0, e).astype(np.float32)
    jg, g = _graphs(src, dst, v)
    for sources in ([0], [3, 17]):
        want = np.asarray(jpaths.weighted_shortest_paths(jg, np.array(sources), w,
                                                         direction=direction))
        got = paths.weighted_shortest_paths(g, np.array(sources), w, direction=direction)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_weighted_shortest_paths_rejects_nan():
    _, g = _graphs([0], [1], 2)
    with pytest.raises(ValueError, match="NaN"):
        paths.weighted_shortest_paths(g, np.array([0]), np.array([np.nan], np.float32))
    with pytest.raises(ValueError, match="direction"):
        paths.weighted_shortest_paths(g, np.array([0]), np.array([1.0]), direction="in")
