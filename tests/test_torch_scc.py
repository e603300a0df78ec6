"""Port parity: strongly connected components against the JAX package
(CPU), on the inputs of ``tests/test_scc.py``. Both run the coloring
algorithm, so the labels (each SCC's representative vertex) must be
equal, and the partition must equal scipy's."""

import importlib

import numpy as np
import pytest
import torch

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops.cluster_metrics import adjusted_rand_index
from graphmine_tpu_torch.ops.scc import strongly_connected_components
from _torch_threads import one_torch_thread  # noqa: F401

jscc = importlib.import_module("graphmine_tpu.ops.scc")


def _random(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 60, 180), rng.integers(0, 60, 180), 60


CASES = {
    "two_cycles_with_bridge": lambda: ([0, 1, 2, 2, 3, 4], [1, 2, 0, 3, 4, 3], 6),
    "dag": lambda: ([0, 0, 1, 2], [1, 2, 3, 3], 4),
    "full_cycle": lambda: (list(range(7)), [(i + 1) % 7 for i in range(7)], 7),
    "nested_reach_order": lambda: ([0, 1, 2], [1, 2, 1], 3),
    "random_seed0": lambda: _random(0),
    "random_seed1": lambda: _random(1),
    "random_seed2": lambda: _random(2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scc_labels_equal_the_jax_package(case):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    src, dst, v = CASES[case]()
    src, dst = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    want = np.asarray(jscc.strongly_connected_components(
        jbuild_graph(src, dst, num_vertices=v)))
    got = strongly_connected_components(build_graph(src, dst, num_vertices=v, device="cpu"))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    m = coo_matrix((np.ones(len(src)), (src, dst)), shape=(v, v))
    _, oracle = connected_components(m, directed=True, connection="strong")
    assert adjusted_rand_index(got, oracle) == 1.0
