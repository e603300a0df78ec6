"""Port parity: the GraphX LabelPropagation oracle and its helpers (host
NumPy in both packages): bit-equal labels for every tie rule."""

import numpy as np
import pytest

from graphmine_tpu import oracle as jo
from graphmine_tpu_torch import oracle as to
from _torch_threads import one_torch_thread  # noqa: F401


def _edges(seed, v, e):
    rng = np.random.default_rng(seed)
    return rng.integers(0, v, e), rng.integers(0, v, e)


@pytest.mark.parametrize("tie", ["smallest", "largest", "hash_order", "random"])
@pytest.mark.parametrize("seed,v,e,iters", [(0, 200, 800, 5), (1, 1000, 2500, 3),
                                            (2, 30, 30, 0), (3, 500, 4000, 8)])
def test_graphx_label_propagation_bit_equal(tie, seed, v, e, iters):
    src, dst = _edges(seed, v, e)
    want = jo.graphx_label_propagation(src, dst, v, max_iter=iters, tie=tie, seed=seed)
    got = to.graphx_label_propagation(src, dst, v, max_iter=iters, tie=tie, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_canonical_partition_and_hash_order(seed):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 50, 400)
    assert np.array_equal(to.canonical_partition(labels), jo.canonical_partition(labels))
    ids = rng.integers(-2**40, 2**40, 1000)
    assert np.array_equal(to.scala_trie_order_key(ids), jo.scala_trie_order_key(ids))
    assert np.array_equal(to._scala_improve(ids.astype(np.uint32)),
                          jo._scala_improve(ids.astype(np.uint32)))


def test_smallest_tie_rule_is_the_engines():
    # the port's LPA (smallest-label ties) equals the oracle's "smallest"
    import torch

    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.lpa import label_propagation

    src, dst = _edges(4, 300, 1200)
    g = build_graph(src, dst, num_vertices=300, device="cpu")
    got = label_propagation(g, max_iter=5).numpy()
    want = to.graphx_label_propagation(src, dst, 300, max_iter=5, tie="smallest")
    assert np.array_equal(got.astype(np.int64), want)
    assert isinstance(got, np.ndarray) and torch.is_tensor(label_propagation(g, 1))


def test_unknown_tie_rule_raises():
    with pytest.raises(ValueError, match="tie rule"):
        to.graphx_label_propagation([0], [1], 2, max_iter=1, tie="first")
