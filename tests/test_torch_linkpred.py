"""Port parity: the five link-prediction scores against the JAX package
(CPU); both run the same host NumPy, so the scores are bit-equal."""

import importlib

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import linkpred as tl
from _torch_threads import one_torch_thread  # noqa: F401

jl = importlib.import_module("graphmine_tpu.ops.linkpred")


def _graphs(seed, v, e):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, v, e).astype(np.int32), rng.integers(0, v, e).astype(np.int32)
    return (jbuild_graph(src, dst, num_vertices=v),
            build_graph(src, dst, num_vertices=v, device="cpu"), rng)


def test_methods_match():
    assert tl._METHODS == jl._METHODS


@pytest.mark.parametrize("method", jl._METHODS)
@pytest.mark.parametrize("seed,v,e", [(0, 200, 1500), (1, 1000, 3000), (2, 50, 1200)])
def test_scores_bit_equal(method, seed, v, e):
    jg, g, rng = _graphs(seed, v, e)
    u = rng.integers(0, v, 2000)
    w = (u + rng.integers(1, v, 2000)) % v
    pairs = np.stack([u, w], axis=1)
    want, got = jl.link_prediction(jg, pairs, method), tl.link_prediction(g, pairs, method)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    # tuples in, the same scores
    assert np.array_equal(tl.link_prediction(g, [tuple(p) for p in pairs[:5]], method), want[:5])


def test_bad_inputs_raise_as_in_jax():
    jg, g, _ = _graphs(3, 20, 40)
    assert tl.link_prediction(g, np.zeros((0, 2))).shape == (0,)
    for bad, match in (([[0, 0]], "self-pairs"), ([[0, 20]], "out of range"),
                       ([[0, 1, 2]], r"\[P, 2\]")):
        with pytest.raises(ValueError, match=match):
            jl.link_prediction(jg, bad)
        with pytest.raises(ValueError, match=match):
            tl.link_prediction(g, bad)
    with pytest.raises(ValueError, match="unknown method"):
        tl.link_prediction(g, [[0, 1]], method="katz")
