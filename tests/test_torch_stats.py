"""Port parity: graph statistics against the JAX package (CPU), on the
inputs of ``tests/test_stats.py``. Assortativity, reciprocity and density
are the same host float64 code: equal. Diameters are integers: equal,
the seeded double sweep included."""

import importlib

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import stats

jstats = importlib.import_module("graphmine_tpu.ops.stats")


def _random(seed, v=50, e=240):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, e).astype(np.int32)
    dst = rng.integers(0, v, e).astype(np.int32)
    keep = src != dst
    return src[keep], dst[keep], v


CASES = {
    "random_seed0": lambda: _random(0),
    "random_seed1": lambda: _random(1),
    "random_seed3": lambda: _random(3),
    "star": lambda: (np.zeros(5, np.int32), np.arange(1, 6, dtype=np.int32), 6),
    "path": lambda: (np.arange(9, dtype=np.int32), np.arange(1, 10, dtype=np.int32), 10),
    "padded_path": lambda: (np.arange(9, dtype=np.int32), np.arange(1, 10, dtype=np.int32),
                            60),
    "self_loop": lambda: (np.array([0, 1, 1], np.int32), np.array([1, 2, 1], np.int32), 3),
}


def _graphs(case, symmetric):
    src, dst, v = CASES[case]()
    return (jbuild_graph(src, dst, num_vertices=v, symmetric=symmetric),
            build_graph(src, dst, num_vertices=v, symmetric=symmetric, device="cpu"))


def _same(a, b):
    assert (np.isnan(a) and np.isnan(b)) or a == b, (a, b)


@pytest.mark.parametrize("case", sorted(CASES))
def test_closed_form_statistics_equal(case):
    jg, g = _graphs(case, True)
    _same(stats.degree_assortativity(g), jstats.degree_assortativity(jg))
    assert stats.density(g) == jstats.density(jg)
    with pytest.raises(ValueError, match="directed"):
        stats.reciprocity(g)
    jd, d = _graphs(case, False)
    _same(stats.reciprocity(d), jstats.reciprocity(jd))
    assert stats.density(d) == jstats.density(jd)
    assert stats.density(d, directed=False) == jstats.density(jd, directed=False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_diameter_equal(case):
    jg, g = _graphs(case, True)
    assert stats.diameter(g, exact=True) == jstats.diameter(jg, exact=True)
    for seed in range(3):
        assert stats.diameter(g, seed=seed) == jstats.diameter(jg, seed=seed)
