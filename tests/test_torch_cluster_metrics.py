"""Port parity: adjusted Rand index and NMI against the JAX package, on
the inputs of ``tests/test_cluster_metrics.py``. The port keeps a copy of
the same host float64 code: equal, for arrays and for tensors."""

import importlib

import numpy as np
import pytest
import torch

from graphmine_tpu_torch.ops import cluster_metrics as cm

jcm = importlib.import_module("graphmine_tpu.ops.cluster_metrics")


def _pairs():
    rng = np.random.default_rng(0)
    out = [(rng.integers(0, rng.integers(2, 9), 300), rng.integers(0, rng.integers(2, 9), 300))
           for _ in range(5)]
    a = rng.integers(0, 5, 200)
    out.append((a, rng.permutation(5)[a]))
    out.append((np.zeros(10, int), np.zeros(10, int)))
    out.append((np.arange(10), np.zeros(10, int)))
    n = 50_000
    rng = np.random.default_rng(4)
    out.append((np.arange(n) // 2, rng.permutation(n) // 2))
    return out


@pytest.mark.parametrize("average", ["arithmetic", "geometric", "min", "max"])
@pytest.mark.parametrize("i", range(len(_pairs())))
def test_metrics_equal_the_jax_package(i, average):
    a, b = _pairs()[i]
    assert cm.adjusted_rand_index(a, b) == jcm.adjusted_rand_index(a, b)
    assert cm.normalized_mutual_info(a, b, average) == jcm.normalized_mutual_info(a, b, average)
    ta, tb = torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b))
    assert cm.adjusted_rand_index(ta, tb) == jcm.adjusted_rand_index(a, b)


def test_errors_equal():
    with pytest.raises(ValueError, match="differ in length"):
        cm.adjusted_rand_index([0, 1], [0])
    with pytest.raises(ValueError, match="unknown average"):
        cm.normalized_mutual_info([0, 1], [1, 0], average="harmonic")
    assert cm.adjusted_rand_index([], []) == jcm.adjusted_rand_index([], []) == 1.0
