"""Port parity: the spectral embedding against the JAX package (CPU).

Both start from the same draw (the port's copy of ``jax.random.normal``,
within 4 ulp) and run 60 rounds of deflated block power iteration with
a QR each; the columns are compared one by one after sign alignment:
|cos| >= 0.9999, on graphs whose top eigenvalues are apart (planted
blocks of distinct sizes)."""

import importlib

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph

from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import embedding as te
from _torch_threads import one_torch_thread  # noqa: F401

je = importlib.import_module("graphmine_tpu.ops.embedding")
MIN_COS = 0.9999


def _blocks(seed, sizes, p_in=0.3, p_out=0.01, isolated=0):
    rng = np.random.default_rng(seed)
    lab = np.repeat(np.arange(len(sizes)), sizes)
    v = len(lab) + isolated
    a, b = np.triu_indices(len(lab), 1)
    p = np.where(lab[a] == lab[b], p_in, p_out)
    keep = rng.random(len(a)) < p
    src, dst = a[keep].astype(np.int32), b[keep].astype(np.int32)
    return (jbuild_graph(src, dst, num_vertices=v),
            build_graph(src, dst, num_vertices=v, device="cpu"))


def _cos(a, b):
    return np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))


@pytest.mark.parametrize("dim", [2, 4])
@pytest.mark.parametrize("seed,sizes,isolated", [(0, (40, 60, 90, 130, 200), 0),
                                                 (1, (30, 50, 80, 120, 170), 5)])
def test_columns_align(seed, sizes, isolated, dim):
    jg, g = _blocks(seed, sizes, isolated=isolated)
    want = np.asarray(je.spectral_embedding(jg, dim=dim))
    got = te.spectral_embedding(g, dim=dim).numpy()
    assert got.shape == want.shape == (g.num_vertices, dim) and got.dtype == np.float32
    assert _cos(got, want).min() >= MIN_COS
    np.testing.assert_allclose(got.T @ got, np.eye(dim), atol=1e-4)
    if isolated:
        assert np.abs(got[-isolated:]).max() == 0.0


@pytest.mark.parametrize("seed", [0, 3])
def test_deterministic_for_a_seed(seed):
    jg, g = _blocks(2, (40, 70, 110, 160))
    a = te.spectral_embedding(g, dim=3, seed=seed).numpy()
    assert np.array_equal(a, te.spectral_embedding(g, dim=3, seed=seed).numpy())
    assert _cos(a, np.asarray(je.spectral_embedding(jg, dim=3, seed=seed))).min() >= MIN_COS


def test_refusals_match():
    jg, g = _blocks(3, (5, 6))
    for fn, graph in ((je.spectral_embedding, jg), (te.spectral_embedding, g)):
        with pytest.raises(ValueError, match="dim"):
            fn(graph, dim=11)
    dg = build_graph([0, 1], [1, 2], num_vertices=3, symmetric=False, device="cpu")
    with pytest.raises(ValueError, match="symmetric"):
        te.spectral_embedding(dg, dim=1)
