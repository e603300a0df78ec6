"""Port parity: triangle counts (exact), clustering coefficients and the
eight LOF feature columns (float32, rtol 1e-5: the same formulas, with
log1p and divisions rounded by another library)."""

import jax.numpy as jnp
import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.ops import triangles as jtri
from graphmine_tpu.ops.features import standardize as jstandardize
from graphmine_tpu.ops.features import vertex_features as jvertex_features
from graphmine_tpu.ops.lpa import label_propagation as jlabel_propagation

import torch

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.graph.container import build_graph
from graphmine_tpu_torch.ops import triangles
from graphmine_tpu_torch.ops.features import standardize, vertex_features
from _torch_threads import one_torch_thread  # noqa: F401

CPU = "cpu"


def _graph(name):
    if name == "planted":
        src, dst, _, _ = datasets.planted_anomaly_graph(1024, 12_000, seed=3)
        return src, dst, 1024
    src, dst, _ = datasets.sbm([60, 90, 150], 0.12, 0.01, seed=7)
    return src, dst, 300


@pytest.mark.parametrize("name", ["planted", "sbm"])
def test_triangles_exact(name):
    src, dst, v = _graph(name)
    jg = jbuild_graph(src, dst, num_vertices=v)
    tg = build_graph(src, dst, num_vertices=v, device=CPU)
    jt, jtotal = jtri.triangle_count(jg)
    tt, ttotal = triangles.triangle_count(tg)
    assert ttotal == int(jtotal) > 0
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert triangles.oriented_wedge_count(tg) == jtri.oriented_wedge_count(jg)
    np.testing.assert_allclose(triangles.clustering_coefficient(tg).numpy(),
                               np.asarray(jtri.clustering_coefficient(jg)), rtol=1e-6)
    np.testing.assert_array_equal(
        triangles.sampled_clustering_coefficient(tg, samples=32, seed=5),
        jtri.sampled_clustering_coefficient(jg, samples=32, seed=5),
    )


@pytest.mark.parametrize("clustering", [True, "sampled", False])
def test_vertex_features_match(clustering):
    src, dst, v = _graph("planted")
    jg = jbuild_graph(src, dst, num_vertices=v)
    comm = np.asarray(jlabel_propagation(jg, max_iter=5, plan=None))
    ref = np.asarray(jvertex_features(jg, jnp.asarray(comm), include_clustering=clustering))
    tg = build_graph(src, dst, num_vertices=v, device=CPU)
    got = vertex_features(tg, torch.tensor(comm), include_clustering=clustering)
    assert got.shape == (v, 8) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(standardize(got).numpy(), np.asarray(jstandardize(jnp.asarray(ref))),
                               rtol=1e-5, atol=1e-5)


def test_features_reject_unknown_clustering_mode():
    src, dst, v = _graph("sbm")
    tg = build_graph(src, dst, num_vertices=v, device=CPU)
    with pytest.raises(ValueError, match="include_clustering"):
        vertex_features(tg, torch.zeros(v, dtype=torch.int32), include_clustering="sample")
