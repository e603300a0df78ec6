"""Port parity for the IVF kNN (``ops/ann.py``) and the LOF policy that
picks it, against the JAX package (CPU).

- k-means centers agree within 1e-5 (measured: bit-equal) on a blob cloud;
- ``ivf_knn`` indices are equal, and distances too, on a blob cloud of
  integer coordinates: every squared distance is an integer below 2^24,
  exact in float32 in any order of summation, so the two packages cannot
  round a near-tie apart (on real-valued clouds the JAX matrix product and
  the port's feature-by-feature sums differ in the last bits);
- the same pathology guard trips on the same inputs, with an
  ``ivf_fallback`` record;
- recall >= 0.999 and |AUROC delta| <= 0.005 against the exact kNN (the
  JAX package's gates, ``tests/test_lof_policy.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from graphmine_tpu.ops import ann as jann
from graphmine_tpu.ops.knn import cross_knn as jcross_knn
from graphmine_tpu.ops.lof import lof_scores as jlof_scores
from graphmine_tpu.pipeline.metrics import MetricsSink as JMetricsSink

import torch

from graphmine_tpu_torch.ops import ann
from graphmine_tpu_torch.ops.knn import cross_knn, knn
from graphmine_tpu_torch.ops.lof import (
    LOF_IVF_MIN_POINTS,
    auroc,
    lof_from_knn,
    lof_scores,
    resolved_ivf_min_points,
    select_lof_impl,
)
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from _torch_threads import one_torch_thread  # noqa: F401


def _blob(n, f=8, seed=42):
    """The JAX LOF policy tests' clustered cloud with planted shell
    outliers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, f)).astype(np.float32) * 4
    assign = rng.integers(0, 16, n)
    pts = centers[assign] + rng.normal(size=(n, f)).astype(np.float32)
    is_out = rng.random(n) < 0.01
    n_out = int(is_out.sum())
    d = rng.normal(size=(n_out, f)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts[is_out] = centers[assign[is_out]] + d * rng.uniform(4.0, 6.0, (n_out, 1)).astype(np.float32)
    return pts, is_out


def _integer_blob(n, f=8, seed=5):
    rng = np.random.default_rng(seed)
    centers = rng.integers(150, 850, size=(16, f))
    assign = rng.integers(0, 16, n)
    return np.clip(centers[assign] + np.rint(rng.normal(scale=40, size=(n, f))),
                   0, 999).astype(np.float32)


@pytest.fixture(scope="module")
def blob():
    return _blob(6000)


def test_default_n_clusters_matches():
    for n in (10, 500, 6000, 131_072, 262_144, 10**7):
        assert ann.default_n_clusters(n) == jann.default_n_clusters(n)


def test_kmeans_centers_agree(blob):
    pts, _ = blob
    c = ann.default_n_clusters(len(pts))
    ref = np.asarray(jann.kmeans(pts, c, seed=3))
    got = ann.kmeans(torch.tensor(pts), c, seed=3).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_cross_knn_matches(blob):
    pts, _ = blob
    refs = pts[::37]
    d_ref, i_ref = jcross_knn(jnp.asarray(pts), jnp.asarray(refs), 9)
    d, i = cross_knn(torch.tensor(pts), torch.tensor(refs), 9)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=1e-4, atol=1e-4)


def test_ivf_knn_equal_on_an_exact_cloud():
    pts = _integer_blob(6000)
    d_ref, i_ref = jann.ivf_knn(pts, 32)
    sink = MetricsSink()
    d, i = ann.ivf_knn(torch.tensor(pts), 32, sink=sink)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    (index,) = sink.of_phase("ivf_index")
    assert index["n_clusters"] == 80 and index["pairs"] >= 6000 * 16
    assert not sink.of_phase("ivf_fallback")


def _guard_clouds():
    rng = np.random.default_rng(4)
    one_blob = np.zeros((4000, 4), np.float32)
    one_blob[:200] = rng.normal(size=(200, 4)) * 10
    return {
        # k above every k-means cluster's size
        "k_unfillable": (rng.normal(size=(64, 4)).astype(np.float32), 40, {}),
        # one dominant cluster: its sublists flood every probe of it
        "skew": (one_blob, 8, {"n_probe": 4}),
        # one probe per query, into clusters smaller than k + 1
        "capacity": (_blob(4000, f=4, seed=9)[0], 60, {"n_probe": 1}),
    }


@pytest.mark.parametrize("guard", ["k_unfillable", "skew", "capacity"])
def test_same_guard_trips(guard):
    pts, k, kw = _guard_clouds()[guard]
    jsink, sink = JMetricsSink(), MetricsSink()
    with pytest.warns(UserWarning, match=f"ivf_knn guard '{guard}'"):
        jd, ji = jann.ivf_knn(pts, k, sink=jsink, **kw)
    with pytest.warns(UserWarning, match=f"ivf_knn guard '{guard}'"):
        d, i = ann.ivf_knn(torch.tensor(pts), k, sink=sink, **kw)
    (jfb,), (fb,) = jsink.of_phase("ivf_fallback"), sink.of_phase("ivf_fallback")
    assert fb["guard"] == jfb["guard"] == guard and fb["detail"] == jfb["detail"]
    # the fallback is the exact kNN
    ed, ei = knn(torch.tensor(pts), k)
    np.testing.assert_array_equal(i.numpy(), ei.numpy())
    np.testing.assert_array_equal(d.numpy(), ed.numpy())


def test_recall_and_auroc_gates(blob):
    pts, is_out = blob
    k = 32
    t = torch.tensor(pts)
    ed, ei = knn(t, k)
    d, i = ann.ivf_knn(t, k)
    ei, i = ei.numpy(), i.numpy()
    recall = np.mean([len(set(ei[r]) & set(i[r])) / k for r in range(len(pts))])
    assert recall >= 0.999, recall
    a_exact = auroc(lof_from_knn(ed, torch.tensor(ei), k).numpy(), is_out)
    a_ivf = auroc(lof_from_knn(d, torch.tensor(i), k).numpy(), is_out)
    assert abs(a_exact - a_ivf) <= 0.005, (a_exact, a_ivf)
    assert a_ivf > 0.95


def test_ivf_is_deterministic_and_takes_pretrained_centers(blob):
    pts, _ = blob
    t = torch.tensor(pts)
    first, again = ann.ivf_knn(t, 16), ann.ivf_knn(t, 16)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    centers = ann.kmeans(t, ann.default_n_clusters(len(pts)))
    reused = ann.ivf_knn(t, 16, centers=centers.numpy())
    assert torch.equal(reused[1], first[1])
    with pytest.raises(ValueError, match="centers must be"):
        ann.ivf_knn(t, 16, centers=np.zeros((8, 3), np.float32))


def test_small_clouds_take_the_exact_path_quietly():
    pts = torch.tensor(_blob(100)[0])  # fewer than 4 * 8 clusters' worth
    sink = MetricsSink()
    d, i = ann.ivf_knn(pts, 5, n_clusters=32, sink=sink)
    assert not sink.records
    np.testing.assert_array_equal(i.numpy(), knn(pts, 5)[1].numpy())


def test_policy_and_env_override(monkeypatch):
    assert LOF_IVF_MIN_POINTS == 1 << 17
    assert resolved_ivf_min_points() == LOF_IVF_MIN_POINTS
    assert resolved_ivf_min_points(500) == 500
    monkeypatch.setenv("GRAPHMINE_LOF_IVF_MIN_N", "300")
    assert resolved_ivf_min_points() == 300
    assert select_lof_impl(1000, 16)[0] == "ivf"
    monkeypatch.setenv("GRAPHMINE_LOF_IVF_MIN_N", "5000")
    assert select_lof_impl(1000, 16)[0] == "exact"


def test_auto_lof_runs_ivf_like_the_jax_package(blob, monkeypatch):
    pts, _ = blob
    monkeypatch.setenv("GRAPHMINE_LOF_IVF_MIN_N", "5000")
    sink, jsink = MetricsSink(), JMetricsSink()
    got = lof_scores(torch.tensor(pts), k=32, sink=sink).numpy()
    ref = np.asarray(jlof_scores(pts, k=32, sink=jsink))
    (sel,) = sink.of_phase("impl_selected")
    assert sel["impl"] == "ivf" and sel["thresholds"] == {"lof_ivf_min_points": 5000}
    assert [r["impl"] for r in jsink.of_phase("impl_selected")] == ["ivf"]
    assert sink.of_phase("ivf_index") and not sink.of_phase("ivf_fallback")
    # near-ties round apart between the packages on this real-valued cloud
    close = np.abs(got - ref) <= 1e-4 * np.abs(ref)
    assert close.mean() >= 0.99, close.mean()
