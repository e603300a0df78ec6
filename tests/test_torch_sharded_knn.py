"""The ring-sharded kNN and LOF: the port on a ``[cpu] * D`` virtual mesh
against the JAX package's on its own virtual CPU mesh (D = 2 and 4).

Distances agree within rtol 1e-5 (the JAX hop is a matrix product, the
port's a feature-by-feature float32 sum) and indices are equal on
tie-free clouds; with exact duplicates the distances still agree and the
ids are valid and never the point itself. The ring equals the port's own
one-device kNN on indices and distances. The IVF search split over the
mesh is bit-equal to the one-device index; LOF is within the pipeline
tests' tolerance of JAX's.
"""

import numpy as np
import pytest
import torch

from graphmine_tpu.parallel import knn as jk
from graphmine_tpu.parallel.mesh import make_mesh as jmake_mesh

from graphmine_tpu_torch.ops.knn import cross_knn, knn
from graphmine_tpu_torch.ops.lof import lof_scores
from graphmine_tpu_torch.parallel import knn as tk
from graphmine_tpu_torch.parallel.mesh import make_mesh
from graphmine_tpu_torch.pipeline.metrics import MetricsSink

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def virtual_devices():
    """An 8-shard virtual CPU mesh, and one intra-op thread: the shard
    bodies are many small ops, whose thread pools would otherwise
    oversubscribe the cores the other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAPHMINE_VIRTUAL_DEVICES", "8")
        yield
    torch.set_num_threads(threads)


def meshes(d):
    return jmake_mesh(d), make_mesh(d, devices=[CPU] * d)


def _blobs(seed, n):
    r = np.random.default_rng(seed)
    c = r.normal(size=(8, 8)).astype(np.float32) * 3
    return (c[r.integers(0, 8, n)] + r.normal(size=(n, 8))).astype(np.float32)


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("n,f,k", [(401, 8, 5), (1000, 16, 32), (257, 4, 3)])
def test_sharded_knn_matches_jax_and_one_device(d, n, f, k):
    pts = np.random.default_rng(n + f).normal(size=(n, f)).astype(np.float32)
    jm, tm = meshes(d)
    jd, ji = jk.sharded_knn(pts, jm, k=k, row_tile=64)
    td, ti = tk.sharded_knn(pts, tm, k=k, row_tile=64)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    od, oi = knn(torch.from_numpy(pts), k)
    np.testing.assert_array_equal(td.numpy(), od.numpy())
    np.testing.assert_array_equal(ti.numpy(), oi.numpy())


def test_duplicates_and_a_ragged_n():
    r = np.random.default_rng(0)
    base = r.normal(size=(61, 6)).astype(np.float32)
    pts = np.concatenate([base, base[:10]])  # 71 rows, 10 exact duplicates
    jm, tm = meshes(4)
    jd, _ = jk.sharded_knn(pts, jm, k=4, row_tile=16)
    td, ti = tk.sharded_knn(pts, tm, k=4, row_tile=16)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)
    ti = ti.numpy()
    assert ti.min() >= 0 and ti.max() < len(pts)
    assert (ti != np.arange(len(pts))[:, None]).all()


def test_cross_knn_id_masks():
    q = torch.from_numpy(np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32))
    ids = torch.arange(50, dtype=torch.int32)
    d_self, i_self = cross_knn(q, q, 4, exclude_self=True)
    d_ids, i_ids = cross_knn(q, q, 4, query_ids=ids, ref_ids=ids)
    assert torch.equal(d_self, d_ids) and torch.equal(i_self, i_ids)
    od, oi = knn(q, 4)
    assert torch.equal(d_self, od) and torch.equal(i_self, oi)
    with pytest.raises(ValueError, match="together"):
        cross_knn(q, q, 4, query_ids=ids)


@pytest.mark.parametrize("d", [2, 4])
def test_sharded_lof_exact_and_ivf(d, monkeypatch):
    jm, tm = meshes(d)
    pts = np.random.default_rng(7).normal(size=(600, 8)).astype(np.float32)
    pts[0] = 40.0
    m = MetricsSink()
    got = tk.sharded_lof(pts, tm, k=16, row_tile=64, sink=m).numpy()
    want = np.asarray(jk.sharded_lof(pts, jm, k=16, row_tile=64))
    rel = np.abs(got - want) / np.abs(want)
    assert (rel <= 1e-4).mean() >= 0.999 and rel.max() <= 1e-2
    assert got[0] == got.max() and got[0] > 2.0
    (rec,) = m.of_phase("impl_selected")
    assert (rec["impl"], rec["devices"], rec["requested"]) == ("exact", d, "auto")
    assert rec["cost"]["devices"] == d
    with pytest.raises(ValueError, match="unknown sharded LOF impl"):
        tk.sharded_lof(pts, tm, k=16, impl="IVF")
    # the IVF search split over the mesh: bit-equal to the one-device index
    blob = _blobs(5, 6000)
    fused = lof_scores(torch.from_numpy(blob), k=16, impl="ivf").numpy()
    np.testing.assert_array_equal(tk.sharded_lof(blob, tm, k=16, impl="ivf").numpy(), fused)
    monkeypatch.setenv("GRAPHMINE_LOF_IVF_MIN_N", "100")
    m2 = MetricsSink()
    np.testing.assert_array_equal(tk.sharded_lof(blob, tm, k=16, sink=m2).numpy(), fused)
    assert [r["impl"] for r in m2.of_phase("impl_selected")] == ["ivf"]
    assert m2.of_phase("ivf_index")


def test_validation():
    _, tm = meshes(8)
    r = np.random.default_rng(3)
    assert tk.can_shard(32, 8, 4) and not tk.can_shard(32, 8, 5)
    with pytest.raises(ValueError, match="chunk"):
        tk.sharded_knn(r.normal(size=(32, 4)).astype(np.float32), tm, k=5)
    with pytest.raises(ValueError, match="must be <"):
        tk.sharded_knn(r.normal(size=(8, 2)).astype(np.float32), tm, k=8)
