"""Port parity: the exact kNN's plain version against the JAX package's XLA
path and its Pallas kernel (interpret mode), and LOF.

Indices must be equal on tie-free inputs; distances agree to rtol 1e-4 /
atol 1e-5 (the XLA dot and the port's feature-by-feature sum round in
different orders). LOF from one kNN input agrees to rtol 1e-5.
The hand-written CUDA kernel runs only on the card: ``chip_smoke.py``
holds it against this plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from graphmine_tpu.ops.knn import _knn_xla
from graphmine_tpu.ops.lof import auroc as jauroc
from graphmine_tpu.ops.lof import lof_from_knn as jlof_from_knn
from graphmine_tpu.pallas_kernels.knn_pallas import knn_pallas

import torch

from graphmine_tpu_torch.ops.knn import knn
from graphmine_tpu_torch.ops.lof import auroc, lof_from_knn, lof_scores, select_lof_impl


def _tie_free_points(n, f, seed=0):
    return np.random.default_rng(seed).normal(size=(n, f)).astype(np.float32)


@pytest.mark.parametrize("n,f,k", [(200, 8, 5), (513, 3, 20), (1024, 40, 32), (130, 4, 3)])
def test_plain_knn_matches_xla_and_pallas(n, f, k):
    pts = _tie_free_points(n, f)
    d, i = knn(torch.tensor(pts), k, row_tile=256)
    d_ref, i_ref = _knn_xla(pts, k=k, row_tile=256)
    d_pal, i_pal = knn_pallas(pts, k=k, row_tile=128, col_tile=128, interpret=True)
    for di, ii in ((d_ref, i_ref), (d_pal, i_pal)):
        np.testing.assert_array_equal(i.numpy(), np.asarray(ii))
        np.testing.assert_allclose(d.numpy(), np.asarray(di), rtol=1e-4, atol=1e-5)


def test_plain_knn_ascending_self_excluded_ties_to_smaller_index():
    pts = _tie_free_points(300, 6, seed=3)
    pts[7] = pts[5]  # an exact duplicate pair: a distance tie for every row
    d, i = knn(torch.tensor(pts), 10, row_tile=64)
    d, i = d.numpy(), i.numpy()
    assert (np.diff(d, axis=1) >= 0).all()
    assert (i != np.arange(300)[:, None]).all()
    assert ((i >= 0) & (i < 300)).all()
    # rows whose list holds both twins keep index 5 before index 7
    for row in range(300):
        r = list(i[row])
        if 5 in r and 7 in r:
            assert r.index(5) < r.index(7)
    # tiling does not change the answer
    d2, i2 = knn(torch.tensor(pts), 10, row_tile=1024)
    np.testing.assert_array_equal(i2.numpy(), i)
    np.testing.assert_array_equal(d2.numpy(), d)


def test_knn_rejects_bad_k():
    with pytest.raises(ValueError, match="must be in"):
        knn(torch.zeros(4, 2), 4)


def test_lof_from_knn_matches():
    pts = _tie_free_points(600, 5, seed=2)
    d2, idx = _knn_xla(pts, k=15)
    ref = np.asarray(jlof_from_knn(d2, idx, 15))
    got = lof_from_knn(torch.tensor(np.asarray(d2)), torch.tensor(np.asarray(idx)), 15)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5)
    y = np.zeros(600, bool)
    y[:30] = True
    assert auroc(got.numpy(), y) == pytest.approx(jauroc(ref, y), abs=1e-3)
    # the scorer end to end on the port's own kNN: same neighbours, but
    # distances rounded in another order (~1e-6 relative), which the
    # reach-distance sums and lrd ratios amplify to ~6e-5 here
    np.testing.assert_allclose(lof_scores(torch.tensor(pts), k=15).numpy(), ref, rtol=2e-4)


def test_lof_auto_raises_where_ivf_would_run():
    assert select_lof_impl(1 << 17, 128)[0] == "ivf"
    assert select_lof_impl(1000, 128)[0] == "exact"
    assert select_lof_impl(1 << 17, 128, impl="exact")[0] == "exact"
    with pytest.raises(NotImplementedError, match="IVF"):
        lof_scores(torch.zeros(64, 2), k=4, ivf_min_points=32)
    with pytest.raises(ValueError, match="unknown LOF impl"):
        select_lof_impl(10, 2, impl="xla")


def test_kernel_wrapper_takes_only_cuda_tensors():
    from graphmine_tpu_torch.kernels import knn_cuda

    before = knn_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_cuda.knn_topk(torch.zeros(8, 2), 3)
    assert knn_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        knn(torch.zeros(8, 2, device="meta"), 3)
