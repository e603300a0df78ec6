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


def test_lof_auto_takes_ivf_from_the_crossover_and_the_jax_names():
    assert select_lof_impl(1 << 17, 128)[0] == "ivf"
    assert select_lof_impl(1000, 128)[0] == "exact"
    assert select_lof_impl(1 << 17, 128, impl="exact")[0] == "exact"
    # where IVF would run but no k-means cluster can fill k, "auto" takes
    # the IVF index, whose guard raises a warning and runs the exact kNN
    pts = torch.from_numpy(np.random.default_rng(4).normal(size=(64, 4)).astype(np.float32))
    with pytest.warns(UserWarning, match="ivf_knn guard 'k_unfillable'"):
        scores = lof_scores(pts, k=40, ivf_min_points=50)
    np.testing.assert_array_equal(scores.numpy(), lof_scores(pts, k=40, impl="exact").numpy())
    # the JAX package's names: "xla" and "pallas" are the exact family
    for name in ("xla", "pallas", "exact"):
        assert select_lof_impl(1 << 17, 128, impl=name) == (
            "exact", f"impl={name!r} requested explicitly")
    np.testing.assert_array_equal(lof_scores(pts, k=40, impl="pallas").numpy(),
                                  lof_scores(pts, k=40, impl="exact").numpy())
    with pytest.raises(ValueError, match="unknown LOF impl"):
        select_lof_impl(10, 2, impl="triton")


def test_kernel_wrapper_takes_only_cuda_tensors():
    from graphmine_tpu_torch.kernels import knn_cuda

    before = knn_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        knn_cuda.knn_topk(torch.zeros(8, 2), 3)
    assert knn_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        knn(torch.zeros(8, 2, device="meta"), 3)


def test_kernel_keeps_the_unfused_float32_contract():
    """The kernel's distances are bit-equal to the plain version's only if
    it rounds every product and sum on its own: no FMA contraction, no
    fused or tensor-core instruction in the source."""
    import re

    from graphmine_tpu_torch.kernels import knn_cuda

    assert "--fmad=false" in knn_cuda.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in knn_cuda.NVCC_FLAGS
    code = re.sub(r"//[^\n]*", "", knn_cuda.SOURCE.read_text())
    assert not re.search(r"\b(fmaf?|__fmaf?_r[nzud]|__fma_r[nzud]|wmma|mma|wgmma)\b", code)
    assert "__fmul_rn" in code and "__fadd_rn" in code and "__fsub_rn" in code
    # no shape limit is left: every F >= 1 and 0 < k < N has an instance
    assert not hasattr(knn_cuda, "MAX_K") and not hasattr(knn_cuda, "MAX_F")


def test_plain_knn_matches_jax_knn_past_the_fast_instance():
    # k = 200 and F = 12, where the card runs the kernel's general instance.
    # Points on the integer grid [0, 8)^12: every distance is an integer
    # below 2^24, exact in both packages' float32 arithmetic, so distances
    # are equal and indices too, ties (there are many) included. (On a
    # normal cloud the 200th and 201st neighbours sit close enough for the
    # JAX matrix product and the port's sums to round them apart.)
    from graphmine_tpu.ops.knn import knn as jknn

    pts = np.random.default_rng(9).integers(0, 8, size=(1500, 12)).astype(np.float32)
    d, i = knn(torch.tensor(pts), 200, row_tile=512)
    d_ref, i_ref = jknn(pts, 200)
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def _cu_constants():
    import re

    from graphmine_tpu_torch.kernels import knn_cuda

    code = knn_cuda.SOURCE.read_text()
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (k\w+) = (\d+);", code)}


def test_fast_plan_is_the_sources_shape():
    from graphmine_tpu_torch.kernels import knn_cuda

    c = _cu_constants()
    assert (c["kFeatPad"], c["kMaxK"]) == (knn_cuda.FAST_F, knn_cuda.FAST_K)
    assert c["kWarps"] * c["kRowsPerWarp"] == knn_cuda.FAST_ROWS_PER_BLOCK
    ring = c["kStages"] * c["kTile"] * (c["kFeatPad"] + 1) * 4
    keys = knn_cuda.FAST_ROWS_PER_BLOCK * (c["kMaxK"] + c["kBuf"]) * 8
    assert knn_cuda.FAST_SMEM_BYTES == ring + keys + c["kStages"] * (8 + 4)
    assert c["kGenWarps"] == knn_cuda.GENERAL_WARPS and c["kBuf"] == 32


@pytest.mark.parametrize("n,f,k,instance,rows,topk", [
    (262_144, 8, 128, "fast", 96, "shared"),       # the main path
    (384, 4, 16, "fast", 96, "shared"),            # the canary probe
    (4096, 8, 200, "general", 96, "shared"),
    (65_536, 16, 128, "general", 96, "shared"),
    (2000, 33, 300, "general", 48, "shared"),
    (4096, 8, 1024, "general", 16, "shared"),
    (4096, 8, 1760, "general", 16, "shared"),
    (4096, 8, 1761, "general", 16, "global"),
    (100_000, 3, 50_000, "general", 16, "global"),
    (10, 5000, 9, "general", 96, "shared"),
])
def test_launch_plan_pins_the_instances(n, f, k, instance, rows, topk):
    from graphmine_tpu_torch.kernels import knn_cuda

    plan = knn_cuda.launch_plan(n, f, k)
    assert (plan["instance"], plan["rows_per_block"], plan["topk"]) == (instance, rows, topk)
    assert plan["smem_bytes"] <= knn_cuda.SMEM_LIMIT_BYTES == 232_448
    assert plan["kcap"] >= k and plan["kcap"] % 32 == 0
    if instance == "general":
        keys = plan["kcap"] + 32 if topk == "shared" else 32
        assert plan["smem_bytes"] == 16 * plan["rows_per_warp"] * keys * 8
        blocks = -(-n // rows)
        assert plan["scratch_keys"] == (blocks * rows * plan["kcap"] if topk == "global" else 0)


def test_every_launch_plan_fits_and_the_bad_shapes_raise():
    from graphmine_tpu_torch.kernels import knn_cuda

    rng = np.random.default_rng(12)
    for _ in range(2000):
        n = int(rng.integers(2, 1 << 31))
        k = int(rng.integers(1, min(n, 1 << 20)))
        f = int(rng.integers(1, 4096))
        plan = knn_cuda.launch_plan(n, f, k)
        assert plan["smem_bytes"] <= knn_cuda.SMEM_LIMIT_BYTES
        # the fast instance exactly where the source's shape allows it
        assert (plan["instance"] == "fast") == (f <= 8 and k <= 128)
        # the most rows a warp whose keys fit
        if plan["instance"] == "general" and plan["rows_per_warp"] < 6:
            bigger = {1: 3, 3: 6}[plan["rows_per_warp"]]
            assert 16 * bigger * (plan["kcap"] + 32) * 8 > knn_cuda.SMEM_LIMIT_BYTES
    for n, f, k in ((10, 2, 10), (10, 2, 0), (10, 0, 3), (1 << 31, 2, 3)):
        with pytest.raises(ValueError):
            knn_cuda.launch_plan(n, f, k)
