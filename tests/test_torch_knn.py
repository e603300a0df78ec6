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


@pytest.mark.parametrize("f", [64, 65])
def test_plain_knn_matches_jax_knn_at_the_general_instances_widest(f):
    # F = 64, the general instance's widest, and F = 65, the wide
    # instance's, at k = 150. Points on the integer grid [0, 4)^F: every
    # distance is an integer below 2^24, exact in both packages' float32
    # arithmetic, so distances and indices are equal, ties included.
    from graphmine_tpu.ops.knn import knn as jknn

    pts = np.random.default_rng(f).integers(0, 4, size=(700, f)).astype(np.float32)
    d, i = knn(torch.tensor(pts), 150, row_tile=256)
    d_ref, i_ref = jknn(pts, 150)
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
    assert (c["kTile"], c["kStages"]) == (knn_cuda.FAST_TILE, knn_cuda.FAST_STAGES)
    assert c["kWarps"] * c["kRowsPerWarp"] == knn_cuda.FAST_ROWS_PER_BLOCK
    ring = c["kStages"] * c["kTile"] * (c["kFeatPad"] + 1) * 4
    keys = knn_cuda.FAST_ROWS_PER_BLOCK * (c["kMaxK"] + c["kBuf"]) * 8
    assert knn_cuda.FAST_SMEM_BYTES == ring + keys + c["kStages"] * (8 + 4)
    assert c["kWideWarps"] == knn_cuda.WIDE_WARPS and c["kBuf"] == 32


def test_general_plan_is_the_sources_shape():
    """The wrapper's general-instance constants are the source's: warps,
    the largest F, a stage's floats, the stage counts, the shared-memory
    limit and the rows a warp of each query layout (the template arguments
    knn_general_f32 dispatches to)."""
    import re

    from graphmine_tpu_torch.kernels import knn_cuda

    c = _cu_constants()
    assert c["kGenWarps"] == knn_cuda.GENERAL_WARPS == 16
    assert c["kGenMaxF"] == knn_cuda.GENERAL_MAX_F == 64
    assert c["kGenTileFloats"] == knn_cuda.GENERAL_TILE_FLOATS == c["kTile"] * (c["kFeatPad"] + 1)
    assert (c["kGenMaxStages"], c["kGenMinStages"]) == (max(knn_cuda.GENERAL_STAGES),
                                                        min(knn_cuda.GENERAL_STAGES))
    assert sorted(knn_cuda.GENERAL_STAGES) == list(range(c["kGenMinStages"],
                                                         c["kGenMaxStages"] + 1))
    assert c["kSmemLimit"] == knn_cuda.SMEM_LIMIT_BYTES
    code = knn_cuda.SOURCE.read_text()
    for flag, queries in (("true", "registers"), ("false", "shared")):
        rows = {int(r) for r in re.findall(rf"GM_LAUNCH\({flag}, (\d+)\)", code)}
        assert rows == set(knn_cuda.GENERAL_ROWS_PER_WARP[queries])
    # the tile rule: the most points, a power of two up to 512, within a
    # stage's floats
    for fpad in range(8, 65, 8):
        tile = knn_cuda.general_tile(fpad)
        assert tile * (fpad + 1) <= c["kGenTileFloats"] < 2 * tile * (fpad + 1) or tile == 512
    assert [knn_cuda.general_tile(fp) for fp in (8, 16, 24, 32, 40, 64)] == [512, 256, 128, 128,
                                                                             64, 64]


def _expected_smem(plan, f):
    """A plan's shared memory from its parts: the ring, the keys and
    buffers, the staged queries and a barrier and count per stage (general);
    the keys and buffers, or the buffers alone (wide)."""
    rows, kcap = plan["rows_per_block"], plan["kcap"]
    if plan["instance"] == "general":
        fpad = -(-f // 8) * 8
        ring = plan["stages"] * plan["tile"] * (fpad + 1) * 4
        queries = rows * fpad * 4 if plan["queries"] == "shared" else 0
        return ring + rows * (kcap + 32) * 8 + queries + plan["stages"] * (8 + 4)
    if plan["instance"] == "wide":
        return rows * (kcap + 32 if plan["topk"] == "shared" else 32) * 8
    return plan["smem_bytes"]


@pytest.mark.parametrize("n,f,k,instance,rows,topk", [
    (262_144, 8, 128, "fast", 96, "shared"),       # the main path
    (384, 4, 16, "fast", 96, "shared"),            # the canary probe
    (4096, 8, 200, "general", 64, "shared"),       # phase 4's lof_k = 200
    (65_536, 16, 128, "general", 128, "shared"),
    (2000, 33, 300, "general", 64, "shared"),
    (4096, 8, 1024, "general", 16, "shared"),
    (4096, 8, 1760, "wide", 16, "shared"),
    (4096, 8, 1761, "wide", 16, "global"),
    (100_000, 3, 50_000, "wide", 16, "global"),
    (10, 5000, 9, "wide", 96, "shared"),
    # queries in registers (F <= 8), each rows-a-warp choice
    (3001, 1, 130, "general", 96, "shared"),
    (65_536, 8, 256, "general", 64, "shared"),
    (2500, 5, 300, "general", 48, "shared"),
    (3001, 3, 600, "general", 32, "shared"),
    (3001, 8, 1300, "general", 16, "shared"),
    # queries in shared memory (9 <= F <= 64), each rows-a-warp choice
    (3001, 16, 100, "general", 128, "shared"),
    (3001, 64, 150, "general", 96, "shared"),
    (4096, 16, 256, "general", 64, "shared"),
    (3001, 24, 350, "general", 48, "shared"),
    (3001, 40, 500, "general", 32, "shared"),
    (3001, 64, 1300, "general", 16, "shared"),
    # F = 64 against F = 65; the key capacity where general gives way to wide
    (3001, 65, 150, "wide", 96, "shared"),
    (3000, 8, 1344, "general", 16, "shared"),
    (3000, 8, 1345, "wide", 16, "shared"),
    (3000, 64, 1344, "general", 16, "shared"),
    (3000, 64, 1345, "wide", 16, "shared"),
])
def test_launch_plan_pins_the_instances(n, f, k, instance, rows, topk):
    from graphmine_tpu_torch.kernels import knn_cuda

    plan = knn_cuda.launch_plan(n, f, k)
    assert (plan["instance"], plan["rows_per_block"], plan["topk"]) == (instance, rows, topk)
    assert plan["smem_bytes"] <= knn_cuda.SMEM_LIMIT_BYTES == 232_448
    assert plan["kcap"] >= k and plan["kcap"] % 32 == 0
    assert plan["smem_bytes"] == _expected_smem(plan, f)
    if instance == "general":
        assert plan["queries"] == ("registers" if f <= 8 else "shared")
        assert plan["stages"] in (3, 4) and plan["tile"] == knn_cuda.general_tile(-(-f // 8) * 8)
    if instance == "wide":
        assert (plan["queries"], plan["tile"], plan["stages"]) == ("global", 0, 0)
        assert plan == knn_cuda.wide_plan(n, f, k)
        blocks = -(-n // rows)
        assert plan["scratch_keys"] == (blocks * rows * plan["kcap"] if topk == "global" else 0)


def test_every_launch_plan_fits_and_the_bad_shapes_raise():
    from graphmine_tpu_torch.kernels import knn_cuda

    rng = np.random.default_rng(12)
    limit = knn_cuda.SMEM_LIMIT_BYTES
    for _ in range(2000):
        n = int(rng.integers(2, 1 << 31))
        k = int(rng.integers(1, min(n, 1 << 20))) if rng.random() < 0.5 else int(
            rng.integers(1, min(n, 2000)))
        f = int(rng.integers(1, 4096)) if rng.random() < 0.5 else int(rng.integers(1, 80))
        plan = knn_cuda.launch_plan(n, f, k)
        assert plan["smem_bytes"] <= limit
        assert plan["smem_bytes"] == _expected_smem(plan, f)
        assert plan["rows_per_block"] == 16 * plan["rows_per_warp"] or plan["instance"] == "fast"
        # the fast instance exactly where the source's shape allows it
        assert (plan["instance"] == "fast") == (f <= 8 and k <= 128)
        fpad = -(-f // 8) * 8
        general = [knn_cuda.general_smem_bytes(fpad, knn_cuda.general_tile(fpad), st, r,
                                               plan["kcap"], "registers" if fpad == 8 else "shared")
                   for q in ("registers" if fpad == 8 else "shared",)
                   for r in knn_cuda.GENERAL_ROWS_PER_WARP[q] for st in knn_cuda.GENERAL_STAGES]
        if plan["instance"] == "general":
            assert f <= 64 and plan["topk"] == "shared" and plan["scratch_keys"] == 0
            # the most rows a warp, then the most stages, that fit
            assert min(general) <= limit
            better = [b for b in general[:general.index(plan["smem_bytes"])] if b <= limit]
            assert not better
        elif plan["instance"] == "wide":
            # past F = 64, or no general plan fits at one row a warp
            assert f > 64 or min(general) > limit
            # the most rows a warp whose keys fit
            if plan["rows_per_warp"] < 6:
                bigger = {1: 3, 3: 6}[plan["rows_per_warp"]]
                assert 16 * bigger * (plan["kcap"] + 32) * 8 > limit
    for n, f, k in ((10, 2, 10), (10, 2, 0), (10, 0, 3), (1 << 31, 2, 3)):
        with pytest.raises(ValueError):
            knn_cuda.launch_plan(n, f, k)
