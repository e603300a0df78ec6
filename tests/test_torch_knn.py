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
from _torch_threads import one_torch_thread  # noqa: F401


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


@pytest.mark.parametrize("f", [64, 65, 128])
def test_plain_knn_matches_jax_knn_at_the_general_instances_widest(f):
    # F = 64, the general instance's widest, and F = 65 and 128, the wide
    # instance's (one chunk and a remainder; four whole chunks), at k = 150. Points on the integer grid [0, 4)^F: every
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


def test_wide_plan_is_the_sources_shape():
    """The wrapper's wide-instance constants are the source's: warps, a
    stage's floats, the largest chunk, the stage counts, the packing, the
    persistent grid and the rows a warp of each query layout (the template
    arguments knn_wide_f32 dispatches to); and its layout rule."""
    import re

    from graphmine_tpu_torch.kernels import knn_cuda

    c = _cu_constants()
    assert c["kWideWarps"] == knn_cuda.WIDE_WARPS == 16
    assert c["kWideStageFloats"] == knn_cuda.WIDE_STAGE_FLOATS
    assert c["kWideMaxChunk"] == knn_cuda.WIDE_MAX_CHUNK
    stages = set(knn_cuda.WIDE_STAGES) | set(knn_cuda.WIDE_ONE_ROW_STAGES)
    assert (c["kWideMinStages"], c["kWideMaxStages"]) == (min(stages), max(stages)) == (2, 8)
    assert c["kWidePackPoints"] == knn_cuda.WIDE_PACK_POINTS
    assert c["kWideResidentBlocks"] == knn_cuda.WIDE_RESIDENT_BLOCKS
    assert c["kWideBigBuf"] == knn_cuda.WIDE_BIG_BUF == 128
    code = knn_cuda.SOURCE.read_text()
    for flag, queries in (("true", "stage"), ("false", "shared")):
        rows = {int(r) for r in re.findall(rf"GW_LAUNCH\({flag}, (\d+)\)", code)}
        assert rows == set(knn_cuda.WIDE_ROWS_PER_WARP[queries])
    for f in range(1, 600):
        fpad, chunk, tile = knn_cuda.wide_layout(f)
        chunks = -(-fpad // chunk)
        last = fpad - (chunks - 1) * chunk
        assert fpad - 4 < f <= fpad and fpad % 4 == 0 and chunk % 4 == 0
        # the fewest chunks of at most 32 features, the last one not empty
        assert chunk <= knn_cuda.WIDE_MAX_CHUNK and chunks == -(-fpad // knn_cuda.WIDE_MAX_CHUNK)
        assert 0 < last <= chunk
        # a stage's points fit; a tile of several chunks is one step of 64
        assert tile * (chunk + 1) <= knn_cuda.WIDE_STAGE_FLOATS
        assert tile == 256 or 2 * tile * (chunk + 1) > knn_cuda.WIDE_STAGE_FLOATS
        assert chunks == 1 or tile == 64
        # the packing's whole groups hold whole tiles and every riding block
        assert knn_cuda.WIDE_PACK_POINTS % tile == 0
    assert [knn_cuda.wide_layout(f) for f in (3, 8, 16, 65, 128, 5000)] == [
        (4, 4, 256), (8, 8, 256), (16, 16, 128), (68, 24, 64), (128, 32, 64), (5000, 32, 64)]


def _expected_smem(plan, f):
    """A plan's shared memory from its parts: the ring, the keys and
    buffers, the staged queries and a barrier and count per stage (general);
    the ring with the riding query tiles, the keys (unless in scratch),
    buffers and each row's norm, threshold and count, the queries staged
    whole and a barrier and count per stage (wide)."""
    rows, kcap = plan["rows_per_block"], plan["kcap"]
    if plan["instance"] == "general":
        fpad = -(-f // 8) * 8
        ring = plan["stages"] * plan["tile"] * (fpad + 1) * 4
        queries = rows * fpad * 4 if plan["queries"] == "shared" else 0
        return ring + rows * (kcap + 32) * 8 + queries + plan["stages"] * (8 + 4)
    if plan["instance"] == "wide":
        fpad, tile = -(-f // 4) * 4, plan["tile"]
        riding = (max(1, rows // tile)) if plan["queries"] == "stage" else 0
        ring = plan["stages"] * tile * (plan["chunk"] + 1) * (1 + riding) * 4
        buf = 128 if plan["rows_per_warp"] == 1 else 32
        keys = rows * ((kcap if plan["topk"] == "shared" else 0) + buf) * 8 + rows * 12
        queries = rows * fpad * 4 if plan["queries"] == "shared" else 0
        return ring + keys + queries + plan["stages"] * (8 + 4)
    return plan["smem_bytes"]


@pytest.mark.parametrize("n,f,k,instance,rows,topk", [
    (262_144, 8, 128, "fast", 96, "shared"),       # the main path
    (384, 4, 16, "fast", 96, "shared"),            # the canary probe
    (4096, 8, 200, "general", 64, "shared"),       # phase 4's lof_k = 200
    (65_536, 16, 128, "general", 128, "shared"),
    (2000, 33, 300, "general", 64, "shared"),
    (4096, 8, 1024, "general", 16, "shared"),
    (8001, 65, 1248, "wide", 16, "shared"),
    (8001, 65, 1249, "wide", 16, "global"),
    (4096, 8, 1536, "wide", 16, "global"),
    (100_000, 3, 50_000, "wide", 16, "global"),
    (10, 5000, 9, "wide", 128, "shared"),
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
    (3001, 65, 150, "wide", 128, "global"),
    (3000, 8, 1344, "general", 16, "shared"),
    (3000, 8, 1345, "wide", 64, "global"),
    (3000, 64, 1344, "general", 16, "shared"),
    (3000, 64, 1345, "wide", 64, "global"),
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
        assert plan["queries"] in ("shared", "stage")
        assert plan["stages"] in (knn_cuda.WIDE_ONE_ROW_STAGES if plan["rows_per_warp"] == 1
                                  else knn_cuda.WIDE_STAGES)
        assert (plan["tile"], plan["chunk"]) == knn_cuda.wide_layout(f)[2:0:-1]
        assert plan == knn_cuda.wide_plan(n, f, k)
        groups = -(-n // rows)
        blocks = min(groups, 132) if topk == "global" else groups
        assert plan["blocks"] == blocks
        assert plan["scratch_keys"] == (blocks * rows * plan["kcap"] if topk == "global" else 0)


@pytest.mark.parametrize("n,f,k,tile,chunk,stages,rows,queries,topk", [
    # the timed rows: F = 65 (chunks of 24, 24, 20; keys in shared memory),
    # F = 128 (four chunks of 32; 8 rows staged whole only beside keys in
    # scratch), and F = 8 at k = 1,500 and 2,000 (one row a warp, so that
    # L2 holds the keys per resident block; 8 stages, which leave no room
    # for the keys in shared memory)
    (65_536, 65, 128, 64, 24, 3, 128, "shared", "shared"),
    (65_536, 128, 128, 64, 32, 3, 128, "shared", "global"),
    (65_536, 8, 1500, 256, 8, 8, 16, "shared", "global"),
    (65_536, 8, 2000, 256, 8, 8, 16, "shared", "global"),
    # one row a warp with its keys in shared memory beside 8 stages
    (65_536, 65, 1000, 64, 24, 8, 16, "shared", "shared"),
    # F = 5,000: 157 chunks, the rows riding; F = 400, past the staging
    # limit; F = 300 staged whole beside keys in scratch
    (10, 5000, 9, 64, 32, 3, 128, "stage", "shared"),
    (3001, 400, 64, 64, 32, 3, 128, "stage", "shared"),
    (2000, 300, 64, 64, 32, 3, 128, "shared", "global"),
    # the scratch's L2 budget takes rows a warp away as k grows
    (17_001, 65, 250, 64, 24, 3, 96, "shared", "global"),
    (12_001, 65, 400, 64, 24, 3, 64, "shared", "global"),
    (8001, 65, 800, 64, 24, 3, 32, "shared", "global"),
    (20_001, 8, 1900, 256, 8, 8, 16, "shared", "global"),
    # riding at fewer rows
    (12_001, 800, 400, 64, 32, 3, 64, "stage", "global"),
    (8001, 2000, 600, 64, 32, 3, 32, "stage", "shared"),
    (3001, 4000, 1700, 64, 32, 8, 16, "stage", "global"),
])
def test_wide_plan_pins_its_choices(n, f, k, tile, chunk, stages, rows, queries, topk):
    from graphmine_tpu_torch.kernels import knn_cuda

    plan = knn_cuda.launch_plan(n, f, k)
    assert plan["instance"] == "wide"
    assert (plan["tile"], plan["chunk"], plan["stages"], plan["rows_per_block"], plan["queries"],
            plan["topk"]) == (tile, chunk, stages, rows, queries, topk)
    assert plan["smem_bytes"] == _expected_smem(plan, f) <= knn_cuda.SMEM_LIMIT_BYTES


def test_wide_scratch_is_bounded_by_the_resident_blocks():
    from graphmine_tpu_torch.kernels import knn_cuda

    # 65,536 x 8 at k = 2,000: 132 blocks of 16 rows of 2,016 keys (34 MB,
    # within L2), not a row of keys for each of the 65,536 points (1.06 GB)
    plan = knn_cuda.launch_plan(65_536, 8, 2000)
    assert plan["scratch_keys"] == 132 * 16 * 2016
    assert 8 * plan["scratch_keys"] < 50 * 10**6 < 8 * 65_536 * 2016
    # the same at any N past 132 row groups
    assert knn_cuda.launch_plan(1 << 24, 8, 2000)["scratch_keys"] == plan["scratch_keys"]
    assert knn_cuda.wide_packed_floats(65_536, 8) == 65_536 * 9
    assert knn_cuda.wide_packed_floats(3001, 65) == 3072 * 69


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
            # the keys in scratch only where no plan keeps them in shared
            # memory; there a persistent grid, its scratch bounded by the
            # resident blocks and not by N
            kcap, r = plan["kcap"], plan["rows_per_warp"]
            fits = lambda r, q, st, topk: knn_cuda.wide_smem_bytes(f, st, r, kcap, q, topk) <= limit
            scratch = lambda rr: min(-(-n // (16 * rr)), 132) * 16 * rr * kcap
            if plan["topk"] == "global":
                assert plan["blocks"] == min(-(-n // (16 * r)), 132)
                assert plan["scratch_keys"] == scratch(r) <= 132 * 16 * r * kcap
                assert r == 1 or 8 * scratch(r) <= knn_cuda.WIDE_SCRATCH_BYTES
            else:
                assert plan["scratch_keys"] == 0 and plan["blocks"] == -(-n // (16 * r))
            # the most rows a warp, the queries whole before riding, the
            # stages in order, then the keys in shared memory before scratch
            # (within the scratch's budget past a row a warp)
            order = [(rr, q, t, st) for rr in knn_cuda.WIDE_ROWS_PER_WARP["shared"]
                     for q in ("shared", "stage") if rr in knn_cuda.WIDE_ROWS_PER_WARP[q]
                     for st in (knn_cuda.WIDE_ONE_ROW_STAGES if rr == 1 else knn_cuda.WIDE_STAGES)
                     for t in ("shared", "global")
                     if t == "shared" or rr == 1 or 8 * scratch(rr) <= knn_cuda.WIDE_SCRATCH_BYTES]
            chosen = order.index((r, plan["queries"], plan["topk"], plan["stages"]))
            assert not any(fits(rr, q, st, t) for rr, q, t, st in order[:chosen])
    for n, f, k in ((10, 2, 10), (10, 2, 0), (10, 0, 3), (1 << 31, 2, 3)):
        with pytest.raises(ValueError):
            knn_cuda.launch_plan(n, f, k)
