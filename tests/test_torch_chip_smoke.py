"""The chip smoke's host side: what it can show without a card.

``chip_smoke.py`` runs only on a CUDA card. Here: it exits non-zero with
no result line on a machine without CUDA and in a directory that holds it
alone, its bulk edge-list writer gives the ids the port's loader reads
back, its arguments parse, and its kNN bound, floor and parity check compute
what they say.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

from graphmine_tpu_torch.io.edges import load_edge_list  # noqa: E402
from graphmine_tpu_torch.ops.knn import _tiled_knn  # noqa: E402


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the smoke would run")
    out = _run(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


def test_kernels_only_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the smoke would run")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--kernels-only"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


def test_parses_kernels_only():
    assert not chip_smoke.parse_args([]).kernels_only
    assert chip_smoke.parse_args(["--kernels-only"]).kernels_only
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--kernel-only-typo"])


def test_every_general_plan_has_a_parity_case():
    """Phase 3's cases run each rows-a-warp choice of the general instance
    with its queries in registers and in shared memory, F = 1 and F = 64,
    N off a whole tile, and the wide instance at F = 65 and with its keys in
    device scratch (the plans as the wrapper computes them on the CPU)."""
    from graphmine_tpu_torch.kernels import knn_cuda

    general = (chip_smoke.GENERAL_CASES + chip_smoke.GENERAL_PLAN_CASES
               + (chip_smoke.GENERAL_TIED_CASE, chip_smoke.GENERAL_GRID_CASE))
    plans = [knn_cuda.launch_plan(*case) for case in general]
    assert {p["instance"] for p in plans} == {"general"}
    assert {(p["queries"], p["rows_per_warp"]) for p in plans} == {
        (q, r) for q, rows in knn_cuda.GENERAL_ROWS_PER_WARP.items() for r in rows}
    assert {p["stages"] for p in plans} == set(knn_cuda.GENERAL_STAGES)
    assert {1, 64} <= {f for _, f, _ in general}
    assert any(n % p["tile"] for (n, _, _), p in zip(general, plans))
    assert knn_cuda.launch_plan(*chip_smoke.WIDE_CASE)["instance"] == "wide"
    assert chip_smoke.WIDE_CASE[1] == 65
    scratch = knn_cuda.launch_plan(*chip_smoke.GLOBAL_SCRATCH_CASE)
    assert (scratch["instance"], scratch["topk"]) == ("wide", "global")
    assert [knn_cuda.launch_plan(*s)["instance"] for s in chip_smoke.GENERAL_TIMED] == [
        "general"] * 3
    assert knn_cuda.launch_plan(*chip_smoke.WIDE_TIMED)["instance"] == "wide"


def test_exits_nonzero_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout


def test_edge_list_writer_round_trips(tmp_path):
    rng = np.random.default_rng(1)
    src = rng.integers(0, 100_000, 5000).astype(np.int32)
    dst = rng.integers(0, 100_000, 5000).astype(np.int32)
    src[:3] = [0, 7, 99_999]
    path = tmp_path / "e.txt"
    chip_smoke.write_edge_list(path, src, dst)
    et = load_edge_list(str(path))
    names = et.names.astype(np.int64)
    np.testing.assert_array_equal(names[et.src], src)
    np.testing.assert_array_equal(names[et.dst], dst)
    np.testing.assert_array_equal(np.loadtxt(path, dtype=np.int64), np.stack([src, dst], 1))


def test_knn_bound_is_operations_at_the_main_path_shape():
    ms, by = chip_smoke.knn_bound_ms(262_144, 8, 128)
    assert by == "operations"
    assert ms == pytest.approx(1e3 * 262_144 * 262_143 * 19 / 67e12)
    assert chip_smoke.knn_bound_ms(1000, 1, 999)[1] == "bytes"


def test_unfused_floor_is_twice_the_bound_at_the_main_path_shape():
    bound, _ = chip_smoke.knn_bound_ms(262_144, 8, 128)
    floor = chip_smoke.knn_unfused_floor_ms(262_144, 8, 128)
    assert floor == pytest.approx(2 * bound, rel=1e-12)
    assert floor == pytest.approx(38.98, abs=0.005)
    # where bytes bind, the floor is the bytes' time, as the bound is
    assert chip_smoke.knn_unfused_floor_ms(1000, 1, 999) == chip_smoke.knn_bound_ms(1000, 1, 999)[0]


def test_kernels_line_holds_measured_keys_and_the_floor_its_own_line(capsys):
    entry = {"name": "knn_topk", "instance": "fast", "route": "cuda",
             "source": chip_smoke.KNN_SOURCE,
             "replaces": chip_smoke.KNN_REPLACES, "shape": {"n": 262_144, "f": 8, "k": 128},
             "launches": 1, "max_abs_err": 0.0, "ms": 68.0, "plain_ms": 8000.0,
             "bound_ms": 19.49, "bound_by": "operations", "library_ms": 1300.0}
    chip_smoke.print_kernels([entry])
    kernels, floor = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert kernels == {"kernels": [entry]}
    assert floor == {"unfused_floor_ms": {
        "knn_topk fast n=262144 f=8 k=128": chip_smoke.knn_unfused_floor_ms(262_144, 8, 128)}}


def test_check_knn_accepts_equal_and_rejects_a_swap():
    pts = torch.from_numpy(np.random.default_rng(2).normal(size=(300, 5)).astype(np.float32))
    d, i = _tiled_knn(pts, 10)
    assert chip_smoke.check_knn(pts, 10, d, i, d, i) == {"max_abs_err": 0.0,
                                                          "index_mismatches": 0}
    swapped = i.clone()
    swapped[0, 3], swapped[0, 4] = i[0, 4], i[0, 3]
    with pytest.raises(RuntimeError, match="2 kernel indices differ"):
        chip_smoke.check_knn(pts, 10, d, swapped, d, i)
    selfish = i.clone()
    selfish[5, 0] = 5
    with pytest.raises(RuntimeError, match="itself"):
        chip_smoke.check_knn(pts, 10, d, selfish, d, i)
    json.dumps(chip_smoke.check_knn(pts, 10, d, i, d, i))


def test_check_knn_rejects_a_swap_between_tied_neighbours():
    pts = torch.from_numpy(np.random.default_rng(3).integers(0, 3, size=(200, 2)).astype(np.float32))
    d, i = _tiled_knn(pts, 20)
    row, col = next((r, c) for r in range(200) for c in range(19) if d[r, c] == d[r, c + 1])
    swapped = i.clone()
    swapped[row, col], swapped[row, col + 1] = i[row, col + 1], i[row, col]
    with pytest.raises(RuntimeError, match="2 kernel indices differ"):
        chip_smoke.check_knn(pts, 20, d, swapped, d, i)


def test_weighted_edge_list_writer_round_trips_through_the_native_loader(tmp_path):
    rng = np.random.default_rng(7)
    src = rng.integers(0, 100_000, 5000).astype(np.int32)
    dst = rng.integers(0, 100_000, 5000).astype(np.int32)
    w = rng.integers(1, 16, 5000) / 4
    w[:2] = [0.0, 123.45]
    path = tmp_path / "w.txt"
    chip_smoke.write_edge_list(path, src, dst, w)
    et = load_edge_list(str(path), weight_col=2)
    names = et.names.astype(np.int64)
    np.testing.assert_array_equal(names[et.src], src)
    np.testing.assert_array_equal(names[et.dst], dst)
    np.testing.assert_array_equal(et.weights, w.astype(np.float32))
    with pytest.raises(ValueError, match="multiples of 0.01"):
        chip_smoke.write_edge_list(path, src[:2], dst[:2], np.array([0.125, 1.0]))


def test_ivf_quality_accepts_equal_and_rejects_a_swapped_neighbour():
    # 100 x 8 neighbours: one wrong neighbour is a recall of 0.99875
    pts, _ = chip_smoke.blob_cloud(100, f=4, seed=1)
    pts = torch.from_numpy(pts)
    is_out = np.arange(100) < 5
    d, i = _tiled_knn(pts, 8)
    q = chip_smoke.ivf_quality(pts, 8, (d, i), (d, i), is_out)
    assert q["recall"] == q["index_recall"] == 1.0 and q["delta_auroc"] == 0.0
    json.dumps(q)
    # one true neighbour of row 0 swapped for the farthest point
    far = int(torch.argmax(((pts - pts[0]) ** 2).sum(1)))
    swapped = i.clone()
    swapped[0, 3] = far
    with pytest.raises(RuntimeError, match="recall"):
        chip_smoke.ivf_quality(pts, 8, (d, i), (d, swapped), is_out)
    repeated = i.clone()
    repeated[0, 3] = i[0, 2]
    with pytest.raises(RuntimeError, match="repeats"):
        chip_smoke.ivf_quality(pts, 8, (d, i), (d, repeated), is_out)


def test_ivf_quality_counts_a_tied_neighbour_as_found():
    # an exact duplicate of row 0's 8th neighbour: either twin is a
    # correct 8th neighbour, so recall stays 1 while the index recall drops
    pts, is_out = chip_smoke.blob_cloud(600, f=4, seed=1)
    pts = torch.from_numpy(pts)
    _, i = _tiled_knn(pts, 8)
    twin = int(i[0, 7])
    pts = torch.cat([pts, pts[twin:twin + 1]])
    is_out = np.append(is_out, is_out[twin])
    d, i = _tiled_knn(pts, 8)
    other = i.clone()
    other[0, 7] = len(pts) - 1 if int(i[0, 7]) == twin else twin
    q = chip_smoke.ivf_quality(pts, 8, (d, i), (d, other), is_out)
    assert q["recall"] == 1.0 and q["index_recall"] < 1.0


def test_harness_flags_parse_through_both_clis(tmp_path):
    from graphmine_tpu.pipeline.config import parse_args as jparse

    from graphmine_tpu_torch.pipeline.config import parse_args

    flags = chip_smoke.harness_flags(tmp_path, tmp_path / "edges.parquet")
    cfg, ref = parse_args(flags), jparse(flags)
    for key in ("data_path", "batch_rows", "checkpoint_dir", "checkpoint_every", "resume",
                "heartbeat_every_s", "prom_out", "metrics_out", "run_id", "profile_dir",
                "snapshot_out", "max_iter", "lof_k", "lof_impl", "outlier_method"):
        assert getattr(cfg, key) == getattr(ref, key), key
    assert cfg.resilience == type(cfg.resilience)(**vars(ref.resilience))
    assert cfg.resilience.tripwire_every_k == 1 and cfg.resilience.superstep_timeout_s == 120
    assert cfg.run_id == chip_smoke.HARNESS_RUN_ID and cfg.device == "cuda"


def test_harness_phase_checks_and_line_on_a_recorded_cpu_stream(tmp_path, monkeypatch):
    """Phase 5c's checks and its line on the CPU at a small size: the same
    flags and fault plan (the out-of-memory error constructed, not
    provoked), the IVF crossover lowered so "auto" takes IVF as on the
    main path."""
    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from graphmine_tpu_torch.pipeline.config import parse_args
    from graphmine_tpu_torch.testing import faults

    monkeypatch.setenv("GRAPHMINE_LOF_IVF_MIN_N", "1024")
    src, dst, _, _ = datasets.planted_anomaly_graph(2048, 20_000, seed=9)
    parquet = tmp_path / "edges.parquet"
    chip_smoke.write_parquet(parquet, src, dst, 2048)
    plain = run_pipeline(PipelineConfig(data_path=str(parquet), batch_rows=chip_smoke.BATCH_ROWS,
                                        device="cpu"))
    phase5 = {"labels": plain.labels, "flags": plain.outliers.outlier_vertices,
              "features": plain.features}
    work = tmp_path / "h"
    work.mkdir()
    cfg = parse_args(chip_smoke.harness_flags(work, parquet) + ["--device", "cpu"])
    with chip_smoke._planted([("lpa_superstep", faults.transient_error, 3),
                              ("outliers_lof", lambda: faults.device_oom("cpu"), 1)]).installed():
        res = run_pipeline(cfg)
    records = chip_smoke._jsonl(work / "metrics.jsonl")
    # the card's launch counts cannot be had here
    chip_smoke.check_harness(res, records, work, phase5, {"knn_topk": 2})
    line = chip_smoke.harness_summary(records, 1.5, 123, {"knn_topk": 2})
    json.dumps(line)
    assert line["run_id"] == "smoke-5c" and line["records"]["checkpoint_save"] == 5
    assert line["heartbeats"] >= 0 and line["checkpoint_bytes"] > 0
    assert len(line["checkpoint_save_seconds"]) == 5
    assert line["predicted_peak_bytes"] > 0 and line["max_memory_allocated"] == 123
    assert set(line["phase_seconds"]) >= {"load", "build_graph", "lpa", "census",
                                          "outliers_recursive_lpa", "features",
                                          "outliers_lof", "snapshot_publish"}
    assert line["top_kernels"] == [] and line["profile_trace"].endswith(".json")
    with pytest.raises(RuntimeError, match="labels differ"):
        chip_smoke.check_harness(res, records, work, {**phase5, "labels": phase5["labels"] + 1},
                                 {"knn_topk": 2})
