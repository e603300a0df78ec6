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
from _torch_threads import one_torch_thread  # noqa: F401


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


def _serving_stores(tmp_path, v=1024, e=9000):
    """Two copies of a port publish of a small planted graph (the exact
    kNN), as phases 4 and 5 leave their stores."""
    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline

    src, dst, _, _ = datasets.planted_anomaly_graph(v, e, seed=9)
    chip_smoke.write_edge_list(tmp_path / "e.txt", src, dst)
    run_pipeline(PipelineConfig(data_path=str(tmp_path / "e.txt"), data_format="edgelist",
                                lof_impl="exact", lof_k=16, device="cpu",
                                snapshot_out=str(tmp_path / "store_a")))
    shutil.copytree(tmp_path / "store_a", tmp_path / "store_b")
    return tmp_path / "store_a", tmp_path / "store_b"


def test_serving_phase_checks_and_line_on_a_cpu_run(tmp_path):
    """Phase 7's checks and its ``serve`` line on the CPU at a small size:
    7a between two CPU servers, 7b on the CPU with fewer reads."""
    small_store, full_store = _serving_stores(tmp_path)
    small = chip_smoke.serve_compare(small_store, tmp_path, devices=("cpu", "cpu"))
    assert small["vertices"] == 1024 and small["versions"] == [4, 4]
    assert [d["version"] for d in small["deltas"]] == [2, 3, 4]
    assert small["shed"]["verdict"] == "shed" and "150000" in small["shed"]["reason"]
    line = chip_smoke.serve_full(full_store, device="cpu", query_reps=3, vertex_gets=8)
    json.dumps(line)
    assert line["vertices"] == 1024 and line["store_bytes"] > 0
    assert [d["delta"] for d in line["deltas"]] == ["lof_bootstrap", "0.0005_of_E"]
    assert [d["version"] for d in line["deltas"]] == [2, 3]
    for d in line["deltas"]:
        assert d["verdict"] == "accept" and d["repair_method"] in ("warm", "full_recompute")
        assert d["apply_seconds"] >= d["delta_apply_seconds"] > 0
    assert line["deltas"][1]["inserts"] == max(8, int(line["edges"] * 0.0005))
    assert line["reader"]["errors"] == 0 and line["reader"]["answers"] > 0
    assert set(line["query"]) >= {"p50_us", "p99_us", "lookups_per_s", "stages"}
    assert line["shed"]["verdict"] == "shed"


def test_check_publish_refuses_a_wrong_cc_and_a_broken_chain(tmp_path):
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    store_a, _ = _serving_stores(tmp_path, v=256, e=1500)
    store = SnapshotStore(str(store_a))
    parent = store.load()
    arrays = {k: np.asarray(parent[k]) for k in parent.arrays}
    snap = store.publish(arrays, fingerprint=parent.fingerprint)
    chip_smoke.check_publish(snap, parent, "full_recompute", "cpu")
    with pytest.raises(RuntimeError, match="version chain"):
        chip_smoke.check_publish(snap, snap, "full_recompute", "cpu")
    bad = dict(arrays, cc_labels=np.arange(len(arrays["labels"]), dtype=np.int32))
    snap2 = store.publish(bad, fingerprint=parent.fingerprint)
    with pytest.raises(RuntimeError, match="CC labels differ"):
        chip_smoke.check_publish(snap2, snap, "full_recompute", "cpu")


def test_kernels_entries_carry_the_serving_launches():
    entries = [{"name": "knn_topk", "instance": i, "launches": 1} for i in ("fast", "general", "wide")]
    out = chip_smoke.with_serving_launches(entries, {"knn_topk": 7, "knn_topk_fast": 7,
                                                     "knn_topk_general": 0, "knn_topk_wide": 0})
    assert [e["serving_launches"] for e in out] == [7, 0, 0]
    assert [e["launches"] for e in out] == [1, 1, 1]


# ---- phases 7c and 7d: the replicated serving plane -------------------------


def test_canary_launches_count_the_replicas_canary_records(tmp_path):
    a, b = tmp_path / "serve-1.jsonl", tmp_path / "standby-2.jsonl"
    recs = [{"phase": "canary_score", "version": 2}, {"phase": "delta_apply"},
            {"phase": "canary_score", "version": 3}]
    a.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    b.write_text(json.dumps({"phase": "canary_score", "version": 4}) + "\n\n")
    assert chip_smoke.canary_launches([a, b]) == 3
    assert chip_smoke.canary_launches([]) == 0


def test_fleet_line_must_carry_every_key():
    line = {k: 0 for k in chip_smoke.FLEET_KEYS}
    assert chip_smoke.check_fleet_line(line) is line
    json.dumps(line)
    del line["promote_seconds"]
    with pytest.raises(RuntimeError, match="promote_seconds"):
        chip_smoke.check_fleet_line(line)


def test_banners_parse_the_serve_and_fleet_cli_lines():
    assert chip_smoke.banner_port(
        "serving snapshot v3 on http://127.0.0.1:40123 [writer (WAL-durable), epoch 0, "
        "device cuda]") == 40123
    port, pids = chip_smoke.fleet_banner(
        "fleet: 3 replica(s) behind http://127.0.0.1:8400 (writer replica-0 on port 8450, "
        "standby replica-1 log-shipping its WAL; replica pids [11, 12, 13])")
    assert (port, pids) == (8400, [11, 12, 13])


class _Proc:
    def __init__(self, stubborn=False, done=False):
        self.pid, self.stubborn, self.calls = 999_999, stubborn, []
        self.returncode = 0 if done else None

    def poll(self):
        return self.returncode

    def terminate(self):
        self.calls.append("terminate")
        if not self.stubborn:
            self.returncode = -15

    def kill(self):
        self.calls.append("kill")
        self.returncode = -9

    def wait(self, timeout=None):
        if self.returncode is None:
            raise subprocess.TimeoutExpired("p", timeout)
        return self.returncode


def test_processes_stop_every_one_when_a_phase_fails():
    procs = chip_smoke.Processes(grace_s=0.01)
    polite, stubborn, done = _Proc(), _Proc(stubborn=True), _Proc(done=True)
    with pytest.raises(RuntimeError, match="the phase failed"):
        with procs:
            procs.procs += [(polite, False), (stubborn, False), (done, False)]
            chip_smoke.require(False, "the phase failed")
    assert polite.calls == ["terminate"] and stubborn.calls == ["terminate", "kill"]
    assert done.calls == [] and procs.procs == []
    assert all(p.returncode is not None for p in (polite, stubborn, done))


def test_banner_fails_when_the_process_exits_first(tmp_path):
    log = tmp_path / "x.log"
    log.write_text("Traceback: no CUDA\n")
    with pytest.raises(RuntimeError, match="exited"):
        chip_smoke.banner(log, chip_smoke.SERVE_BANNER, _Proc(done=True), timeout=5)
    with pytest.raises(RuntimeError, match="timed out"):
        chip_smoke.banner(log, chip_smoke.SERVE_BANNER, _Proc(), timeout=0.2)
    log.write_text("warn\nserving snapshot v1 on http://127.0.0.1:5 [writer]\n")
    assert chip_smoke.banner(log, chip_smoke.SERVE_BANNER, _Proc(), timeout=5).endswith(
        "[writer]")


def test_edge_keys_are_a_multiset():
    a = chip_smoke.edge_keys([3, 1, 1], [2, 5, 5])
    b = chip_smoke.edge_keys([1, 3, 1], [5, 2, 5])
    assert np.array_equal(a, b)
    assert not np.array_equal(a, chip_smoke.edge_keys([1, 3], [5, 2]))


def test_sharded_and_small_deltas_on_a_cpu_store(tmp_path):
    """7c's in-process part at a small size on the CPU: a ``writer_shards
    = 2`` server and a ``writer_shards = 1`` one publish the same arrays,
    with the shard records."""
    store, _ = _serving_stores(tmp_path, v=256, e=1500)
    out = chip_smoke.sharded_compare(store, tmp_path, devices=("cpu", "cpu"))
    assert out["version"] == 4 and out["epoch"] == 3
    assert out["epoch_commits"] == 3 and out["shard_publishes"] == 6
    assert len(out["repairs"]) == 3


def test_device_file_and_driver_probes_read_proc(tmp_path):
    """The router check's probes: a process without CUDA holds no
    ``/dev/nvidia*`` file; a gone pid reads as nothing."""
    import os

    assert chip_smoke.nvidia_fds(os.getpid()) == [] or torch.cuda.is_initialized()
    assert chip_smoke.nvidia_fds(2 ** 22 + 7) == []
    assert chip_smoke.libcuda_mapped(2 ** 22 + 7) is False


def test_failover_timeline_reads_the_records(tmp_path):
    kill = 1000.0
    recs = [{"phase": "replica_health", "t": 999.0, "replica": "replica-0", "to_state": "down"},
            {"phase": "replica_health", "t": 1000.7, "replica": "replica-0", "to_state": "down"},
            {"phase": "fleet_degraded", "t": 1000.71, "read_only": True},
            {"phase": "wal_replay", "t": 1001.0, "entries": 1, "from_seq": 2},
            {"phase": "writer_promote", "t": 1001.0, "epoch": 1, "replayed": 1, "seconds": 0.3,
             "copied_tail": 1},
            {"phase": "writer_promote", "t": 1001.01, "epoch": 1, "replica": "replica-1"},
            {"phase": "fleet_degraded", "t": 1001.02, "read_only": False}]
    path = tmp_path / "router-1.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in recs))
    out = chip_smoke.failover_timeline([path], kill)
    assert out["replica-0_down_s"] == 0.7 and out["read_only_s"] == 0.71
    assert out["writable_s"] == 1.02 and out["replay"] == {"after_kill_s": 1.0, "entries": 1}
    assert out["server_promote"]["seconds"] == 0.3 and out["router_promote"]["epoch"] == 1


def test_parses_community_only():
    assert chip_smoke.parse_args(["--community-only"]).community_only
    assert not chip_smoke.parse_args([]).community_only
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--community-only", "--kernels-only"])


def test_community_only_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the smoke would run")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--community-only"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


@pytest.fixture(scope="module")
def community_runs(tmp_path_factory):
    """Two CPU runs of each community method on one small planted graph
    (phase 8a's check compares the card's run with the CPU's)."""
    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline

    src, dst, _, _ = datasets.planted_anomaly_graph(512, 5_000, seed=3)
    path = tmp_path_factory.mktemp("phase8") / "small.txt"
    chip_smoke.write_edge_list(path, src, dst)
    runs = {}
    for method in ("louvain", "leiden"):
        cfg = dict(data_path=str(path), data_format="edgelist", community_method=method,
                   outlier_method="both", lof_k=16, lof_impl="exact", device="cpu")
        runs[method] = (run_pipeline(PipelineConfig(**cfg)), run_pipeline(PipelineConfig(**cfg)))
    return runs


def test_community_check_passes_equal_runs_and_fails_a_swapped_label(community_runs):
    import copy

    for method, (a, b) in community_runs.items():
        assert chip_smoke.check_community(a, b, method) == {"q_abs_diff": 0.0,
                                                            "lof_max_rel_diff": 0.0}
        assert abs(chip_smoke.community_q(a) - a.metrics.of_phase("communities")[0][
            "modularity"]) <= 1e-6
        swapped = copy.copy(b)
        swapped.labels = b.labels.copy()
        i = int(np.flatnonzero(b.labels != b.labels[0])[0])
        swapped.labels[[0, i]] = swapped.labels[[i, 0]]
        with pytest.raises(RuntimeError, match="labels differ"):
            chip_smoke.check_community(a, swapped, method)


@pytest.fixture(scope="module")
def cpu_ops(community_runs):
    (lv, _), (ld, _) = community_runs["louvain"], community_runs["leiden"]
    graph, digraph, sp_w = chip_smoke._op_graphs(lv.edge_table, "cpu", weighted=False)
    outputs, seconds = chip_smoke.graph_ops(graph, digraph, sp_w, lv.labels, ld.labels)
    return outputs, seconds, graph.num_vertices


def test_ops_check_passes_equal_outputs_and_fails_a_swap_or_a_missing_op(cpu_ops):
    import copy

    outputs, _, _ = cpu_ops
    chip_smoke.check_ops(outputs, copy.deepcopy(outputs), "cpu")
    bad = copy.deepcopy(outputs)
    scc = bad["strongly_connected_components"]
    i = int(np.flatnonzero(scc != scc[0])[0])
    scc[[0, i]] = scc[[i, 0]]
    with pytest.raises(RuntimeError, match="strongly_connected_components"):
        chip_smoke.check_ops(bad, outputs, "cpu")
    bad = copy.deepcopy(outputs)
    del bad["pregel"]
    with pytest.raises(RuntimeError, match="pregel"):
        chip_smoke.check_ops(bad, outputs, "cpu")
    near = copy.deepcopy(outputs)
    near["aggregate_messages"] = near["aggregate_messages"] * np.float32(1 + 1e-7)
    chip_smoke.check_ops(near, outputs, "cpu")
    far = copy.deepcopy(outputs)
    far["aggregate_messages"] = far["aggregate_messages"] * np.float32(1.01)
    with pytest.raises(RuntimeError, match="aggregate_messages"):
        chip_smoke.check_ops(far, outputs, "cpu")


def test_ops_line_and_full_size_invariants(cpu_ops):
    import copy

    outputs, seconds, v = cpu_ops
    chip_smoke.check_full_ops(outputs, v)
    line = chip_smoke.ops_line(outputs, seconds)
    json.dumps(line)
    assert sorted(line["seconds"]) == sorted(chip_smoke.OPS)
    assert line["scc_count"] >= 1 and line["diameter"] >= 1 and line["motif_matches"] > 0
    with pytest.raises(RuntimeError, match="core_numbers"):
        chip_smoke.ops_line(outputs, {k: s for k, s in seconds.items() if k != "core_numbers"})
    bad = copy.deepcopy(outputs)
    dist, parent = bad["bfs_parents"]
    reached = np.flatnonzero((dist > 0) & (dist < 2 ** 31 - 1))
    parent[reached[0]] = reached[0]
    with pytest.raises(RuntimeError, match="parents"):
        chip_smoke.check_full_ops(bad, v)


def test_community_line_must_carry_every_key():
    line = {k: 0 for k in chip_smoke.COMMUNITY_KEYS}
    assert chip_smoke.check_community_line(line) is line
    del line["louvain_q"]
    with pytest.raises(RuntimeError, match="louvain_q"):
        chip_smoke.check_community_line(line)


def test_level0_breakdown_on_a_cpu_graph(community_runs):
    (lv, _) = community_runs["louvain"]
    out = chip_smoke.level0_breakdown(lv.graph)
    json.dumps(out)
    assert out["padded_messages"] >= lv.graph.num_messages
    assert out["padded_vertices"] >= lv.graph.num_vertices
    assert 1 <= out["communities_after"] < lv.graph.num_vertices
    assert min(v for k, v in out.items() if k.endswith("seconds")) >= 0


def test_parses_frames_only():
    assert chip_smoke.parse_args(["--frames-only"]).frames_only
    assert not chip_smoke.parse_args([]).frames_only
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--frames-only", "--community-only"])


def test_frames_only_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the smoke would run")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--frames-only"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


@pytest.fixture(scope="module")
def frames_cpu(tmp_path_factory):
    """Phase 9's ops on a small planted graph on the CPU, at the small
    size (9a) and at the full size's settings with fewer pairs (9b)."""
    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.frames import GraphFrame
    from graphmine_tpu_torch.io.edges import load_edge_list

    src, dst, _, _ = datasets.planted_anomaly_graph(600, 8_000, seed=3)
    path = tmp_path_factory.mktemp("phase9") / "small.txt"
    chip_smoke.write_edge_list(path, src, dst, np.random.default_rng(7).integers(1, 16, len(src)) / 4)
    table = load_edge_list(str(path), weight_col=2)
    gf = GraphFrame.from_edge_table(table, device="cpu")
    small, small_s = chip_smoke.frames_ops(gf, chip_smoke.frames_inputs(gf, "small", table.weights),
                                           "small")
    pairs = dict(chip_smoke.LINK_PAIRS)
    chip_smoke.LINK_PAIRS["full"] = 2_000
    try:
        inputs = chip_smoke.frames_inputs(gf, "full")
    finally:
        chip_smoke.LINK_PAIRS.clear()
        chip_smoke.LINK_PAIRS.update(pairs)
    full, full_s = chip_smoke.frames_ops(gf, inputs, "full")
    return gf, small, small_s, full, inputs


def test_frames_small_check_passes_equal_outputs_and_fails_a_swap_or_a_missing_op(frames_cpu):
    import copy

    _, small, seconds, _, _ = frames_cpu
    assert sorted(seconds) == sorted(chip_smoke.FRAMES_OPS)
    diffs = chip_smoke.check_frames_small(small, copy.deepcopy(small))
    assert diffs["spectral_embedding"] >= 0.9999 and diffs["pagerank"] == 0.0
    bad = copy.deepcopy(small)
    colors = bad["greedy_color"]
    i = int(np.flatnonzero(colors != colors[0])[0])
    colors[[0, i]] = colors[[i, 0]]
    with pytest.raises(RuntimeError, match="greedy_color"):
        chip_smoke.check_frames_small(bad, small)
    bad = copy.deepcopy(small)
    del bad["k_truss"]
    with pytest.raises(RuntimeError, match="k_truss missing"):
        chip_smoke.check_frames_small(bad, small)
    bad = copy.deepcopy(small)
    bad["betweenness"] = bad["betweenness"] * np.float32(1.01)
    with pytest.raises(RuntimeError, match="betweenness"):
        chip_smoke.check_frames_small(bad, small)
    flipped = copy.deepcopy(small)
    flipped["spectral_embedding"][:, 1] *= -1  # a column's sign is arbitrary
    chip_smoke.check_frames_small(flipped, small)
    bad["spectral_embedding"] = np.roll(bad["spectral_embedding"], 1, axis=1)
    with pytest.raises(RuntimeError, match="embedding"):
        chip_smoke.check_frames_small(dict(small, spectral_embedding=bad["spectral_embedding"]),
                                      small)


def test_frames_full_invariants_pass_and_fail_a_broken_mis_or_colouring(frames_cpu):
    import copy

    gf, _, _, full, inputs = frames_cpu
    graph = gf.graph()
    facts = chip_smoke.check_frames_full(full, graph, inputs)
    assert facts["colors"] >= 2 and facts["mis_size"] >= 1
    assert facts["svdpp_rmse"][1] < facts["svdpp_rmse"][0]
    send, recv = graph.msg_send.numpy(), graph.msg_recv.numpy()
    bad = copy.deepcopy(full)
    mis = bad["mis"]
    edge = np.flatnonzero(mis[send] & (send != recv))[0]
    mis[recv[edge]] = True  # a neighbour of a member joins: not independent
    with pytest.raises(RuntimeError, match="not independent"):
        chip_smoke.check_frames_full(bad, graph, inputs)
    bad = copy.deepcopy(full)
    bad["mis"][:] = False
    with pytest.raises(RuntimeError, match="not maximal"):
        chip_smoke.check_frames_full(bad, graph, inputs)
    bad = copy.deepcopy(full)
    k = np.flatnonzero(send != recv)[0]
    bad["greedy_color"][recv[k]] = bad["greedy_color"][send[k]]
    with pytest.raises(RuntimeError, match="not proper"):
        chip_smoke.check_frames_full(bad, graph, inputs)
    bad = copy.deepcopy(full)
    bad["link_jaccard"] = bad["link_jaccard"] + 0.5
    with pytest.raises(RuntimeError, match="link_jaccard"):
        chip_smoke.check_frames_full(bad, graph, inputs)
    bad = copy.deepcopy(full)
    bad["pagerank"] = bad["pagerank"] * np.float32(1.001)
    with pytest.raises(RuntimeError, match="pagerank sums to"):
        chip_smoke.check_frames_full(bad, graph, inputs)
    a, b = full["k_truss"]
    if len(a):
        with pytest.raises(RuntimeError, match="k-truss"):
            chip_smoke.check_truss(np.concatenate([a, [0]]), np.concatenate([b, [gf.num_vertices - 1]]),
                                   gf.num_vertices, sample=len(a) + 1)


def test_frames_lines_must_carry_every_key():
    for keys, what in ((chip_smoke.FRAMES_KEYS, "frames"),
                       (chip_smoke.FRAMES_SMALL_KEYS, "frames_small"),
                       (chip_smoke.COMPAT_KEYS, "compat")):
        line = {k: 0 for k in keys}
        assert chip_smoke.check_keys(line, keys, what) is line
        missing = keys[-1]
        del line[missing]
        with pytest.raises(RuntimeError, match=missing):
            chip_smoke.check_keys(line, keys, what)


def test_kernels_entries_carry_the_frames_launches():
    entries = [{"instance": "fast", "launches": 1}, {"instance": "general", "launches": 2}]
    out = chip_smoke.with_frames_launches(entries, {"knn_topk_fast": 3, "knn_topk_general": 0})
    assert [e["frames_launches"] for e in out] == [3, 0]
    assert "frames_launches" not in entries[0]


def test_compat_phase_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(chip_smoke, "SHIM_V", 600)
    monkeypatch.setattr(chip_smoke, "SHIM_ROWS", 6_000)
    line = chip_smoke.compat_full(tmp_path, device="cpu")
    json.dumps(line)
    assert line["vertices"] == 600 and line["null_rows"] == chip_smoke.SHIM_NULLS
    assert line["communities"] >= 1 and set(line["stage_seconds"]) >= {"read", "label_propagation"}


def test_same_partition_is_a_grouping_test():
    a = {"x": 1, "y": 1, "z": 2}
    assert chip_smoke.same_partition(a, {"x": 7, "y": 7, "z": 3})
    assert not chip_smoke.same_partition(a, {"x": 7, "y": 8, "z": 3})
    assert not chip_smoke.same_partition(a, {"x": 7, "y": 7, "z": 7})
    assert not chip_smoke.same_partition(a, {"x": 7, "y": 7})


def test_parses_blocked_only():
    assert chip_smoke.parse_args(["--blocked-only"]).blocked_only
    assert not chip_smoke.parse_args([]).blocked_only
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--blocked-only", "--frames-only"])


def test_blocked_only_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the smoke would run")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--blocked-only"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


def test_blocked_small_phase_on_the_cpu(tmp_path):
    """Phase 10a's checks with the CPU in the card's place: plan arrays,
    every superstep against the bucketed one, PageRank, the pipeline on the
    blocked family and its ``single_bucketed`` rung under an OOM."""
    out = chip_smoke.blocked_small(tmp_path, devices=("cpu", "cpu"))
    for case in ("unweighted", "weighted"):
        assert out[case]["bins"] > 1
        assert out[case]["pipeline"] == {**out[case]["pipeline"], "degrade": "single_bucketed",
                                         "plans": ["blocked", "bucketed"]}
    assert out["pagerank_max_rel"] == 0.0


def test_blocked_rung_and_ladder_lines_on_the_cpu():
    """10b at a capped scale and 10c at two small scales on the CPU: the
    lines carry their keys and the families agree."""
    rung = chip_smoke.blocked_rung("cpu", max_scale=11)
    assert set(chip_smoke.BLOCKED_KEYS) <= set(rung)
    assert rung["rung"] == "com-livejournal" and rung["cc"]["iterations"] >= 1
    assert rung["pagerank"]["l1"] <= 1e-5 and rung["tile_alloc_over_m"] >= 1.0
    ladder = chip_smoke.blocked_ladder("cpu", scales=(9, 10), sweep_scale=10, tiles=(128, 512))
    for point in ladder["points"]:
        assert set(chip_smoke.LADDER_KEYS) <= set(point)
        assert point["num_messages"] == 2 * int(8.3 * (1 << point["scale"]))
    assert [s["tile_slots_budget"] for s in ladder["tile_sweep"]] == [128, 512]
    assert ladder["tile_sweep"][0]["bins"] > ladder["tile_sweep"][1]["bins"]


def test_crossover_is_the_smallest_scale_won_from_there_on():
    pts = lambda *wins: [{"scale": 20 + i, "blocked_ms": 1.0 if w else 2.0, "bucketed_ms": 1.5}
                         for i, w in enumerate(wins)]  # noqa: E731
    assert chip_smoke.crossover_scale(pts(True, False, False, False, False)) is None
    assert chip_smoke.crossover_scale(pts(False, True, False, True, True)) == 23
    assert chip_smoke.crossover_scale(pts(True, True, True, True, True)) == 20
    assert chip_smoke.crossover_scale(pts(False, False, False, False, True)) == 24


def test_card_rmat_draws_the_recipe_on_the_device():
    graph, ptr = chip_smoke.rmat_graph(8, 8.3, seed=3, device="cpu")
    assert graph.num_vertices == 256 and graph.num_edges == int(8.3 * 256)
    assert graph.num_messages == 2 * graph.num_edges and ptr[-1] == graph.num_messages
    again, _ = chip_smoke.rmat_graph(8, 8.3, seed=3, device="cpu")
    assert torch.equal(graph.src, again.src) and torch.equal(graph.dst, again.dst)
    deg = np.diff(ptr)
    assert deg.max() > 8 * deg.mean()  # R-MAT's skew: hubs far above the mean


# ---- phase 11: the multi-device pipeline on a virtual mesh ----------------


def test_parses_mesh_only():
    assert chip_smoke.parse_args(["--mesh-only"]).mesh_only
    assert not chip_smoke.parse_args([]).mesh_only
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--mesh-only", "--blocked-only"])


def test_mesh_only_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the smoke would run")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--mesh-only"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


def test_mesh_small_phase_on_the_cpu(tmp_path):
    """Phase 11a with the CPU in the card's place (operators on a
    512-vertex planted graph, pipelines on phase 4's parquet): every gate
    holds, and the checks refuse a result that differs."""
    import copy

    chip_smoke.small_inputs(tmp_path)
    out = chip_smoke.mesh_small(tmp_path, devices=("cpu", "cpu"), size=(512, 4000))
    assert set(out["ops"]) == set(chip_smoke.MESH_SHARDS)
    assert out["pipelines"]["mesh_degrade"]["to_devices"] == 2
    ops = chip_smoke.mesh_ops_small("cpu", shards=(2,), v=256, e=2000)
    bad = copy.deepcopy(ops)
    bad["mesh"][2]["ring_lpa"][0] += 1
    with pytest.raises(RuntimeError, match="ring_lpa"):
        chip_smoke.check_mesh_ops(ops, bad)
    bad = copy.deepcopy(ops)
    bad["mesh"][2]["partition"]["msg_send"][0, 0] += 1
    with pytest.raises(RuntimeError, match="partition msg_send"):
        chip_smoke.check_mesh_ops(ops, bad)


def test_superstep_points_agree_on_the_cpu(monkeypatch):
    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.graph.container import build_graph

    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "4")
    src, dst, _, _ = datasets.planted_anomaly_graph(1024, 8000, seed=9)
    g = build_graph(src, dst, num_vertices=1024, device="cpu")
    labels = torch.arange(1024, dtype=torch.int32)
    points = [chip_smoke.superstep_point(g, labels, s, d, device="cpu")
              for s in ("replicated", "ring") for d in (1, 4)]
    ref = points[0]["labels"]
    for p in points:
        assert torch.equal(p["labels"], ref) and p["ms"] > 0
        assert p["predicted_bytes"] == p["predicted_bytes_per_shard"] * p["devices"]
    assert [p["family"] for p in points] == ["bucketed", "bucketed", "sort", "sort"]


# ---- phase 12: the serving plane's sharded repair on a virtual mesh --------


def test_parses_serve_mesh_only():
    assert chip_smoke.parse_args(["--serve-mesh-only"]).serve_mesh_only
    assert not chip_smoke.parse_args([]).serve_mesh_only
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--serve-mesh-only", "--mesh-only"])


def test_serve_mesh_only_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the smoke would run")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--serve-mesh-only"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


def test_serve_mesh_lines_and_launches():
    for keys, what in ((chip_smoke.SERVE_MESH_KEYS, "serve_mesh"),
                       (chip_smoke.SERVE_MESH_SMALL_KEYS, "serve_mesh_small")):
        line = {k: 0 for k in keys}
        assert chip_smoke.check_keys(line, keys, what) is line
        del line[keys[-1]]
        with pytest.raises(RuntimeError, match=keys[-1]):
            chip_smoke.check_keys(line, keys, what)
    entries = [{"instance": "fast", "launches": 1}, {"instance": "wide", "launches": 0}]
    out = chip_smoke.with_serve_mesh_launches(entries, {"knn_topk_fast": 8,
                                                        "knn_topk_wide": 0})
    assert [e["serve_mesh_launches"] for e in out] == [8, 0]
    assert "serve_mesh_launches" not in entries[0]


def test_small_deltas_skip_ids_are_7a_draw():
    """With ``skip_ids=257`` the deltas are 7a's own: the 257 read ids are
    drawn first from the same generator."""
    snap = {"labels": np.zeros(50), "src": np.arange(40), "dst": np.arange(40)[::-1]}
    rng = np.random.default_rng(5)
    rng.integers(0, 50, 257)
    pick = rng.integers(0, 40, 24)
    got = chip_smoke.small_deltas(snap, seed=5, skip_ids=257)
    assert got[1]["delete"] == [[int(i), int(39 - i)] for i in pick[:12]]
    assert got != chip_smoke.small_deltas(snap, seed=5)


def test_serve_mesh_phase_on_the_cpu(tmp_path, monkeypatch):
    """Phase 12 with the CPU in the card's place, on a 512-vertex planted
    store standing for both phase 4's and phase 5's: every gate holds, the
    child process's included; the CPU side's check refuses a publish or an
    apply that differs."""
    import copy

    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.lpa import label_propagation
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline

    src, dst, _, _ = datasets.planted_anomaly_graph(512, 5000, seed=9)
    edges = tmp_path / "small.txt"
    chip_smoke.write_edge_list(edges, src, dst)
    run_pipeline(PipelineConfig(data_path=str(edges), data_format="edgelist",
                                lof_impl="exact", lof_k=16, device="cpu",
                                snapshot_out=str(tmp_path / "store_cuda")))
    shutil.copytree(tmp_path / "store_cuda", tmp_path / "store")
    ref = chip_smoke.store_arrays(tmp_path / "store")
    g = build_graph(ref["src"], ref["dst"], num_vertices=len(ref["labels"]), device="cpu")
    ref["labels"] = label_propagation(g, max_iter=5).numpy()
    for name in ("serve_mesh_small", "serve_mesh_full", "serve_mesh_repair"):
        fn = getattr(chip_smoke, name)
        monkeypatch.setattr(chip_smoke, name, lambda *a, _fn=fn: _fn(*a, "cpu"))
    assert chip_smoke.run_serve_mesh(tmp_path, {"store_arrays": ref})["knn_topk"] == 0

    # the CPU side's outputs, held against themselves, then against changes
    class Done:
        def wait(self, timeout):
            return 0

    out = tmp_path / "s12a_cpu"
    runs = {}
    for fam in chip_smoke.SERVE_MESH_FAMILY_ENV:
        rec = json.loads((out / f"{fam}.json").read_text())
        runs[fam] = {"applies": rec["applies"], "exchange": rec["exchange"],
                     "snaps": [dict(np.load(out / f"{fam}.npz"))]}
    job = (Done(), out, tmp_path / "s12a_cpu.log")
    got = chip_smoke.check_cpu_chains(job, runs)
    assert set(got["seconds"]) == {"one", *runs} and len(got["one_shard"]) == 3
    bad = copy.deepcopy(runs)
    bad["sort"]["snaps"][0]["labels"][0] += 1
    with pytest.raises(RuntimeError, match="sort: labels"):
        chip_smoke.check_cpu_chains(job, bad)
    bad = copy.deepcopy(runs)
    bad["sharded_2d"]["applies"][0]["iterations"] += 1
    with pytest.raises(RuntimeError, match="sharded_2d"):
        chip_smoke.check_cpu_chains(job, bad)


def test_parses_dist_only():
    assert chip_smoke.parse_args(["--dist-only"]).dist_only
    assert not chip_smoke.parse_args([]).dist_only
    with pytest.raises(SystemExit):
        chip_smoke.parse_args(["--dist-only", "--mesh-only"])


def test_dist_only_exits_nonzero_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the smoke would run")
    out = subprocess.run([sys.executable, "chip_smoke.py", "--dist-only"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "CUDA is not available" in out.stderr


def test_dist_scale_check_holds_labels_and_backend(tmp_path):
    """13b's check: each rank's labels and CC equal the reference's, the
    virtual gloo world as asked; a changed label or another backend fails."""
    ref = {"labels": np.arange(6, dtype=np.int32), "cc_labels": np.zeros(6, np.int32)}
    rank = {"labels": ref["labels"], "cc": ref["cc_labels"], "cc_supersteps": 3,
            "lpa_ms": [1.0, 2.0, 3.0], "exchange_ms": [0.5], "build_seconds": 0.1,
            "partition_seconds": 0.2, "peak_bytes": 10, "num_messages": 12,
            "backend": "gloo", "virtual": True}
    for r in range(chip_smoke.DIST_SCALE_RANKS):
        np.savez(tmp_path / f"rank{r}.npz", **rank)
    line = chip_smoke.check_scale(tmp_path, ref)
    assert chip_smoke.check_keys(line, chip_smoke.DIST_SCALE_KEYS, "dist scale") is line
    assert line["lpa_ms"] == [2.0] * chip_smoke.DIST_SCALE_RANKS and line["cc_supersteps"] == 3
    with pytest.raises(RuntimeError, match="virtual"):
        chip_smoke.check_scale(tmp_path, ref, virtual=False)
    np.savez(tmp_path / "rank1.npz", **{**rank, "labels": ref["labels"][::-1]})
    with pytest.raises(RuntimeError, match="rank 1: 5 LPA supersteps"):
        chip_smoke.check_scale(tmp_path, ref)
