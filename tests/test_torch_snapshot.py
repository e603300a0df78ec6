"""Port parity: the snapshot publish and the snapshot store (CPU).

Both packages run their default pipeline on one parquet file with
``snapshot_out``. A store that the port publishes loads in the JAX
``SnapshotStore`` and the other way round, under each package's own graph
fingerprint (equal, since the ids are). ``labels``, ``cc_labels``, the
census, the edges and the canary probe's arrays are bit-equal; ``lof``
agrees to rtol 1e-4 on 99.9% of vertices and 1e-2 on all (the tolerance of
the port's default-config parity tests). The store's own machinery is
held on the port's side: ``.prev`` rollback on a corrupted manifest,
fingerprint refusal without rollback, the writer-epoch fence, tenants.
"""

import json
import os
import threading

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from graphmine_tpu.pipeline import checkpoint as jckpt
from graphmine_tpu.pipeline.checkpoint import graph_fingerprint as jgraph_fingerprint
from graphmine_tpu.pipeline.config import PipelineConfig as JPipelineConfig
from graphmine_tpu.pipeline.driver import run_pipeline as jrun_pipeline
from graphmine_tpu.serve.snapshot import SnapshotStore as JSnapshotStore

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.obs.quality import CanaryProbe, partition_churn, run_quality_pass
from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline, resilience
from graphmine_tpu_torch.pipeline import checkpoint as ckpt
from graphmine_tpu_torch.pipeline.checkpoint import (
    CheckpointCorruptionError,
    FingerprintMismatch,
    graph_fingerprint,
)
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from graphmine_tpu_torch.serve import snapshot as snapshot_mod
from graphmine_tpu_torch.serve.snapshot import PublishFencedError, SnapshotStore

LOF_K = 32
EXACT = ("src", "dst", "labels", "cc_labels", "census_present", "census_sizes",
         "census_edges", "canary_features", "canary_is_anomaly")


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("snap")
    src, dst, _, _ = datasets.planted_anomaly_graph(2048, 24_000, seed=4)
    path = root / "edges.parquet"
    pq.write_table(pa.table({"_c1": pa.array(src.astype(str)).dictionary_encode(),
                             "_c2": pa.array(dst.astype(str)).dictionary_encode()}), path)
    ref = jrun_pipeline(JPipelineConfig(data_path=str(path), num_devices=1, lof_k=LOF_K,
                                        snapshot_out=str(root / "jax_store")))
    port = run_pipeline(PipelineConfig(data_path=str(path), lof_k=LOF_K, device="cpu",
                                       snapshot_out=str(root / "port_store")))
    return ref, port, root


def _lof_close(got, want):
    rel = np.abs(got - want) / np.abs(want)
    assert (rel <= 1e-4).mean() >= 0.999 and rel.max() <= 1e-2, rel.max()


def test_fingerprints_equal(stores):
    ref, port, _ = stores
    fp = graph_fingerprint(port.edge_table.src, port.edge_table.dst, port.edge_table.weights)
    assert fp == jgraph_fingerprint(ref.edge_table.src, ref.edge_table.dst, ref.edge_table.weights)


@pytest.mark.parametrize("direction", ["port_store_in_jax", "jax_store_in_port"])
def test_stores_cross_load(stores, direction):
    ref, port, root = stores
    fp = graph_fingerprint(port.edge_table.src, port.edge_table.dst)
    if direction == "port_store_in_jax":
        loaded = JSnapshotStore(str(root / "port_store")).load(fingerprint=fp)
        own = SnapshotStore(str(root / "jax_store")).load(fingerprint=fp)
    else:
        loaded = SnapshotStore(str(root / "jax_store")).load(fingerprint=fp)
        own = JSnapshotStore(str(root / "port_store")).load(fingerprint=fp)
    assert loaded.version == own.version == 1 and loaded.fingerprint == own.fingerprint == fp
    assert sorted(loaded.arrays) == sorted(own.arrays)
    for name in EXACT:
        np.testing.assert_array_equal(loaded[name], own[name], err_msg=name)
        assert loaded[name].dtype == own[name].dtype
    _lof_close(own["lof"], loaded["lof"])
    assert loaded.meta["canary"] == own.meta["canary"]
    for key in ("format_version", "writer_epoch", "mesh_shape", "parent"):
        assert loaded.meta[key] == own.meta[key], key


def test_published_arrays_are_the_runs(stores):
    ref, port, root = stores
    snap = SnapshotStore(str(root / "port_store")).load()
    np.testing.assert_array_equal(snap["labels"], port.labels)
    np.testing.assert_array_equal(snap["labels"], np.asarray(ref.labels))
    np.testing.assert_array_equal(snap["lof"], port.lof)
    (cc,) = port.metrics.of_phase("cc_summary")
    sizes = np.bincount(snap["cc_labels"])
    assert cc["components"] == int((sizes > 0).sum()) and cc["largest"] == int(sizes.max())
    # every CC label is the smallest vertex of its component
    assert (snap["cc_labels"] <= np.arange(len(snap["cc_labels"]))).all()


def test_publish_records_match_the_jax_package(stores):
    ref, port, _ = stores
    jrec = lambda phase: [r for r in ref.metrics.records if r["phase"] == phase]
    (canary,) = port.metrics.of_phase("canary_score")
    (jcanary,) = jrec("canary_score")
    for key in ("recall_at_k", "recall_k", "num_anomalies", "num_probe_vertices", "k"):
        assert canary[key] == jcanary[key], key
    assert canary["mean_rank_frac"] == pytest.approx(jcanary["mean_rank_frac"], abs=1e-3)
    (qs,) = port.metrics.of_phase("quality_snapshot")
    (jqs,) = jrec("quality_snapshot")
    for key in ("num_vertices", "num_communities", "largest_community", "anomaly_count",
                "size_sketch"):
        assert qs[key] == jqs[key], key
    cc_sel = [r for r in port.metrics.of_phase("impl_selected") if r["op"] == "cc_superstep"]
    jcc_sel = [r for r in jrec("impl_selected") if r["op"] == "cc_superstep"]
    assert [r["impl"] for r in cc_sel] == [r["impl"] for r in jcc_sel]
    publish = [r for r in port.metrics.of_phase("snapshot_publish") if "bytes" in r]
    assert len(publish) == 1 and publish[0]["version"] == 1 and publish[0]["bytes"] > 0
    assert port.metrics.phase_seconds()["snapshot_publish"] > 0


def test_second_publish_chains_and_measures_drift(stores, tmp_path):
    _, port, root = stores
    store = SnapshotStore(str(tmp_path / "s"))
    base = {"labels": port.labels, "lof": port.lof}
    store.publish(dict(base), fingerprint="f")
    sink = MetricsSink()
    snap = store.publish({"labels": port.labels[::-1].copy(), "lof": port.lof}, fingerprint="f",
                         sink=sink)
    first = store.load()
    assert snap.version == first.version == 2 and snap.parent.startswith("000001-")
    report = run_quality_pass(snap["labels"], snap["lof"], 2, parent_labels=port.labels,
                              parent_lof=port.lof, sink=sink, device="cpu")
    assert report.drift["churn_frac"] == partition_churn(port.labels, snap["labels"]) > 0
    assert [r["phase"] for r in sink.records] == ["snapshot_publish", "quality_snapshot",
                                                   "quality_drift"]


def test_corrupted_manifest_rolls_back_to_prev(tmp_path):
    store = SnapshotStore(str(tmp_path))
    store.publish({"x": np.arange(5)}, fingerprint="f")
    store.publish({"x": np.arange(6)}, fingerprint="f")
    man = tmp_path / "snapshot" / "manifest.json"
    body = json.loads(man.read_text())
    body["version"] = 99  # parses, fails its checksum
    man.write_text(json.dumps(body))
    sink = MetricsSink()
    snap = store.load(fingerprint="f", sink=sink)
    assert snap.version == 1 and snap["x"].tolist() == list(range(5))
    assert [r["phase"] for r in sink.records] == ["checkpoint_rollback", "checkpoint_rollback_ok",
                                                   "snapshot_load"]
    assert (tmp_path / "snapshot.corrupt").is_dir() and not (tmp_path / "snapshot.prev").exists()
    # the JAX store reads the rolled-back store the same way
    assert JSnapshotStore(str(tmp_path)).load(fingerprint="f").version == 1
    # with no previous generation left, damage is an error
    (tmp_path / "snapshot" / "x.npy").write_bytes(b"junk")
    with pytest.raises(CheckpointCorruptionError):
        store.load()


def test_wrong_fingerprint_refused_without_rollback(tmp_path):
    store = SnapshotStore(str(tmp_path))
    store.publish({"x": np.arange(3)}, fingerprint="f1")
    store.publish({"x": np.arange(4)}, fingerprint="f1")
    with pytest.raises(FingerprintMismatch):
        store.load(fingerprint="f2")
    assert store.peek_version() == 2 and not list(tmp_path.glob("snapshot.corrupt*"))
    assert store.load(fingerprint="f1")["x"].tolist() == [0, 1, 2, 3]


def test_fenced_publish_refused(tmp_path):
    store = SnapshotStore(str(tmp_path))
    store.publish({"x": np.arange(3)})
    assert store.current_epoch() == 0
    sink = MetricsSink()
    assert store.advance_epoch(sink=sink, reason="promotion") == 1
    with pytest.raises(PublishFencedError):
        store.publish({"x": np.arange(4)}, epoch=0, sink=sink)
    assert [r["phase"] for r in sink.records] == ["writer_promote", "publish_fenced"]
    assert store.peek_version() == 1
    snap = store.publish({"x": np.arange(4)}, epoch=1)
    assert snap.writer_epoch == 1 and JSnapshotStore(str(tmp_path)).current_epoch() == 1
    with pytest.raises(ValueError, match="monotonic"):
        store.fence_epoch(0)


def test_fence_rechecked_at_commit(tmp_path):
    # a promotion that lands while a publish writes its arrays fences it at
    # the commit rename: the seam before the commit raises the epoch
    store = SnapshotStore(str(tmp_path))
    store.publish({"x": np.arange(2)})
    resilience.set_fault_hook(lambda site, **ctx: site == "snapshot_publish_commit"
                              and store.advance_epoch())
    try:
        with pytest.raises(PublishFencedError, match="commit"):
            store.publish({"x": np.arange(3)}, epoch=0)
    finally:
        resilience.set_fault_hook(None)
    assert store.load()["x"].tolist() == [0, 1] and not list(tmp_path.glob("snapshot.tmp.*"))


def test_tenants_and_peeks(tmp_path):
    store = SnapshotStore(str(tmp_path))
    acme = store.for_tenant("acme")
    acme.publish({"labels": np.arange(4, dtype=np.int32)}, fingerprint="a")
    store.publish({"labels": np.zeros(2, np.int32)})
    assert store.list_tenants() == ["default", "acme"]
    assert acme.root == os.path.join(str(tmp_path), "tenants", "acme")
    arrays, meta = acme.peek_arrays(("labels", "missing"))
    assert arrays["labels"].tolist() == [0, 1, 2, 3] and meta["version"] == 1
    assert JSnapshotStore(str(tmp_path), tenant="acme").load(fingerprint="a").version == 1
    for bad in ("../x", "A", ""):
        with pytest.raises(ValueError):
            store.for_tenant(bad)
    with pytest.raises(ValueError, match="unsafe"):
        store.publish({"../x": np.arange(2)})
    with pytest.raises(TypeError):
        store.publish({"x": [1, 2]})


def test_canary_probe_equals_the_jax_packages():
    from graphmine_tpu.obs.quality import CanaryProbe as JCanaryProbe

    probe, ref = CanaryProbe.generate(seed=3), JCanaryProbe.generate(seed=3)
    for name, arr in probe.arrays().items():
        np.testing.assert_array_equal(arr, ref.arrays()[name])
    assert probe.meta() == ref.meta()
    got, want = probe.score(device="cpu"), ref.score()
    assert got["recall_at_k"] == want["recall_at_k"]
    assert got["mean_rank_frac"] == pytest.approx(want["mean_rank_frac"], abs=1e-3)


def _load_between_the_renames(root: str, monkeypatch) -> dict:
    """Make the next publish at ``root`` run a ``load`` of the same root in
    another thread right after it rotates the current generation to
    ``.prev`` and before it renames the new one into place. The publish
    goes on once the load has returned or waits for the store's fence
    lock. Returns the load's outcome (``snap`` or ``error``)."""
    gen, prev = os.path.join(root, "snapshot"), os.path.join(root, "snapshot.prev")
    real_replace, real_flock = os.replace, snapshot_mod.fcntl.flock
    reader: dict = {}
    arrived = threading.Event()  # the load returned, or it waits for the lock

    def load_elsewhere():
        try:
            reader["snap"] = SnapshotStore(root).load(fingerprint="f")
        except BaseException as e:  # noqa: BLE001 — the test reads it
            reader["error"] = e
        finally:
            arrived.set()

    def flock(fd, op):
        if op == snapshot_mod.fcntl.LOCK_EX and threading.current_thread() is reader.get("thread"):
            arrived.set()
        return real_flock(fd, op)

    def replace(src, dst):
        real_replace(src, dst)
        if (src, dst) == (gen, prev) and "thread" not in reader:
            reader["thread"] = threading.Thread(target=load_elsewhere)
            reader["thread"].start()
            assert arrived.wait(60), "the load neither returned nor reached the lock"

    monkeypatch.setattr(snapshot_mod.os, "replace", replace)
    monkeypatch.setattr(snapshot_mod.fcntl, "flock", flock)
    return reader


def test_load_between_a_publishs_renames_keeps_the_publish(tmp_path, monkeypatch):
    # A load that finds the current slot empty mid-publish (the old
    # generation already at .prev) waits on the fence lock and reads the
    # new generation; without the lock it moved .prev back into the slot
    # and the publish's second rename failed on a non-empty target.
    root = str(tmp_path)
    store = SnapshotStore(root)
    store.publish({"x": np.arange(2)}, fingerprint="f")
    reader = _load_between_the_renames(root, monkeypatch)
    snap = store.publish({"x": np.arange(3)}, fingerprint="f")
    reader["thread"].join(60)
    assert not reader["thread"].is_alive()
    monkeypatch.undo()
    assert "error" not in reader, reader.get("error")
    assert snap.version == 2
    assert reader["snap"].version in (1, 2)
    got = store.load(fingerprint="f")
    assert got.version == 2 and got["x"].tolist() == [0, 1, 2]
    assert JSnapshotStore(root).load(fingerprint="f").version == 2
    assert not list(tmp_path.glob("snapshot.corrupt*")) and not list(tmp_path.glob("snapshot.tmp.*"))


def test_checkpoint_rollback_of_a_missing_generation_is_unchanged(tmp_path):
    # LPA checkpoints load from one process without the lock: a missing
    # current generation still rolls back to .prev, promoted into the
    # slot, with the JAX package's records and answer.
    out = {}
    for name, mod in (("port", ckpt), ("jax", jckpt)):
        d = str(tmp_path / name)
        mod.save_labels(d, np.arange(8, dtype=np.int32), 1)
        mod.save_labels(d, np.arange(8, dtype=np.int32) * 2, 2)
        os.remove(os.path.join(d, "lpa_labels.npz"))
        sink = MetricsSink()
        labels, it = mod.load_labels(d, sink=sink)
        out[name] = (np.asarray(labels).tolist(), it, [r["phase"] for r in sink.records],
                     sorted(os.listdir(d)))
    assert out["port"] == out["jax"]
    assert out["port"][:3] == (list(range(8)), 1, ["checkpoint_rollback",
                                                   "checkpoint_rollback_ok"])
    assert out["port"][3] == ["lpa_labels.npz"]
