"""Port parity: the vertex-range sharded write plane (CPU).

Every test holds the port against the JAX package: the range plan and its
ownership, ``split_delta`` / ``merge_splits`` bit-identical to the JAX
functions on seeded random deltas, epoch directories that either package
stages and the other commits and reads, the torn-publish recovery, the
plane's submit / dedupe / shed / refusal / per-range failover, and a
``writer_shards = 2`` server whose publishes equal the ``writer_shards = 1``
server's and the JAX sharded server's on the same deltas.
"""

import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.obs.schema import validate_records as jvalidate
from graphmine_tpu.obs.spans import Tracer as JTracer
from graphmine_tpu.pipeline.metrics import MetricsSink as JMetricsSink
from graphmine_tpu.serve import shardplane as jplane
from graphmine_tpu.serve.admission import AdmissionBounds as JBounds
from graphmine_tpu.serve.admission import AdmissionController as JAdmission
from graphmine_tpu.serve.delta import EdgeDelta as JEdgeDelta
from graphmine_tpu.serve.delta import RepairDebt as JRepairDebt
from graphmine_tpu.serve.delta import cold_recompute as jcold_recompute
from graphmine_tpu.serve.server import SnapshotServer as JSnapshotServer
from graphmine_tpu.serve.snapshot import SnapshotStore as JSnapshotStore
from graphmine_tpu.testing import faults as jfaults

from graphmine_tpu_torch.obs.schema import validate_records
from graphmine_tpu_torch.obs.spans import Tracer
from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from graphmine_tpu_torch.serve import shardplane as pplane
from graphmine_tpu_torch.serve.admission import AdmissionBounds, AdmissionController
from graphmine_tpu_torch.serve.delta import EdgeDelta, RepairDebt
from graphmine_tpu_torch.serve.server import SnapshotServer
from graphmine_tpu_torch.serve.snapshot import SnapshotStore
from graphmine_tpu_torch.testing import faults
from _torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "jax": SimpleNamespace(
        plane=jplane, Store=JSnapshotStore, Delta=JEdgeDelta, Debt=JRepairDebt,
        Bounds=JBounds, faults=jfaults, sink=lambda: JMetricsSink(tracer=JTracer()),
        server=lambda store, **kw: JSnapshotServer(
            store, admission=JAdmission(bounds=JBounds(
                max_pending_rows=100_000, max_queue_depth=64, deadline_s=300.0)), **kw),
    ),
    "port": SimpleNamespace(
        plane=pplane, Store=SnapshotStore, Delta=EdgeDelta, Debt=RepairDebt,
        Bounds=AdmissionBounds, faults=faults, sink=lambda: MetricsSink(tracer=Tracer()),
        server=lambda store, **kw: SnapshotServer(
            store, device="cpu", admission=AdmissionController(bounds=AdmissionBounds(
                max_pending_rows=100_000, max_queue_depth=64, deadline_s=300.0)), **kw),
    ),
}
CROSS = [("jax", "port"), ("port", "jax")]


def _clique(lo, hi):
    ids = np.arange(lo, hi)
    s, d = np.meshgrid(ids, ids)
    m = s.ravel() < d.ravel()
    return s.ravel()[m], d.ravel()[m]


def _cliques(spans):
    parts = [_clique(lo, hi) for lo, hi in spans]
    src = np.concatenate([p[0] for p in parts]).astype(np.int32)
    dst = np.concatenate([p[1] for p in parts]).astype(np.int32)
    return src, dst, max(hi for _, hi in spans)


def _publish(pkg, root, spans=((0, 15), (15, 30)), weights=None):
    src, dst, v = _cliques(spans)
    labels, cc, _ = jcold_recompute(jbuild_graph(src, dst, num_vertices=v))
    arrays = {"src": src, "dst": dst, "labels": np.asarray(labels),
              "cc_labels": np.asarray(cc), "lof": np.linspace(0.5, 1.2, v).astype(np.float32)}
    if weights is not None:
        arrays["weights"] = np.asarray(weights, np.float32)
    store = PKGS[pkg].Store(str(root))
    store.publish(arrays, fingerprint=graph_fingerprint(src, dst))
    return store, src, dst, v


# ---- the plan and the splitter ---------------------------------------------


@pytest.mark.parametrize("k,v", [(1, 10), (2, 30), (3, 30), (4, 10), (5, 3), (3, 0), (7, 100)])
def test_shard_plan_matches(k, v):
    p, j = pplane.ShardPlan.build(k, v), jplane.ShardPlan.build(k, v)
    assert p.snapshot() == j.snapshot() and p.ranges() == j.ranges()
    ids = np.arange(-2, v + 12)
    assert p.owners(ids).tolist() == j.owners(ids).tolist()
    assert [p.owner_of(i) for i in ids] == [j.owner_of(i) for i in ids]


@pytest.mark.parametrize("raw", [None, "1", "3", "0", "-2", "two"])
def test_writer_shards_env_matches(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("GRAPHMINE_WRITER_SHARDS", raising=False)
    else:
        monkeypatch.setenv("GRAPHMINE_WRITER_SHARDS", raw)
    outs = []
    for mod in (jplane, pplane):
        try:
            outs.append(("ok", mod.writer_shards_from_env(1)))
        except ValueError as e:
            outs.append(("err", str(e)))
    assert outs[0] == outs[1]


def test_emit_shard_record_is_the_single_builder():
    for mod in (jplane, pplane):
        with pytest.raises(ValueError, match="emit_shard_record owns only"):
            mod.emit_shard_record(None, "snapshot_publish")
        mod.emit_shard_record(None, "epoch_commit", epoch=1)  # no sink: no-op
    assert pplane.SHARD_RECORD_PHASES == jplane.SHARD_RECORD_PHASES


def _random_delta(rng, v, weighted):
    n_ins, n_del = int(rng.integers(0, 30)), int(rng.integers(0, 20))
    cols = (rng.integers(0, v, n_ins), rng.integers(0, v + 10, n_ins),
            rng.integers(0, v, n_del), rng.integers(0, v, n_del))
    w = rng.random(n_ins).astype(np.float32) if weighted else None
    return cols, w


@pytest.mark.parametrize("seed", range(12))
def test_split_and_merge_are_bit_identical_to_the_jax_functions(seed):
    rng = np.random.default_rng(100 + seed)
    k = int(rng.integers(1, 6))
    v = int(rng.integers(k, 60))
    cols, w = _random_delta(rng, v, weighted=seed % 2 == 1)
    pd, jd = EdgeDelta(*cols, insert_weight=w), JEdgeDelta(*cols, insert_weight=w)
    ps = pplane.split_delta(pd, pplane.ShardPlan.build(k, v))
    js = jplane.split_delta(jd, jplane.ShardPlan.build(k, v))
    assert [s.shard for s in ps] == [s.shard for s in js]
    for a, b in zip(ps, js):
        for name in ("insert_src", "insert_dst", "delete_src", "delete_dst", "insert_weight"):
            x, y = getattr(a.delta, name), getattr(b.delta, name)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), name
        assert np.array_equal(a.insert_index, b.insert_index)
        assert np.array_equal(a.delete_index, b.delete_index)
        assert pplane._split_payload(a) == jplane._split_payload(b)
    pm, jm = pplane.merge_splits(ps), jplane.merge_splits(js)
    for name in ("insert_src", "insert_dst", "delete_src", "delete_dst"):
        assert np.array_equal(getattr(pm, name), getattr(jm, name))
        assert np.array_equal(getattr(pm, name), getattr(pd, name))
    if w is not None and len(w):
        assert np.array_equal(pm.insert_weight, w) and np.array_equal(jm.insert_weight, w)


# ---- epoch-coordinated publish ---------------------------------------------


def _shard_arrays(plan, fill=0):
    return {s: {"labels": np.arange(*plan.range_of(s), dtype=np.int32) + fill,
                "lof": np.linspace(0, 1, plan.range_of(s)[1] - plan.range_of(s)[0],
                                   dtype=np.float32)}
            for s in range(plan.num_shards)}


def _read(coord):
    got = coord.read_epoch()
    if got is None:
        return None
    return {"epoch": got["epoch"], "vector": got["version_vector"],
            "shards": {s: ({k: v.tolist() for k, v in d["arrays"].items()}, d["version"],
                           list(d["range"])) for s, d in got["shards"].items()}}


@pytest.mark.parametrize("stager,committer", CROSS)
def test_epochs_staged_by_one_package_commit_and_read_in_the_other(tmp_path, stager,
                                                                   committer):
    store, *_ = _publish("port", tmp_path / "snap")
    sinks = {pkg: PKGS[pkg].sink() for pkg in PKGS}
    coords = {pkg: PKGS[pkg].plane.EpochCoordinator(
        PKGS[pkg].Store(store.root), PKGS[pkg].plane.ShardPlan.build(3, 30),
        sink=sinks[pkg]) for pkg in PKGS}
    plan = coords[stager].plan
    assert coords[committer].committed_epoch() == 0 and coords[committer].read_epoch() is None
    for e in (1, 2, 3):
        coords[stager].stage(e, _shard_arrays(plan, fill=e), versions={0: e, 1: e, 2: e + 1})
        assert coords[committer].committed_epoch() == e - 1
        rec = coords[committer].commit(e, {0: e, 1: e, 2: e + 1})
        assert rec["epoch"] == e and rec["record"] == "publish_epoch"
    assert _read(coords["jax"]) == _read(coords["port"])
    assert coords["port"].snapshot() == coords["jax"].snapshot()
    assert coords["port"].committed_epochs() == [2, 3]  # two generations retained
    phases = [r["phase"] for r in sinks[stager].records] + [
        r["phase"] for r in sinks[committer].records]
    assert phases.count("shard_publish") == 9 and phases.count("epoch_commit") == 3
    assert validate_records(sinks["port"].records) == []
    assert jvalidate(sinks["port"].records) == []


@pytest.mark.parametrize("crasher,recoverer", CROSS)
def test_torn_publish_keeps_the_previous_epoch_and_recovers_across(tmp_path, crasher,
                                                                   recoverer):
    store, *_ = _publish("port", tmp_path / "snap")
    coords = {pkg: PKGS[pkg].plane.EpochCoordinator(
        PKGS[pkg].Store(store.root), PKGS[pkg].plane.ShardPlan.build(2, 30))
        for pkg in PKGS}
    c = coords[crasher]
    c.stage(1, _shard_arrays(c.plan, 1), versions={0: 2, 1: 2})
    c.commit(1, {0: 2, 1: 2})
    c.stage(2, _shard_arrays(c.plan, 2), versions={0: 3, 1: 3})
    with PKGS[crasher].faults.shard_publish_torn().installed():
        with pytest.raises(Exception, match="preempt"):
            c.commit(2, {0: 3, 1: 3})
    assert coords[recoverer].committed_epoch() == 1
    assert _read(coords[recoverer])["shards"][0][0]["labels"][0] == 1
    out = coords[recoverer].recover()
    assert out == {"committed_epoch": 2, "recommitted": [2], "swept": []}
    assert _read(coords["jax"]) == _read(coords["port"])
    assert coords[crasher].version_vector() == {0: 3, 1: 3}
    # an incomplete stage is swept, in either package
    c.stage(3, _shard_arrays(c.plan, 3))
    os.remove(os.path.join(c.root, "epoch-00000003.stage", "shard-001", "manifest.json"))
    assert coords[recoverer].recover() == {"committed_epoch": 2, "recommitted": [],
                                           "swept": [3]}


# ---- the plane ---------------------------------------------------------------


def _plane_script(pkg, root):
    P = PKGS[pkg]
    store, *_ = _publish(pkg, root / "snap")
    plane = P.plane.ShardedWritePlane(
        store, P.plane.ShardPlan.build(3, 30), sink=P.sink(),
        admission_bounds=P.Bounds(max_pending_rows=100, max_queue_depth=8, deadline_s=300.0))
    out = []
    try:
        cross = P.Delta.from_pairs(insert=[[1, 2], [1, 12], [1, 25]], delete=[[14, 13]])
        sub = plane.submit(cross, delta_id="d1")
        out.append((sub["verdict"], sub["shard_seqs"]))
        again = plane.submit(cross, delta_id="d1")
        out.append((again["verdict"], again["shard_seqs"], again["applied"]))
        plane.commit_applied(sub["shard_seqs"], version=2)
        out.append(plane.version_vector())
        plane.shards[1].debt.submitted(10_000)
        shed = plane.submit(P.Delta.from_pairs(insert=[[0, 1], [0, 15]]), delta_id="d2")
        out.append((shed["verdict"], shed["reason"], [ws.wal.last_seq for ws in plane.shards]))
        plane.shards[1].debt = P.Debt()
        plane.kill_shard(1, reason="writer_shard_kill")
        with pytest.raises(P.plane.ShardRangeUnavailableError) as e:
            plane.submit(P.Delta.from_pairs(insert=[[0, 12]]))
        out.append((e.value.shards, str(e.value)))
        ok = plane.submit(P.Delta.from_pairs(insert=[[0, 1]]), delta_id="d3")
        out.append((ok["verdict"], ok["shard_seqs"]))
        partial = plane.restart_shard(1)
        out.append([p["id"] for p in partial])
        plane.attach_standby(2)
        s2 = plane.submit(P.Delta.from_pairs(insert=[[0, 20], [1, 21]]), delta_id="a")
        out.append((s2["shard_seqs"], plane.ship_shard(2)))
        plane.kill_shard(2)
        promoted = plane.promote_shard(2)
        out.append((promoted["epoch"], [p["id"] for p in promoted["pending"]],
                    plane.shards[2].wal.last_seq))
        with pytest.raises(ValueError):
            plane.promote_shard(2)
        plane.skip({2: s2["shard_seqs"][2]})
        out.append([[p["seq"] for p in ws.wal.pending()] for ws in plane.shards])
        snap = plane.snapshot()
        for s in snap["shards"]:
            s["wal"].pop("segment_bytes")
            s["repair_debt"] = {k: v for k, v in s["repair_debt"].items()
                                if not k.endswith("_s")}
        out.append(snap)
        records = [(r["phase"], r.get("shard"), r.get("status"))
                   for r in plane.sink.records if r["phase"] in jplane.SHARD_RECORD_PHASES
                   or r["phase"] == "wal_append"]
        out.append(records)
    finally:
        plane.close()
    return out


def test_plane_submit_dedupe_shed_refusal_and_failover_match(tmp_path):
    want = _plane_script("jax", tmp_path / "j")
    got = _plane_script("port", tmp_path / "p")
    assert got == want
    assert got[0] == ("accepted", {0: 1, 1: 1, 2: 1})


@pytest.mark.parametrize("writer,reader", CROSS)
def test_plane_logs_reopen_in_the_other_package(tmp_path, writer, reader):
    store, *_ = _publish(writer, tmp_path / "snap")
    P = PKGS[writer]
    plane = P.plane.ShardedWritePlane(store, P.plane.ShardPlan.build(2, 30))
    plane.submit(P.Delta.from_pairs(insert=[[0, 3], [0, 20]]), delta_id="x")
    plane.submit(P.Delta.from_pairs(insert=[[1, 25]]), delta_id="y")
    plane.close()
    R = PKGS[reader]
    other = R.plane.ShardedWritePlane(R.Store(store.root), R.plane.ShardPlan.build(2, 30))
    try:
        assert [[(p["seq"], p["id"], p["payload"]) for p in ws.wal.pending()]
                for ws in other.shards] == [
            [(1, "x", {"insert": [[0, 3]], "delete": [], "shard": 0, "insert_index": [0],
                       "delete_index": []})],
            [(1, "x", {"insert": [[0, 20]], "delete": [], "shard": 1, "insert_index": [1],
                       "delete_index": []}),
             (2, "y", {"insert": [[1, 25]], "delete": [], "shard": 1, "insert_index": [0],
                       "delete_index": []})]]
        dup = other.submit(R.Delta.from_pairs(insert=[[0, 3], [0, 20]]), delta_id="x")
        assert dup["verdict"] == "duplicate"
    finally:
        other.close()


# ---- the server with writer_shards = 2 --------------------------------------


_DELTAS = [
    {"insert": [[0, 14], [3, 20, ], [29, 30]], "delete": []},
    {"insert": [[5, 31]], "delete": [[0, 14], [16, 17]]},
    {"insert": [[20, 2], [7, 8]], "delete": [[1, 2]]},
]


def _sharded_run(pkg, root, shards, monkeypatch):
    monkeypatch.setenv("GRAPHMINE_QUALITY", "0")
    sink = PKGS[pkg].sink()
    store, *_ = _publish(pkg, root)
    kw = {"writer_shards": shards}
    if shards == 1:
        kw["wal"] = str(root / "wal")
    srv = PKGS[pkg].server(store, sink=sink, **kw)
    try:
        for i, body in enumerate(_DELTAS):
            out = srv.apply_delta(dict(body), delta_id=f"b{i}")
            assert out.get("verdict") in (None, "accepted"), out
            srv.wait_applied(timeout=120.0)
        health = srv.healthz()
    finally:
        srv.stop()
    snap = store.load()
    return {
        "version": snap.version,
        **{k: np.asarray(snap[k]).tolist() for k in ("src", "dst", "labels", "cc_labels")},
        "lof": np.asarray(snap["lof"]),
        "repairs": [(r["method"], r["iterations"]) for r in sink.records
                    if r["phase"] == "delta_apply"],
        "records": sorted({r["phase"] for r in sink.records
                           if r["phase"] in ("shard_publish", "epoch_commit")}),
        "epoch": health.get("epoch"), "shard_versions": health.get("shard_versions"),
        "sink": sink,
    }


def test_two_writer_shards_publish_what_one_does_and_the_jax_plane_does(tmp_path, monkeypatch):
    one = _sharded_run("port", tmp_path / "one", 1, monkeypatch)
    two = _sharded_run("port", tmp_path / "two", 2, monkeypatch)
    jtwo = _sharded_run("jax", tmp_path / "jtwo", 2, monkeypatch)
    for k in ("version", "src", "dst", "labels", "cc_labels", "repairs"):
        assert two[k] == one[k] == jtwo[k], k
    assert np.array_equal(two["lof"], one["lof"])
    np.testing.assert_allclose(two["lof"], jtwo["lof"], rtol=1e-4, atol=1e-5)
    assert two["records"] == jtwo["records"] == ["epoch_commit", "shard_publish"]
    assert one["records"] == [] and one["epoch"] is None
    assert (two["epoch"], two["shard_versions"]) == (jtwo["epoch"], jtwo["shard_versions"]) == (
        3, {"0": 4, "1": 3})
    assert validate_records(two["sink"].records) == []
    # the epoch directory the port committed reads back in the JAX package
    jc = jplane.EpochCoordinator(JSnapshotStore(str(tmp_path / "two")),
                                 jplane.ShardPlan.build(2, 30))
    pc = pplane.EpochCoordinator(SnapshotStore(str(tmp_path / "jtwo")),
                                 pplane.ShardPlan.build(2, 30))
    a, b = _read(jc), _read(pc)
    for s in (0, 1):
        assert a["shards"][s][0]["labels"] == b["shards"][s][0]["labels"]
    assert (a["epoch"], a["vector"]) == (b["epoch"], b["vector"]) == (3, {0: 4, 1: 3})


def test_plane_kill_restart_replays_like_the_jax_server(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAPHMINE_QUALITY", "0")
    outs = []
    for pkg in PKGS:
        store, *_ = _publish(pkg, tmp_path / pkg)
        srv = PKGS[pkg].server(store, writer_shards=2)
        out = srv.apply_delta(dict(_DELTAS[0]), delta_id="a", ack="wal")
        assert out["verdict"] == "accepted" and out["shard_seqs"] == {"0": 1, "1": 1}
        assert srv.wait_applied(60)
        PKGS[pkg].faults.writer_kill_mid_apply(srv)
        plane = srv._tenants["default"].plane
        for i, body in enumerate(_DELTAS[1:]):
            plane.submit(PKGS[pkg].Delta.from_pairs(body["insert"], body["delete"]),
                         delta_id=f"crash{i}")
        plane.close()
        sink2 = PKGS[pkg].sink()
        srv2 = PKGS[pkg].server(PKGS[pkg].Store(store.root), sink=sink2, writer_shards=2)
        assert srv2.wait_applied(120)
        outs.append((srv2.engine.version,
                     np.asarray(srv2.engine.snapshot["labels"]).tolist(),
                     sorted(zip(np.asarray(srv2.engine.snapshot["src"]).tolist(),
                                np.asarray(srv2.engine.snapshot["dst"]).tolist())),
                     [(r["entries"], r["shards"]) for r in sink2.records
                      if r["phase"] == "wal_replay"],
                     srv2.healthz()["shard_versions"]))
        srv2.stop()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_a_killed_range_refuses_only_its_batches(tmp_path, pkg, monkeypatch):
    monkeypatch.setenv("GRAPHMINE_QUALITY", "0")
    store, *_ = _publish(pkg, tmp_path / "snap")
    srv = PKGS[pkg].server(store, writer_shards=2)
    try:
        PKGS[pkg].faults.writer_shard_kill(srv, 1)
        refused = srv.apply_delta({"insert": [[0, 20]]})
        assert refused["verdict"] == "shed" and "degraded vertex range" in refused["reason"]
        ok = srv.apply_delta({"insert": [[0, 3]]}, delta_id="ok")
        assert ok["version"] == 2
        assert srv.healthz()["degraded_shards"] == [1]
        assert srv.statusz()["shardplane"]["shards"][1]["read_only"]
    finally:
        srv.stop()


def test_info_reads_the_shardplane_like_the_jax_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("GRAPHMINE_QUALITY", "0")
    from graphmine_tpu_torch.serve.__main__ import _shardplane_info
    from tools.serve_cli import _shardplane_info as j_shardplane_info

    store, *_ = _publish("port", tmp_path / "snap")
    srv = PKGS["port"].server(store, writer_shards=2)
    srv.apply_delta({"insert": [[0, 5], [0, 20]], "delete": []})
    srv.stop()
    shutil.copytree(tmp_path / "snap", tmp_path / "copy")
    got = _shardplane_info(store, store.load())
    jstore = JSnapshotStore(str(tmp_path / "copy"))
    want = j_shardplane_info(jstore, jstore.load())
    assert got == want and got["committed_epoch"] == 1
    assert set(got["shard_wals"]) == {"shard-000", "shard-001"}
    plain = SnapshotStore(str(tmp_path / "plain"))
    plain.publish({"labels": np.zeros(3, np.int32)})
    assert _shardplane_info(plain, plain.load()) is None
