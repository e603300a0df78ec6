"""Port parity: the write-ahead log, the durable write path, standby and
promote (CPU).

Every test holds the port against the JAX package. Log directories written
by either package are read back by the other (entries, pending, the
watermark history, the torn-tail prefix, rotation and compaction); the
same scripted operations give the same state in both; and the servers,
killed and restarted, deduping retries, stopping cleanly, shipping to a
standby and promoting it, publish labels, CC labels, repair methods,
iterations and versions equal to the JAX server's on the same deltas. One
test SIGKILLs a ``serve --wal`` subprocess of the port and restarts it.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.obs.schema import validate_records as jvalidate
from graphmine_tpu.obs.spans import Tracer as JTracer
from graphmine_tpu.pipeline.metrics import MetricsSink as JMetricsSink
from graphmine_tpu.serve import wal as jwal
from graphmine_tpu.serve.delta import cold_recompute as jcold_recompute
from graphmine_tpu.serve.server import SnapshotServer as JSnapshotServer
from graphmine_tpu.serve.snapshot import PublishFencedError as JFenced
from graphmine_tpu.serve.snapshot import SnapshotStore as JSnapshotStore
from graphmine_tpu.testing import faults as jfaults

from graphmine_tpu_torch.obs.schema import validate_records
from graphmine_tpu_torch.obs.spans import Tracer
from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from graphmine_tpu_torch.serve import wal as pwal
from graphmine_tpu_torch.serve.server import SnapshotServer
from graphmine_tpu_torch.serve.snapshot import PublishFencedError, SnapshotStore
from graphmine_tpu_torch.testing import faults
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

PKGS = {
    "jax": SimpleNamespace(
        wal=jwal, Store=JSnapshotStore, faults=jfaults, Fenced=JFenced,
        sink=lambda: JMetricsSink(tracer=JTracer()), validate=jvalidate,
        server=lambda store, **kw: JSnapshotServer(store, **kw),
    ),
    "port": SimpleNamespace(
        wal=pwal, Store=SnapshotStore, faults=faults, Fenced=PublishFencedError,
        sink=lambda: MetricsSink(tracer=Tracer()), validate=validate_records,
        server=lambda store, **kw: SnapshotServer(store, device="cpu", **kw),
    ),
}
CROSS = [("jax", "port"), ("port", "jax")]


def _clique(lo, hi):
    ids = np.arange(lo, hi)
    s, d = np.meshgrid(ids, ids)
    m = s.ravel() < d.ravel()
    return s.ravel()[m], d.ravel()[m]


def _community_graph():
    parts = [_clique(0, 12), _clique(12, 26), _clique(26, 40)]
    src = np.concatenate([p[0] for p in parts]).astype(np.int32)
    dst = np.concatenate([p[1] for p in parts]).astype(np.int32)
    return src, dst, 40


_SRC, _DST, _V = _community_graph()
_LABELS, _CC, _ = jcold_recompute(jbuild_graph(_SRC, _DST, num_vertices=_V))


def _store(pkg, root):
    """One package's store at ``root`` holding the community graph's v1."""
    store = PKGS[pkg].Store(str(root))
    store.publish(
        {"src": _SRC, "dst": _DST, "labels": np.asarray(_LABELS),
         "cc_labels": np.asarray(_CC), "lof": np.zeros(_V, np.float32)},
        fingerprint=graph_fingerprint(_SRC, _DST),
    )
    return store


def _final(server) -> dict:
    """What a publish chain ended at: the served version and its arrays."""
    snap = server.engine.snapshot
    return {"version": server.engine.version,
            **{k: np.asarray(snap[k]).tolist() for k in ("src", "dst", "labels", "cc_labels")}}


def _repairs(sink) -> list:
    return [(r["method"], r["iterations"], r["version"])
            for r in sink.records if r["phase"] == "delta_apply"]


def _strip(entries):
    """Log entries without their wall-clock stamp."""
    return [{k: v for k, v in e.items() if k != "t"} for e in entries]


def _commit_body(root):
    with open(os.path.join(root, "COMMIT")) as f:
        body = json.load(f)
    body.pop("t", None)
    return body


def _post(port, path, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path, timeout=30):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


_TIMING = {"seconds", "snapshot_age_s", "tenant_snapshot_age_s", "ingest_lag_s",
           "snapshot_id", "uptime_s", "t", "created", "parent"}


def _results(body):
    if isinstance(body, dict):
        return {k: _results(v) for k, v in body.items() if k not in _TIMING}
    if isinstance(body, list):
        return [_results(v) for v in body]
    return body


# ---- the log alone: one package writes, the other reads ---------------------


def _script(w):
    """A scripted mix of every mutator: appends (ids, a trace, a tenant, a
    weighted payload), a duplicate, a tombstone, the gapped and the
    absolute commits."""
    for i in range(6):
        w.append({"insert": [[i, i + 1]]}, delta_id=f"d{i}", deadline_s=5.0)
    w.append({"insert": [[1, 2, 0.5]]}, delta_id="w", trace="00-" + "a" * 32 + "-" + "b" * 16 + "-01")
    w.append({"delete": [[3, 4]]}, delta_id="d0", tenant="acme")
    assert w.append({"insert": [[9, 9]]}, delta_id="d3") == (4, True)
    w.skip(5)
    w.commit_applied([2], snapshot_version=3)
    w.commit(1, snapshot_version=2)
    w.commit_applied([3], snapshot_version=4)


def _view(w) -> dict:
    return {
        "entries": _strip(w.entries(0)), "pending": _strip(w.pending()),
        "last": w.last_seq, "applied": w.applied_seq, "version": w.applied_version,
        "history": [list(p) for p in w.commit_history()],
        "snapshot": w.snapshot(),
        "lookup": [w.lookup("d3"), w.lookup("d0"), w.lookup("d0", tenant="acme"),
                   w.lookup("nope")],
        "seq_applied": [w.seq_applied(s) for s in range(1, 10)],
    }


@pytest.mark.parametrize("writer,reader", CROSS)
def test_log_written_by_one_package_reads_back_in_the_other(tmp_path, writer, reader):
    root = str(tmp_path / "wal")
    w = PKGS[writer].wal.WriteAheadLog(root)
    _script(w)
    wrote = _view(w)
    w.close()
    r = PKGS[reader].wal.WriteAheadLog(root)
    assert _view(r) == wrote
    # and the reader keeps appending into the writer's sequence space
    assert r.append({"insert": [[7, 7]]}, delta_id="next") == (10, False)
    r.close()
    back = PKGS[writer].wal.WriteAheadLog(root)
    assert back.last_seq == 10 and back.lookup("next") == 10
    back.close()


def test_the_same_script_gives_the_same_log_in_both(tmp_path):
    views, commits = [], []
    for pkg in PKGS:
        root = str(tmp_path / pkg)
        w = PKGS[pkg].wal.WriteAheadLog(root)
        _script(w)
        view = _view(w)
        view["snapshot"].pop("segment_bytes")  # the frames' wall clocks differ in length
        views.append(view)
        w.close()
        commits.append(_commit_body(root))
        names = sorted(os.listdir(root))
        assert names == ["COMMIT", "wal-000000000001.seg"]
    assert views[0] == views[1] and commits[0] == commits[1]


@pytest.mark.parametrize("writer,reader", CROSS)
def test_torn_tail_keeps_the_prefix_in_the_other_package(tmp_path, writer, reader):
    root = str(tmp_path / "wal")
    w = PKGS[writer].wal.WriteAheadLog(root)
    for i in range(5):
        w.append({"insert": [[i, i + 1]]}, delta_id=f"d{i}")
    w.close()
    PKGS[writer].faults.wal_torn_tail(root)
    shutil.copytree(root, tmp_path / "copy")
    r = PKGS[reader].wal.WriteAheadLog(root)
    ref = PKGS[writer].wal.WriteAheadLog(str(tmp_path / "copy"))
    assert r.last_seq == ref.last_seq == 4
    assert _strip(r.pending()) == _strip(ref.pending())
    assert r.append({"insert": [[7, 8]]}, delta_id="after") == (5, False)
    assert ref.append({"insert": [[7, 8]]}, delta_id="after") == (5, False)
    r.close()
    ref.close()
    # the repaired files are the same bytes apart from the wall clock
    again = [PKGS[writer].wal.WriteAheadLog(str(d)) for d in (root, tmp_path / "copy")]
    assert _strip(again[0].entries(0)) == _strip(again[1].entries(0))
    for w2 in again:
        w2.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_torn_tail_read_only_open_leaves_the_foreign_tail(tmp_path, pkg):
    root = str(tmp_path / "wal")
    w = PKGS[pkg].wal.WriteAheadLog(root)
    for i in range(3):
        w.append({"insert": [[i, i + 1]]}, delta_id=f"d{i}")
    w.close()
    faults.wal_torn_tail(root)
    size = os.path.getsize(os.path.join(root, "wal-000000000001.seg"))
    other = "port" if pkg == "jax" else "jax"
    ro = PKGS[other].wal.WriteAheadLog(root, read_only=True)
    assert ro.last_seq == 2
    assert os.path.getsize(os.path.join(root, "wal-000000000001.seg")) == size
    with pytest.raises(ValueError, match="read_only"):
        ro.append({"insert": [[0, 0]]})
    ro.close()


@pytest.mark.parametrize("writer", PKGS)
def test_damage_before_the_tail_is_refused_by_both(tmp_path, writer):
    root = str(tmp_path / "wal")
    w = PKGS[writer].wal.WriteAheadLog(root, segment_max_bytes=64)
    for i in range(6):
        w.append({"insert": [[i, i + 1]]}, delta_id=f"d{i}")
    w.close()
    first = sorted(p for p in os.listdir(root) if p.endswith(".seg"))[0]
    faults.corrupt_file(os.path.join(root, first), offset=-8, nbytes=4)
    for pkg in PKGS:
        with pytest.raises(PKGS[pkg].wal.WalCorruptionError, match="non-tail"):
            PKGS[pkg].wal.WriteAheadLog(root)


@pytest.mark.parametrize("seg_bytes,retain", [(256, 1), (128, 2), (64, 1)])
def test_rotation_and_compaction_are_the_same(tmp_path, seg_bytes, retain):
    out = []
    for pkg in PKGS:
        root = str(tmp_path / pkg)
        w = PKGS[pkg].wal.WriteAheadLog(root, segment_max_bytes=seg_bytes,
                                        retain_segments=retain)
        for i in range(12):
            w.append({"insert": [[i, i + 1]]}, delta_id=f"d{i}", t=1000.0 + i)
        before = sorted(os.listdir(root))
        w.commit(10, snapshot_version=11)
        after = sorted(os.listdir(root))
        out.append((before, after, _view(w), w.oldest_retained_seq()))
        w.close()
        out[-1] += ([open(os.path.join(root, n), "rb").read() for n in after
                     if n.endswith(".seg")],)
    assert out[0] == out[1]
    assert len(out[0][0]) > len(out[0][1])  # the size bound rotated, the commit pruned
    # the compacted log reads back across packages
    r = PKGS["port"].wal.WriteAheadLog(str(tmp_path / "jax"), segment_max_bytes=seg_bytes,
                                       retain_segments=retain)
    assert _strip(r.pending()) == _strip(out[0][2]["pending"])
    r.close()


@pytest.mark.parametrize("writer,reader", CROSS)
def test_watermark_history_floor_and_rewind_cross_read(tmp_path, writer, reader):
    root = str(tmp_path / "wal")
    w = PKGS[writer].wal.WriteAheadLog(root)
    w.note_baseline(1)
    w.note_baseline(9)
    for i in range(3):
        w.append({"insert": [[i, i + 1]]}, delta_id=f"d{i}")
        w.commit(i + 1, snapshot_version=i + 2)
    w.close()
    r = PKGS[reader].wal.WriteAheadLog(root)
    assert r.commit_history() == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert [r.replay_floor(v) for v in (1, 3, 7)] == [0, 2, None]
    r.rewind(2, 3)
    r.rewind(5, 9)
    r.close()
    back = PKGS[writer].wal.WriteAheadLog(root)
    assert (back.applied_seq, back.applied_version) == (2, 3)
    assert back.commit_history() == [(0, 1), (1, 2), (2, 3)]
    assert [e["seq"] for e in back.pending()] == [3]
    back.merge_history([(2, 99), (3, 4), (4, 5)])
    assert back.commit_history() == [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5)]
    back.close()
    assert _commit_body(root)["history"] == [[0, 1], [1, 2], [2, 3], [3, 4], [4, 5]]


def test_contiguous_floor_and_preview_match(tmp_path):
    outs = []
    for pkg in PKGS:
        w = PKGS[pkg].wal.WriteAheadLog(str(tmp_path / pkg))
        for i in range(5):
            w.append({"insert": [[i, i + 1]]}, delta_id=f"d{i}")
        steps = [w.preview_commit([2, 4])]
        w.commit_applied([2, 4], snapshot_version=5)
        steps += [w.applied_seq, w.snapshot()["pending_entries"], w.preview_commit([1])]
        w.commit_applied([1], snapshot_version=6)
        w.skip(3)
        snap = {k: v for k, v in w.snapshot().items() if k != "segment_bytes"}
        steps += [w.applied_seq, snap, _strip(w.pending())]  # a tombstone's clock varies
        w.commit_applied([5], snapshot_version=7)
        steps += [w.applied_seq, w.commit_history()]
        outs.append(steps)
        w.close()
    assert outs[0] == outs[1]


def test_standby_compaction_guard_is_the_same(tmp_path):
    outs = []
    for pkg in PKGS:
        w = PKGS[pkg].wal.WriteAheadLog(str(tmp_path / pkg), segment_max_bytes=64,
                                        retain_segments=1)
        w.note_baseline(7)
        for i in range(12):
            w.append({"insert": [[i, i + 1]]}, delta_id=f"d{i}")
        w.protect_version = 7
        w.merge_history([(12, 40)])
        kept = len(w.entries(1))
        w.protect_version = None
        w.append({"insert": [[12, 13]]}, delta_id="post")
        w.commit(13, snapshot_version=42)
        outs.append((kept, w.entries(1)[0]["seq"], w.snapshot()["segments"]))
        w.close()
    assert outs[0] == outs[1] and outs[0][0] == 12


@pytest.mark.parametrize("pkg", PKGS)
def test_wal_records_validate_in_both_registries(tmp_path, pkg):
    sink = PKGS[pkg].sink()
    w = PKGS[pkg].wal.WriteAheadLog(str(tmp_path / "wal"), sink=sink)
    _script(w)
    w.close()
    assert [r["phase"] for r in sink.records].count("wal_append") == 8
    assert validate_records(sink.records) == [] and jvalidate(sink.records) == []


# ---- log shipping across packages ------------------------------------------


@pytest.mark.parametrize("primary,standby", CROSS)
def test_log_shipper_copies_the_other_packages_primary(tmp_path, primary, standby):
    store = _store(primary, tmp_path / "snap")
    srv = PKGS[primary].server(store, wal=str(tmp_path / "wal-p"))
    port = srv.start()[1]
    try:
        for i in range(4):
            srv.wal.append({"insert": [[i, 13 + i]]}, delta_id=f"p{i}")
        srv.wal.skip(2)
        srv.wal.commit(1, snapshot_version=2)
        copy = PKGS[standby].wal.WriteAheadLog(str(tmp_path / "wal-s"))
        ship = PKGS[standby].wal.LogShipper(copy, f"http://127.0.0.1:{port}")
        out = ship.poll_once()
        assert out["shipped"] == 5 and out["lag_entries"] == 0
        assert _strip(copy.entries(0)) == _strip(srv.wal.entries(0))
        assert copy.commit_history() == srv.wal.commit_history()
        assert (copy.applied_seq, copy.applied_version) == (
            srv.wal.applied_seq, srv.wal.applied_version) == (2, 2)
        assert _strip(copy.pending()) == _strip(srv.wal.pending())
        assert ship.poll_once()["shipped"] == 0
        copy.close()
    finally:
        srv.stop()


def test_wal_endpoint_bodies_are_equal(tmp_path):
    bodies = []
    for pkg in PKGS:
        store = _store(pkg, tmp_path / pkg / "snap")
        srv = PKGS[pkg].server(store, wal=str(tmp_path / pkg / "wal"))
        port = srv.start()[1]
        try:
            for i in range(3):
                srv.wal.append({"insert": [[i, 13 + i]]}, delta_id=f"p{i}")
            bodies.append([_results(_get(port, q)) for q in
                           ("/wal?from=1", "/wal?from=2&limit=1", "/wal?from=9")])
            assert _get(port, "/healthz")["wal"]["pending_entries"] == 3
        finally:
            srv.stop()
    assert bodies[0] == bodies[1]


# ---- the server's durable write path ---------------------------------------


def _kill_and_replay(pkg, tmp_path, restart_pkg=None):
    """A writer acks one delta at the durability point and publishes it,
    dies, and three more acknowledged entries reach its log in the crash
    window; the restart (in ``restart_pkg``) replays them."""
    sink = PKGS[pkg].sink()
    store = _store(pkg, tmp_path / "snap")
    wal_dir = str(tmp_path / "wal")
    srv = PKGS[pkg].server(store, sink=sink, wal=wal_dir)
    out = srv.apply_delta({"insert": [[0, 13]]}, delta_id="live-0", ack="wal")
    assert out["verdict"] == "accepted" and out["durable"] and out["seq"] == 1
    assert srv.wait_applied(60)
    PKGS[pkg].faults.writer_kill_mid_apply(srv)
    w = PKGS[pkg].wal.WriteAheadLog(wal_dir)
    for i, pair in enumerate([(1, 14), (27, 3), (3, 16)]):
        assert w.append({"insert": [list(pair)], "delete": [[0, 1]] if i == 1 else []},
                        delta_id=f"crash-{i}") == (i + 2, False)
    w.close()
    rpkg = restart_pkg or pkg
    sink2 = PKGS[rpkg].sink()
    srv2 = PKGS[rpkg].server(PKGS[rpkg].Store(str(tmp_path / "snap")), sink=sink2,
                             wal=wal_dir)
    try:
        assert srv2.wait_applied(120)
        replays = [r for r in sink2.records if r["phase"] == "wal_replay"]
        assert [(r["entries"], r["from_seq"], r["source"]) for r in replays] == [
            (3, 2, "startup")]
        assert srv2.wal.applied_seq == srv2.wal.last_seq == 4
        assert PKGS[rpkg].validate(sink2.records) == []
        return {**_final(srv2), "repairs": _repairs(sink) + _repairs(sink2)}
    finally:
        srv2.stop()


@pytest.mark.parametrize("restart", ["jax", "port"])
def test_kill_and_restart_replays_like_the_jax_server(tmp_path, restart):
    """The port's writer killed and restarted (by the port, and by the JAX
    server on the port's log and store) ends where the JAX writer does."""
    want = _kill_and_replay("jax", tmp_path / "j")
    got = _kill_and_replay("port", tmp_path / "p", restart_pkg=restart)
    assert got == want
    assert want["version"] == 3 and [v for _, _, v in want["repairs"]] == [2, 3]


def test_jax_log_replays_in_the_port_server(tmp_path):
    want = _kill_and_replay("jax", tmp_path / "j")
    got = _kill_and_replay("jax", tmp_path / "x", restart_pkg="port")
    assert got == want


def test_publish_over_an_inflight_gap_replays_exactly_once(tmp_path):
    outs = []
    for pkg in PKGS:
        store = _store(pkg, tmp_path / pkg / "snap")
        wal_dir = str(tmp_path / pkg / "wal")
        srv = PKGS[pkg].server(store, wal=wal_dir)
        assert srv.wal.append({"insert": [[0, 13]]}, delta_id="inflight") == (1, False)
        srv.apply_delta({"insert": [[0, 14]]}, delta_id="applies")
        assert srv.wal.applied_seq == 0 and srv.wal.seq_applied(2)
        meta = dict(srv.engine.snapshot.meta)
        PKGS[pkg].faults.writer_kill_mid_apply(srv)
        sink2 = PKGS[pkg].sink()
        srv2 = PKGS[pkg].server(PKGS[pkg].Store(store.root), sink=sink2, wal=wal_dir)
        assert srv2.wait_applied(120)
        outs.append((_final(srv2), meta["wal_applied_seq"], meta["wal_applied_above"],
                     [r["entries"] for r in sink2.records if r["phase"] == "wal_replay"]))
        srv2.stop()
    assert outs[0] == outs[1] and outs[0][1:] == (0, [2], [1])


def test_duplicate_ids_and_ack_modes_answer_alike(tmp_path):
    seqs, finals = [], []
    for pkg in PKGS:
        store = _store(pkg, tmp_path / pkg / "snap")
        srv = PKGS[pkg].server(store, wal=str(tmp_path / pkg / "wal"))
        port = srv.start()[1]
        try:
            got = [_post(port, "/delta", {"insert": [[0, 13]]},
                         {"X-Delta-Id": "once", "X-Delta-Ack": "wal"})]
            assert srv.wait_applied(60)
            got.append(_post(port, "/delta", {"insert": [[0, 13]]},
                             {"X-Delta-Id": "once", "X-Delta-Ack": "wal"}))
            got.append(_post(port, "/delta", {"insert": [[0, 13]]}, {"X-Delta-Id": "once"}))
            got.append(_post(port, "/delta", {"insert": [[0, 14]]},
                             {"X-Delta-Id": "bad id! not in the alphabet"}))
            got.append(_post(port, "/delta", {"insert": [[0, 14]]}, {"X-Delta-Ack": "fsync"}))
            got.append(_post(port, "/delta", {"insert": [[0, 14]]}, {"X-Delta-Id": "two"}))
            seqs.append([(s, _results(b)) for s, b in got])
            finals.append(_final(srv))
        finally:
            srv.stop()
    assert seqs[0] == seqs[1]
    assert [s for s, _ in seqs[0]] == [202, 200, 200, 400, 400, 200]
    assert finals[0] == finals[1]
    src, dst = np.asarray(finals[1]["src"]), np.asarray(finals[1]["dst"])
    assert int(((src == 0) & (dst == 13)).sum()) == 1


def test_clean_stop_resolves_durable_batches_as_accepted(tmp_path):
    outs = []
    for pkg in PKGS:
        sink = PKGS[pkg].sink()
        store = _store(pkg, tmp_path / pkg / "snap")
        wal_dir = str(tmp_path / pkg / "wal")
        srv = PKGS[pkg].server(store, sink=sink, wal=wal_dir)
        inj = PKGS[pkg].faults.FaultInjector()
        inj.add("delta_repair", PKGS[pkg].faults.slow_repair(1.0), at=1, repeat=1)
        results = {}

        def fire(payload, delta_id, srv=srv, results=results):
            results[delta_id] = srv.apply_delta(payload, delta_id=delta_id)

        with inj.installed():
            held = threading.Thread(target=fire, args=({"insert": [[0, 13]]}, "held"))
            held.start()
            time.sleep(0.4)
            parked = threading.Thread(target=fire, args=({"insert": [[0, 14]]}, "parked"))
            parked.start()
            time.sleep(0.3)
            stopper = threading.Thread(target=srv.stop)
            stopper.start()
            for t in (held, parked, stopper):
                t.join(timeout=60)
        sheds = [r for r in sink.records if r["phase"] == "delta_shed"]
        srv2 = PKGS[pkg].server(PKGS[pkg].Store(store.root), wal=wal_dir)
        assert srv2.wait_applied(120)
        outs.append((_results(results["parked"]), results["held"]["version"], sheds,
                     _final(srv2)))
        srv2.stop()
    assert outs[0] == outs[1]
    assert outs[0][0]["verdict"] == "accepted" and "replays on restart" in outs[0][0]["note"]


def test_healthz_readiness_across_a_startup_replay(tmp_path):
    """While the startup replay applies (held at the repair seam), both
    servers answer /healthz alike: live, ready, the old version, the
    pending log entries; then the replayed version."""
    seen = []
    for pkg in PKGS:
        store = _store(pkg, tmp_path / pkg / "snap")
        wal_dir = str(tmp_path / pkg / "wal")
        w = PKGS[pkg].wal.WriteAheadLog(wal_dir)
        w.append({"insert": [[0, 13]]}, delta_id="a")
        w.append({"insert": [[1, 14]]}, delta_id="b")
        w.close()
        inj = PKGS[pkg].faults.FaultInjector()
        inj.add("delta_repair", PKGS[pkg].faults.slow_repair(1.0), at=1, repeat=1)
        with inj.installed():
            srv = PKGS[pkg].server(store, wal=wal_dir)
            port = srv.start()[1]
            time.sleep(0.3)
            during = _get(port, "/healthz")
        assert srv.wait_applied(60)
        after = _get(port, "/healthz")
        srv.stop()
        keys = ("ok", "ready", "version", "overloaded")
        wal = {k: v for k, v in after["wal"].items() if k != "segment_bytes"}  # clocks vary
        seen.append(([during[k] for k in keys], during["wal"]["pending_entries"],
                     [after[k] for k in keys], wal))
    assert seen[0] == seen[1]
    assert seen[0][0] == [True, True, 1, False] and seen[0][2][2] == 2


@pytest.mark.parametrize("pkg", PKGS)
def test_a_fenced_writer_refuses_and_promote_reopens(tmp_path, pkg):
    store = _store(pkg, tmp_path / "snap")
    srv = PKGS[pkg].server(store, wal=str(tmp_path / "wal"))
    try:
        PKGS[pkg].Store(store.root).advance_epoch(reason="rival promotion")
        assert srv.apply_delta({"insert": [[0, 13]]}, delta_id="doomed",
                               ack="wal")["verdict"] == "accepted"
        srv.wait_applied(60)
        deadline = time.monotonic() + 30
        while srv._fenced is None and time.monotonic() < deadline:
            time.sleep(0.02)
        refused = srv.apply_delta({"insert": [[0, 14]]}, delta_id="late", ack="wal")
        assert refused["verdict"] == "shed" and "fenced" in refused["reason"]
        assert "fenced" in srv.healthz()
        res = srv.promote()
        assert res["promoted"] and res["epoch"] == 2 and srv._fenced is None
        ok = srv.apply_delta({"insert": [[0, 15]]}, delta_id="after")
        assert ok["version"] == srv.engine.version
        assert srv.promote()["already_writer"]
        edges = set(zip(np.asarray(srv.engine.snapshot["src"]).tolist(),
                        np.asarray(srv.engine.snapshot["dst"]).tolist()))
        assert {(0, 13), (0, 15)} <= edges  # the doomed entry replayed at promotion
    finally:
        srv.stop()


def test_port_server_refusals_match(tmp_path):
    outs = []
    for pkg in PKGS:
        store = _store(pkg, tmp_path / pkg / "snap")
        got = []
        for kw in (dict(standby_of="http://127.0.0.1:9"),
                   dict(writer_shards=2, wal=str(tmp_path / pkg / "w")),
                   dict(writer_shards=2, standby_of="http://127.0.0.1:9",
                        wal=str(tmp_path / pkg / "w2"))):
            with pytest.raises(ValueError) as e:
                PKGS[pkg].server(store, **kw)
            got.append(str(e.value).replace(str(tmp_path / pkg), "ROOT"))
        srv = PKGS[pkg].server(store)
        with pytest.raises(ValueError) as e:
            srv.apply_delta({"insert": [[0, 1]]}, ack="wal")
        got.append(str(e.value))
        with pytest.raises(ValueError) as e:
            srv.promote()
        got.append(str(e.value))
        srv.stop()
        outs.append(got)
    assert outs[0] == outs[1]


def test_memory_section_counts_the_log(tmp_path):
    outs = []
    for pkg in PKGS:
        store = _store(pkg, tmp_path / pkg / "snap")
        srv = PKGS[pkg].server(store, wal=str(tmp_path / pkg / "wal"))
        srv.apply_delta({"insert": [[0, 13]]}, delta_id="a")
        mem = srv.memory_payload()
        text = srv.metrics_text()
        # the segment's bytes: its one frame, whose wall clock varies in length
        assert mem["wal_segment_bytes"] == srv.wal.snapshot()["segment_bytes"] > 0
        outs.append(sorted(line.split("{")[0].split(" ")[0] for line in text.splitlines()
                           if line.startswith("graphmine_serve_wal_")
                           or line.startswith("graphmine_memory_wal")))
        srv.stop()
    assert outs[0] == outs[1] and "graphmine_memory_wal_segment_bytes" in outs[0]


# ---- standby, promote, fence ------------------------------------------------


def _standby_promote(pkg, tmp_path):
    sink = PKGS[pkg].sink()
    store = _store(pkg, tmp_path / "snap")
    wal_p = str(tmp_path / "wal-p")
    primary = PKGS[pkg].server(store, sink=sink, wal=wal_p)
    port = primary.start()[1]
    standby = PKGS[pkg].server(PKGS[pkg].Store(store.root), sink=sink,
                               wal=str(tmp_path / "wal-s"),
                               standby_of=f"http://127.0.0.1:{port}", primary_wal=wal_p)
    try:
        refused = standby.apply_delta({"insert": [[0, 13]]})
        assert refused["verdict"] == "shed" and "standby" in refused["reason"]
        primary.apply_delta({"insert": [[0, 13]]}, delta_id="shipped", ack="wal")
        assert primary.wait_applied(60)
        standby._shipper.poll_once()
        assert standby.wal.last_seq == primary.wal.last_seq == 1
        health = standby.healthz()
        assert health["standby"] and health["replication_lag_entries"] == 0
        PKGS[pkg].faults.writer_kill_mid_apply(primary)
        w = PKGS[pkg].wal.WriteAheadLog(wal_p)
        w.append({"insert": [[1, 14]]}, delta_id="tail")
        w.close()
        out = standby.promote()
        assert standby.wait_applied(120)
        res = standby.apply_delta({"insert": [[2, 15]]}, delta_id="new")
        with pytest.raises(PKGS[pkg].Fenced):
            primary.apply_delta({"insert": [[3, 16]]}, delta_id="zombie")
        fenced = [r["store_epoch"] for r in sink.records if r["phase"] == "publish_fenced"]
        promotes = [r["epoch"] for r in sink.records if r["phase"] == "writer_promote"]
        assert PKGS[pkg].validate(sink.records) == []
        return {"promote": {k: out[k] for k in ("promoted", "epoch", "replayed", "copied_tail",
                                                "was_standby_of")},
                "res": res["version"], "final": _final(standby), "fenced": fenced,
                "promotes": promotes, "health": {k: standby.healthz().get(k) for k in
                                                 ("writer_epoch", "standby")}}
    finally:
        standby.stop()
        try:
            primary.stop()
        except Exception:  # noqa: BLE001 — the listener is already gone
            pass


def test_standby_ships_promotes_and_fences_like_the_jax_pair(tmp_path):
    want = _standby_promote("jax", tmp_path / "j")
    got = _standby_promote("port", tmp_path / "p")
    want["promote"]["was_standby_of"] = got["promote"]["was_standby_of"] = "url"
    assert got == want
    assert got["promote"]["epoch"] == 1 and got["promote"]["copied_tail"] == 1
    assert got["fenced"] == [1] and got["health"] == {"writer_epoch": 1, "standby": None}


def _separate_store_rewind(pkg, tmp_path):
    sink = PKGS[pkg].sink()
    store = _store(pkg, tmp_path / "snap")
    primary = PKGS[pkg].server(store, sink=sink, wal=str(tmp_path / "wal-p"))
    port = primary.start()[1]
    shutil.copytree(tmp_path / "snap", tmp_path / "snap-b")
    standby = PKGS[pkg].server(PKGS[pkg].Store(str(tmp_path / "snap-b")), sink=sink,
                               wal=str(tmp_path / "wal-s"),
                               standby_of=f"http://127.0.0.1:{port}")
    try:
        for i in range(2):  # one publish each: no coalescing to race
            primary.apply_delta({"insert": [[i, 13 + i]]}, delta_id=f"acked{i}", ack="wal")
            assert primary.wait_applied(60)
        standby._shipper.poll_once()
        assert standby.wal.applied_version == 3
        primary.stop()
        with pytest.warns(UserWarning, match="rewinding the replay"):
            out = standby.promote()
        assert standby.wait_applied(120)
        return {"replayed": out["replayed"], "epoch": out["epoch"], "final": _final(standby),
                "primary": _final(primary)}
    finally:
        standby.stop()


def test_separate_store_standby_rewinds_like_the_jax_one(tmp_path):
    want = _separate_store_rewind("jax", tmp_path / "j")
    got = _separate_store_rewind("port", tmp_path / "p")
    assert got == want and got["replayed"] == 2
    assert got["final"]["src"] == got["primary"]["src"]


def test_ship_lag_injector_delays_the_standby(tmp_path):
    store = _store("port", tmp_path / "snap")
    primary = SnapshotServer(store, wal=str(tmp_path / "wal-p"), device="cpu")
    port = primary.start()[1]
    standby = SnapshotServer(SnapshotStore(store.root), wal=str(tmp_path / "wal-s"),
                             standby_of=f"http://127.0.0.1:{port}", ship_interval_s=0.05,
                             device="cpu")
    standby.start()
    try:
        faults.ship_lag(standby, 0.4)
        with pytest.raises(ValueError, match="standby"):
            faults.ship_lag(primary, 1.0)
        for i in range(2):
            primary.wal.append({"insert": [[0, 13 + i]]}, delta_id=f"lag{i}")
        deadline = time.monotonic() + 15
        while standby.wal.lookup("lag1") is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert standby.wal.lookup("lag1") == 2
        assert standby._shipper.snapshot()["polls"] >= 1
    finally:
        standby.stop()
        primary.stop()


# ---- a real SIGKILL: the port's serve CLI as a process ----------------------


def _spawn(store, wal, log):
    proc = subprocess.Popen(
        [sys.executable, "-m", "graphmine_tpu_torch.serve", "serve", "--store", str(store),
         "--wal", str(wal), "--port", "0", "--device", "cpu"],
        cwd=REPO, stderr=open(log, "w"), stdout=subprocess.DEVNULL)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        text = open(log).read()
        if "serving snapshot" in text:
            url = text.split("serving snapshot")[1].split(" on ")[1].split()[0]
            return proc, int(url.rsplit(":", 1)[1])
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    proc.kill()
    raise AssertionError(open(log).read())


def _wait_version(port, version, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        h = _get(port, "/healthz")
        if h["version"] >= version and h["wal"]["pending_entries"] == 0:
            return h
        time.sleep(0.05)
    raise AssertionError(f"never reached v{version}: {h}")


def test_sigkilled_serve_process_replays_every_ack_once(tmp_path):
    """``serve --wal`` as a process: two deltas acknowledged at the log
    and published, a duplicate id, a third acknowledged and the process
    SIGKILLed at once; the restarted process replays what was not
    published, once, and ends equal to the JAX server fed the same deltas
    without the kill."""
    _store("port", tmp_path / "snap")
    deltas = [{"insert": [[0, 13], [40, 2]]}, {"delete": [[0, 1]], "insert": [[5, 30]]},
              {"insert": [[13, 27]], "delete": [[14, 15]]}]
    proc, port = _spawn(tmp_path / "snap", tmp_path / "wal", tmp_path / "a.log")
    try:
        for i, body in enumerate(deltas[:2]):
            st, out = _post(port, "/delta", body, {"X-Delta-Id": f"d{i}", "X-Delta-Ack": "wal"})
            assert st == 202 and out["seq"] == i + 1
            _wait_version(port, i + 2)
        st, dup = _post(port, "/delta", deltas[1], {"X-Delta-Id": "d1", "X-Delta-Ack": "wal"})
        assert st == 200 and dup["verdict"] == "duplicate" and dup["applied"]
        st, out = _post(port, "/delta", deltas[2], {"X-Delta-Id": "d2", "X-Delta-Ack": "wal"})
        assert st == 202
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    proc, port = _spawn(tmp_path / "snap", tmp_path / "wal", tmp_path / "b.log")
    try:
        health = _wait_version(port, 4)
        assert health["wal"]["last_seq"] == health["wal"]["applied_seq"] == 3
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    got = SnapshotStore(str(tmp_path / "snap")).load()
    ref_store = _store("jax", tmp_path / "ref")
    ref = JSnapshotServer(ref_store)
    for body in deltas:
        ref.apply_delta(body)
    want = ref.engine.snapshot
    ref.stop()
    assert got.version == want.version == 4
    for k in ("src", "dst", "labels", "cc_labels"):
        assert np.array_equal(got[k], want[k]), k
