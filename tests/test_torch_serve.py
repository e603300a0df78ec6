"""Port parity: the HTTP snapshot server, admission and alerts (CPU).

A JAX ``SnapshotServer`` and the port's serve copies of one store; the
same requests get the same statuses and the same bodies apart from timing
fields and the random part of snapshot ids (LOF within the port's stated
tolerance after deltas). Admission verdicts, coalescing and the LOF-defer
rung are held against the JAX ``AdmissionController`` and
``coalesce_deltas``; the alert rules against the JAX ``AlertManager``; the
tenant registry against the JAX one. Then the port's own contracts: swap
under live queries, 400 on null fields, the constructor's answers to the
WAL, standby and writer-shard arguments (as the JAX server's), ``/profilez``
and the serve CLI, which the JAX ``serve_cli.py`` client drives over HTTP.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.obs import alerts as jalerts
from graphmine_tpu.pipeline.metrics import MetricsSink as JMetricsSink
from graphmine_tpu.serve import admission as jadm
from graphmine_tpu.serve import tenancy as jten
from graphmine_tpu.serve.delta import EdgeDelta as JEdgeDelta
from graphmine_tpu.serve.delta import cold_recompute as jcold_recompute
from graphmine_tpu.serve.server import SnapshotServer as JSnapshotServer
from graphmine_tpu.serve.snapshot import SnapshotStore as JSnapshotStore
from graphmine_tpu.testing import faults as jfaults

from graphmine_tpu_torch import datasets
from graphmine_tpu_torch.obs import alerts
from graphmine_tpu_torch.obs.schema import validate_records
from graphmine_tpu_torch.obs.spans import Tracer
from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from graphmine_tpu_torch.serve import admission as adm
from graphmine_tpu_torch.serve import tenancy
from graphmine_tpu_torch.serve.delta import EdgeDelta
from graphmine_tpu_torch.serve.server import SnapshotServer
from graphmine_tpu_torch.serve.snapshot import SnapshotStore
from graphmine_tpu_torch.testing import faults
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
V = 400
# response keys that carry wall times or a snapshot id's random part
_TIMING = {"snapshot_age_s", "tenant_snapshot_age_s", "seconds", "ingest_lag_s",
           "snapshot_id", "uptime_s", "created", "parent", "t"}


def _results(body):
    if isinstance(body, dict):
        return {k: _results(v) for k, v in body.items() if k not in _TIMING}
    if isinstance(body, list):
        return [_results(v) for v in body]
    return body


def _lof_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.abs(got - want) / np.abs(want)
    assert (rel <= 1e-4).mean() >= 0.999 and rel.max() <= 1e-2, rel.max()


def _req(port, method, path, body=None, headers=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, dict(e.headers), json.loads(raw) if raw else None


def _base(root):
    src, dst, _, _ = datasets.planted_anomaly_graph(V, 3000, seed=3)
    src, dst = src.astype(np.int32), dst.astype(np.int32)
    labels, cc, _ = jcold_recompute(jbuild_graph(src, dst, num_vertices=V))
    arrays = {"src": src, "dst": dst, "labels": labels, "cc_labels": cc,
              "lof": np.linspace(0.5, 2.5, V).astype(np.float32)}
    SnapshotStore(str(root / "base")).publish(arrays, fingerprint=graph_fingerprint(src, dst))
    return src, dst, labels


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve")
    src, dst, labels = _base(root)
    shutil.copytree(root / "base", root / "j")
    shutil.copytree(root / "base", root / "p")
    sink = MetricsSink(tracer=Tracer())
    js = JSnapshotServer(JSnapshotStore(str(root / "j")))
    ps = SnapshotServer(SnapshotStore(str(root / "p")), sink=sink, device="cpu")
    jport, pport = js.start()[1], ps.start()[1]
    yield {"j": jport, "p": pport, "src": src, "dst": dst, "labels": labels, "sink": sink,
           "server": ps}
    js.stop()
    ps.stop()


_READS = [("GET", "/healthz", None), ("GET", "/vertex?v=5", None), ("GET", "/neighbors?v=7", None),
          ("GET", "/topk?community=0&k=5", None), ("GET", "/explain?vertex=9", None),
          ("GET", "/explain?v=11", None), ("GET", "/snapshot", None),
          ("POST", "/query", {"vertices": list(range(0, V, 3))}),
          ("GET", "/vertex?v=999999", None), ("GET", "/nope", None), ("GET", "/wal", None),
          ("POST", "/promote", None), ("POST", "/query", {"vertices": None}),
          ("POST", "/query", {"vertices": [1, None]}), ("POST", "/query", {"vertices": [1.5]}),
          ("GET", "/vertex?v=1&tenant=Bad/../x", None), ("GET", "/vertex?v=1&tenant=ghost", None),
          ("POST", "/profilez", {"duration_ms": 5})]


@pytest.mark.parametrize("method,path,body", _READS, ids=[f"{m} {p}" for m, p, _ in _READS])
def test_reads_match_the_jax_server(pair, method, path, body):
    a = _req(pair["j"], method, path, body)
    b = _req(pair["p"], method, path, body)
    assert b[0] == a[0]
    if path == "/snapshot":  # manifest meta: the publisher's run ids differ in no field
        assert set(b[2]) == set(a[2])
        return
    assert _results(b[2]) == _results(a[2])
    assert b[1].get("X-Request-Id")


def test_deltas_match_the_jax_server(pair):
    src, dst = pair["src"], pair["dst"]
    deltas = [{"insert": [[1, 2], [V, 5], [V, 6]]},
              {"delete": [[int(src[0]), int(dst[0])], [int(src[1]), int(dst[1])]]},
              {"insert": [[3, 9]], "delete": [[int(src[5]), int(dst[5])]]},
              {"insert": [[1, 2]], "delete": None}, {"insert": [[1.9, 2.7]]}]
    for body in deltas:
        a, b = _req(pair["j"], "POST", "/delta", body), _req(pair["p"], "POST", "/delta", body)
        assert b[0] == a[0]
        assert _results(b[2]) == _results(a[2])
    ids = list(range(0, V + 1, 2))
    a = _req(pair["j"], "POST", "/query", {"vertices": ids})[2]
    b = _req(pair["p"], "POST", "/query", {"vertices": ids})[2]
    _lof_close(b.pop("lof"), a.pop("lof"))
    assert b == a
    a, b = _req(pair["j"], "GET", "/alertz")[2], _req(pair["p"], "GET", "/alertz")[2]
    assert [r["name"] for r in b["rules"]] == [r["name"] for r in a["rules"]]
    assert b["firing"] == a["firing"] and b["version"] == a["version"] == 4
    assert b["quality"]["state"]["num_communities"] == a["quality"]["state"]["num_communities"]
    assert set(b["quality"]) == set(a["quality"])
    a, b = _req(pair["j"], "GET", "/statusz")[2], _req(pair["p"], "GET", "/statusz")[2]
    assert set(b) == set(a)
    assert b["repair_debt"] == a["repair_debt"] | {"ingest_lag_s": b["repair_debt"]["ingest_lag_s"]}
    assert set(b["query_stages"]) == set(a["query_stages"])
    status, _, text = 200, None, urllib.request.urlopen(
        f"http://127.0.0.1:{pair['p']}/metrics", timeout=30).read().decode()
    assert "graphmine_serve_snapshot_version" in text
    assert "graphmine_serve_request_seconds_bucket" in text
    assert validate_records(pair["sink"].records) == []


def test_version_pin_and_request_id(pair):
    v = _req(pair["p"], "GET", "/healthz")[2]["version"]
    ok = _req(pair["p"], "GET", "/vertex?v=1", headers={"X-Serve-Version": str(v),
                                                         "X-Request-Id": "abc-123"})
    assert ok[0] == 200 and ok[1]["X-Request-Id"] == "abc-123"
    stale = _req(pair["p"], "GET", "/vertex?v=1", headers={"X-Serve-Version": str(v - 1)})
    assert stale[0] == 409 and stale[2]["requested"] == v - 1
    log = [r for r in pair["sink"].of_phase("access_log") if r["request_id"] == "abc-123"]
    assert log and log[0]["endpoint"] == "vertex" and log[0]["status"] == 200


def test_drain_undrain_and_reload(pair):
    assert _req(pair["p"], "POST", "/drain")[2]["ready"] is False
    assert _req(pair["p"], "GET", "/healthz")[2]["not_ready_reason"] == "draining"
    assert _req(pair["p"], "POST", "/undrain")[2]["ready"] is True
    out = _req(pair["p"], "POST", "/reload")[2]
    assert out["swapped"] is False


def test_swap_under_live_queries(tmp_path):
    _base(tmp_path)
    sink = MetricsSink(tracer=Tracer())
    server = SnapshotServer(SnapshotStore(str(tmp_path / "base")), sink=sink, device="cpu")
    port = server.start()[1]
    errors, versions, stop = [], set(), threading.Event()

    def hammer():
        while not stop.is_set():
            try:
                status, _, out = _req(port, "POST", "/query", {"vertices": [0, 13, 27]})
                assert status == 200 and len(out["label"]) == 3
                versions.add(out["version"])
            except Exception as e:  # noqa: BLE001 -- collected, then held to none
                errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        out = _req(port, "POST", "/delta", {"insert": [[V, 12], [V, 13]], "delete": [[0, 1]]})
        assert out[0] == 200 and out[2]["version"] == 2 and out[2]["num_vertices"] == V + 1
        assert _req(port, "GET", "/healthz")[2]["version"] == 2
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        server.stop()
    assert errors == [] and versions and versions <= {1, 2}
    assert validate_records(sink.records) == []


def test_shed_answers_503_with_retry_after_and_keeps_state(pair):
    before = _req(pair["p"], "GET", "/healthz")[2]["version"]
    body = {"insert": np.random.default_rng(1).integers(0, 8, (150_000, 2)).tolist()}
    a, b = _req(pair["j"], "POST", "/delta", body), _req(pair["p"], "POST", "/delta", body)
    assert a[0] == b[0] == 503 and b[1]["Retry-After"] == a[1]["Retry-After"] == "2"
    assert b[2] == a[2] and b[2]["verdict"] == "shed"
    assert _req(pair["p"], "GET", "/healthz")[2]["version"] == before


# ---- admission -------------------------------------------------------------


def _debt(pending=0, lag=0.0):
    return {"pending_rows": pending, "ingest_lag_s": lag}


@pytest.mark.parametrize("rows,depth,debt,applying,replay", [
    (10, 0, _debt(), False, False), (10, 0, _debt(), True, False), (10, 2, _debt(), False, False),
    (10, 16, _debt(), False, False), (60_000, 0, _debt(), False, False),
    (10, 0, _debt(99_995), False, False), (10, 0, _debt(lag=61.0), False, False),
    (10, 0, _debt(lag=31.0), False, False), (10, 20, _debt(), False, True),
], ids=["accept", "queue", "coalesce", "depth", "defer", "pending", "lag", "defer_lag", "replay"])
def test_admission_verdicts_match(rows, depth, debt, applying, replay):
    a = jadm.AdmissionController().resolve(rows, depth, debt, applying=applying, replay=replay)
    b = adm.AdmissionController().resolve(rows, depth, debt, applying=applying, replay=replay)
    assert b == adm.AdmissionDecision(**vars(a))


def test_admission_bounds_env_and_records_match(monkeypatch):
    monkeypatch.setenv("GRAPHMINE_ADMIT_MAX_PENDING_ROWS", "50")
    monkeypatch.setenv("GRAPHMINE_ADMIT_DEFER_FRAC", "0.25")
    assert adm.AdmissionBounds.from_env().snapshot() == jadm.AdmissionBounds.from_env().snapshot()
    monkeypatch.setenv("GRAPHMINE_ADMIT_MAX_LAG_S", "soon")
    for mod in (adm, jadm):
        with pytest.raises(ValueError):
            mod.AdmissionBounds.from_env()
    sink = MetricsSink()
    ctl = adm.AdmissionController(bounds=adm.AdmissionBounds(max_pending_rows=50), sink=sink,
                                  tenant="t1")
    d = ctl.resolve(60, 0, _debt())
    ctl.record_shed(d.reason, 60, 0, _debt())
    ctl.record_coalesce({"batches": 2, "inserts": 1, "deletes": 0, "rows_in": 3,
                         "rows_out": 1}, _debt())
    assert [r["phase"] for r in sink.records] == ["admission", "delta_shed", "delta_coalesce"]
    assert all(r["tenant"] == "t1" for r in sink.records)
    assert validate_records(sink.records) == []
    assert ctl.snapshot()["verdicts"]["shed"] == 1


@pytest.mark.parametrize("weighted", [False, True])
def test_coalesce_matches_jax(weighted):
    rng = np.random.default_rng(4)
    base_src = rng.integers(0, 30, 200)
    base_dst = rng.integers(0, 30, 200)
    batches = []
    for i in range(4):
        ins = rng.integers(0, 32, (6, 2)).tolist()
        if weighted:
            ins = [r + [0.5 * (i + 1)] for r in ins]
        dele = [[int(base_src[j]), int(base_dst[j])] for j in rng.integers(0, 200, 3)]
        dele += ins[:2] if not weighted else [r[:2] for r in ins[:2]]
        batches.append((ins, dele))
    a, ia = jadm.coalesce_deltas([JEdgeDelta.from_pairs(*b) for b in batches], base_src, base_dst)
    b, ib = adm.coalesce_deltas([EdgeDelta.from_pairs(*b) for b in batches], base_src, base_dst)
    assert ia == ib
    for name in ("insert_src", "insert_dst", "delete_src", "delete_dst", "insert_weight"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name))


def test_coalesced_group_and_lof_defer_through_the_server(tmp_path):
    """A slowed repair piles three deltas behind the first: they publish as
    one coalesced apply; a bound with defer_frac=0 defers the LOF."""
    _base(tmp_path)
    sink = MetricsSink()
    server = SnapshotServer(SnapshotStore(str(tmp_path / "base")), sink=sink, device="cpu",
                            admission=adm.AdmissionController(
                                bounds=adm.AdmissionBounds(defer_frac=0.0)))
    port = server.start()[1]
    inj = faults.FaultInjector().add("delta_repair", faults.slow_repair(0.6), repeat=4)
    results = []
    try:
        with inj.installed():
            payloads = faults.delta_burst(V, 4, 5, seed=2)
            threads = [threading.Thread(target=lambda p=p: results.append(
                _req(port, "POST", "/delta", p))) for p in payloads]
            threads[0].start()
            time.sleep(0.3)
            for t in threads[1:]:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        server.stop()
    assert all(r[0] == 200 for r in results)
    assert max(r[2]["coalesced"] for r in results) >= 2
    assert all(r[2]["lof_stale"] for r in results)
    verdicts = [r["verdict"] for r in sink.of_phase("admission")]
    assert verdicts[0] == "accept" and {"queue", "coalesce"} & set(verdicts[1:])
    assert sink.of_phase("delta_coalesce")
    assert validate_records(sink.records) == []


def test_delta_burst_and_noisy_neighbor_match_jax():
    a = jfaults.delta_burst(50, 3, 8, seed=5, delete_frac=0.5, base_src=np.arange(20),
                            base_dst=np.arange(20) + 1)
    b = faults.delta_burst(50, 3, 8, seed=5, delete_frac=0.5, base_src=np.arange(20),
                           base_dst=np.arange(20) + 1)
    assert a == b
    pa, sa = jfaults.noisy_neighbor_burst("t2", 50, 2, 4, seed=1, stall_s=0.01)
    pb, sb = faults.noisy_neighbor_burst("t2", 50, 2, 4, seed=1, stall_s=0.01)
    assert pa == pb and sb.wants_ctx and sb(tenant="other") is None


def test_slow_client_post_is_served(pair):
    status, body = faults.slow_client_post("127.0.0.1", pair["p"], "/query",
                                           {"vertices": [1, 2, 3]}, chunk_bytes=4, delay_s=0.001)
    assert status == 200 and body["label"] == _req(pair["p"], "POST", "/query",
                                                   {"vertices": [1, 2, 3]})[2]["label"]


# ---- alerts and tenancy -----------------------------------------------------


def test_alert_rules_and_transitions_match(monkeypatch):
    monkeypatch.setenv("GRAPHMINE_ALERT_INGEST_LAG_FOR_S", "2")
    ja, pa = jalerts.AlertManager(clock=lambda: 0.0), alerts.AlertManager(clock=lambda: 0.0)
    assert [vars(r) for r in pa.rules] == [vars(r) for r in ja.rules]
    seq = [(0.0, {"canary_recall": 0.5, "ingest_lag_s": 90.0}),
           (1.0, {"ingest_lag_s": 90.0, "quality_lof_psi": 0.3}),
           (3.0, {"ingest_lag_s": 90.0, "canary_recall": 0.9}),
           (4.0, {"ingest_lag_s": 1.0, "memory_headroom_frac": 0.05})]
    for now, values in seq:
        assert pa.evaluate(values, now=now) == ja.evaluate(values, now=now)
    assert pa.snapshot() == ja.snapshot() and pa.firing() == ja.firing()
    monkeypatch.setenv("GRAPHMINE_ALERT_LOF_PSI", "high")
    with pytest.raises(ValueError):
        alerts.default_rules()
    with pytest.raises(ValueError):
        alerts.AlertRule("x", "m", ">=", 1.0)


def test_tenant_registry_matches(monkeypatch):
    monkeypatch.setenv("GRAPHMINE_TENANT_BOUNDS", json.dumps({"acme": {"max_queue_depth": 3}}))
    a, b = jten.TenantRegistry({"b2": {"deadline_s": 5.0}}), tenancy.TenantRegistry(
        {"b2": {"deadline_s": 5.0}})
    for reg in (a, b):
        reg.note("zed")
        reg.note_bytes("zed", 123)
    assert b.snapshot() == a.snapshot() and b.tenants() == a.tenants()
    assert b.bounds_for("acme").snapshot() == a.bounds_for("acme").snapshot()
    assert b.memory_payload(1000) == a.memory_payload(1000)
    for bad in ("", "A", "a/b", "x" * 65):
        with pytest.raises(ValueError):
            b.note(bad)
    monkeypatch.setenv("GRAPHMINE_TENANT_BOUNDS", "[1]")
    with pytest.raises(ValueError):
        tenancy.TenantRegistry()


def test_tenant_namespace_is_served_and_charged(tmp_path):
    src, dst, labels = _base(tmp_path)
    store = SnapshotStore(str(tmp_path / "base"))
    store.for_tenant("acme").publish({"src": src[:100], "dst": dst[:100],
                                      "labels": np.zeros(V, np.int32)},
                                     fingerprint=graph_fingerprint(src[:100], dst[:100]))
    server = SnapshotServer(store, device="cpu")
    port = server.start()[1]
    try:
        a = _req(port, "GET", "/vertex?v=3", headers={"X-Tenant-Id": "acme"})
        assert a[0] == 200 and a[2]["label"] == 0
        assert _req(port, "GET", "/vertex?v=3")[2]["label"] == int(labels[3])
        out = _req(port, "POST", "/delta?tenant=acme", {"insert": [[1, 2]]})
        assert out[0] == 200 and out[2]["version"] == 2
        health = _req(port, "GET", "/healthz")[2]
        assert health["tenant_versions"] == {"default": 1, "acme": 2} and health["tenants"] == 2
        assert _req(port, "GET", "/vertex?v=99999", headers={"X-Tenant-Id": "acme"})[0] == 404
    finally:
        server.stop()


# ---- the port's own contracts ----------------------------------------------


@pytest.mark.parametrize("kw,env", [(dict(wal=True), {}), (dict(standby_of="http://x:1"), {}),
                                    (dict(primary_wal="/nowhere"), {}),
                                    (dict(writer_shards=2), {}),
                                    ({}, {"GRAPHMINE_WRITER_SHARDS": "4"})],
                         ids=["wal", "standby", "primary_wal", "writer_shards", "env_shards"])
def test_later_batch_raises_naming_the_roadmap(tmp_path, monkeypatch, kw, env):
    """The durable write path, standbys and the sharded write plane have
    landed: the constructor answers these arguments as the JAX server's
    does (a standby without its own log is a ValueError in both, the rest
    construct) and never with NotImplementedError; the sharded repair
    (``num_shards > 1``) runs, and on one device without a virtual mesh its
    error names the variable that makes one."""
    _base(tmp_path)
    shutil.copytree(tmp_path / "base", tmp_path / "j")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outs = []
    for make in (lambda: JSnapshotServer(JSnapshotStore(str(tmp_path / "j")), **kw),
                 lambda: SnapshotServer(SnapshotStore(str(tmp_path / "base")), device="cpu",
                                        **kw)):
        try:
            srv = make()
        except ValueError as e:
            outs.append(("ValueError", str(e)))
        else:
            outs.append(("ok", srv.writer_shards, srv.wal is not None,
                         srv.standby_of, srv.healthz().get("writer_shards")))
            srv.stop()
    assert outs[0] == outs[1]
    monkeypatch.delenv("GRAPHMINE_VIRTUAL_DEVICES", raising=False)
    with pytest.raises(ValueError, match="GRAPHMINE_VIRTUAL_DEVICES=2"):
        SnapshotServer(SnapshotStore(str(tmp_path / "base")), device="cpu", num_shards=2)


def test_sharded_repair_server_answers_as_the_jax_server(tmp_path, monkeypatch):
    """``num_shards=2``: a delta over HTTP repairs on the two-shard mesh of
    both servers with the same answer, publish, repair record and
    ``shard_exchange`` family."""
    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "2")
    _base(tmp_path)
    shutil.copytree(tmp_path / "base", tmp_path / "j")
    sink, jsink = MetricsSink(), JMetricsSink()
    servers = (JSnapshotServer(JSnapshotStore(str(tmp_path / "j")), sink=jsink, num_shards=2),
               SnapshotServer(SnapshotStore(str(tmp_path / "base")), sink=sink, num_shards=2,
                              device="cpu"))
    ports = [srv.start()[1] for srv in servers]
    try:
        body = {"insert": [[1, 2], [V, 3]], "delete": [[int(x) for x in _base_edge(tmp_path)]]}
        a, b = (_req(port, "POST", "/delta", body) for port in ports)
        assert b[0] == a[0] == 200 and _results(b[2]) == _results(a[2])
        snaps = [srv.engine.snapshot for srv in servers]
        for name in ("labels", "cc_labels", "src", "dst"):
            np.testing.assert_array_equal(snaps[1][name], snaps[0][name])
        ra, rb = jsink.of_phase("delta_apply")[-1], sink.of_phase("delta_apply")[-1]
        for key in ("method", "iterations", "budget", "version"):
            assert rb[key] == ra[key], key
        ea, eb = jsink.of_phase("shard_exchange")[-1], sink.of_phase("shard_exchange")[-1]
        assert (eb["family"], eb["devices"]) == (ea["family"], ea["devices"])
        assert snaps[1].meta["mesh_shape"] == [2]
    finally:
        for srv in servers:
            srv.stop()


def _base_edge(root):
    snap = SnapshotStore(str(root / "base")).load()
    return snap["src"][0], snap["dst"][0]


def test_wal_ack_and_promote_answer_as_without_a_log(pair):
    a = _req(pair["j"], "POST", "/delta", {"insert": [[1, 2]]}, headers={"X-Delta-Ack": "wal"})
    b = _req(pair["p"], "POST", "/delta", {"insert": [[1, 2]]}, headers={"X-Delta-Ack": "wal"})
    assert b[0] == a[0] == 400 and b[2] == a[2]
    bad = _req(pair["p"], "POST", "/delta", {"insert": [[1, 2]]}, headers={"X-Delta-Ack": "x"})
    assert bad[0] == 400


def test_profilez_guard_trace_and_memory(tmp_path):
    _base(tmp_path)
    sink = MetricsSink()
    server = SnapshotServer(SnapshotStore(str(tmp_path / "base")), sink=sink, device="cpu",
                            profilez_dir=str(tmp_path / "prof"))
    try:
        status, body = server.profilez(duration_ms=5)
        assert status == 200 and os.path.isfile(os.path.join(body["dir"], "trace.json"))
        status, body = server.profilez(kind="memory")
        assert status == 501 and "error" in body  # no CUDA allocator on the CPU
        assert [r["ok"] for r in sink.of_phase("profile_capture")] == [True, False]
    finally:
        server.stop()


def test_serve_cli_answers_the_jax_client(tmp_path):
    _base(tmp_path)
    proc = subprocess.Popen(
        [sys.executable, "-m", "graphmine_tpu_torch.serve", "serve", "--store",
         str(tmp_path / "base"), "--port", "0", "--device", "cpu",
         "--metrics-out", str(tmp_path / "m.jsonl")],
        cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        lines = []
        for _ in range(50):  # the banner, after any warnings the imports print
            lines.append(proc.stderr.readline())
            if "serving snapshot" in lines[-1] or not lines[-1]:
                break
        line = lines[-1]
        assert "serving snapshot v1 on http://" in line, lines
        url = line.split(" on ")[1].split()[0]
        env = {**os.environ, "JAX_PLATFORMS": "cpu"}
        q = subprocess.run([sys.executable, "tools/serve_cli.py", "query", "--url", url,
                            "--vertex", "3", "5", "--neighbors", "3"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert q.returncode == 0, q.stderr
        out = json.loads(q.stdout.strip().splitlines()[-1])
        assert out["status"] == 200 and len(out["label"]) == 2 and out["vertex"] == 3
        assert out["neighbors"] == _req(int(url.rsplit(":", 1)[1]), "GET",
                                        "/neighbors?v=3")[2]["neighbors"]
        d = subprocess.run([sys.executable, "tools/serve_cli.py", "delta", "--url", url,
                            "--insert", f"{V},3", "--delete", "0,1"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert d.returncode == 0, d.stderr
        assert json.loads(d.stdout.strip().splitlines()[-1])["version"] == 2
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_an_out_of_memory_apply_resolves_like_the_jax_server(tmp_path):
    """A ``torch.cuda.OutOfMemoryError`` raised inside the apply (at the
    repair seam) resolves the pending batch with that error, as the JAX
    server resolves its errors: the caller gets it, the served version and
    the debt ledger are unchanged, and the next delta publishes on the
    served snapshot."""
    _base(tmp_path)
    shutil.copytree(tmp_path / "base", tmp_path / "j")
    js = JSnapshotServer(JSnapshotStore(str(tmp_path / "j")))
    ps = SnapshotServer(SnapshotStore(str(tmp_path / "base")), device="cpu")
    body = {"insert": [[1, 2], [V, 3]]}
    try:
        for srv, mod, err in ((js, jfaults, Exception), (ps, faults, RuntimeError)):
            inj = mod.FaultInjector().add("delta_repair", mod.oom_error)
            with inj.installed(), pytest.raises(err):
                srv.apply_delta(body)
            assert srv.engine.version == 1 and srv.debt.snapshot()["pending_rows"] == 0
            assert srv.apply_delta(body)["version"] == 2
        import torch

        with faults.FaultInjector().add("delta_repair", faults.oom_error).installed():
            with pytest.raises(torch.cuda.OutOfMemoryError):
                ps.apply_delta({"insert": [[4, 5]]})
        assert ps._ingestor is None  # the next apply rebuilds from the served snapshot
        out = ps.apply_delta({"insert": [[4, 5]]})
        assert out["version"] == 3 and ps.engine.snapshot["src"][-1] == 4
    finally:
        js.stop()
        ps.stop()


def test_sink_record_cap_and_shard_sink(tmp_path):
    """The serve CLI's bounded sink: past ``max_records`` the oldest
    in-memory records drop, and the stream keeps every one; ``shard_sink``
    streams to ``<dir>/<role>-<pid>.jsonl`` with a tracer."""
    from graphmine_tpu_torch.pipeline.metrics import shard_sink

    sink = shard_sink(str(tmp_path / "obs"), "serve/x", max_records=3)
    assert sink.stream_path == str(tmp_path / "obs" / f"serve-x-{os.getpid()}.jsonl")
    for i in range(5):
        sink.emit("warning", message=str(i))
    assert [r["message"] for r in sink.records] == ["2", "3", "4"]
    sink.finalize(sink.stream_path)
    lines = [json.loads(x) for x in open(sink.stream_path)]
    assert [r["message"] for r in lines] == ["0", "1", "2", "3", "4"]
    assert all("trace_id" in r for r in lines)
    other = tmp_path / "copy.jsonl"
    sink.finalize(str(other))
    assert [json.loads(x)["message"] for x in open(other)] == ["2", "3", "4"]
