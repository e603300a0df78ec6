"""Port parity: the replicated serving fleet (CPU).

Every test holds the port against the JAX package: the circuit breaker's
state sequence under scripted outcomes, the replica set's committed
version and picks, the ``GRAPHMINE_FLEET_*`` configuration, and the router
over in-process port replicas answering as the JAX router over JAX
replicas: consistent-version routing with the pin echo, the replica's 409
on a mismatched pin, the retry onto a live replica and the 503 when none
is left, the stale and the drained replica out of rotation, writer
forwarding, writer loss to read-only and back, the fenced failover onto a
log-shipped standby, the rolling reload and its abort below the minimum
healthy count.
"""

import json
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.obs.schema import validate_records as jvalidate
from graphmine_tpu.obs.spans import Tracer as JTracer
from graphmine_tpu.pipeline.metrics import MetricsSink as JMetricsSink
from graphmine_tpu.pipeline.resilience import ResilienceConfig as JResilienceConfig
from graphmine_tpu.serve import fleet as jfleet
from graphmine_tpu.serve import wal as jwal
from graphmine_tpu.serve.delta import cold_recompute as jcold_recompute
from graphmine_tpu.serve.server import SnapshotServer as JSnapshotServer
from graphmine_tpu.serve.snapshot import SnapshotStore as JSnapshotStore
from graphmine_tpu.testing import faults as jfaults

from graphmine_tpu_torch.obs.schema import validate_records
from graphmine_tpu_torch.obs.spans import Tracer
from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
from graphmine_tpu_torch.pipeline.metrics import MetricsSink
from graphmine_tpu_torch.pipeline.resilience import ResilienceConfig
from graphmine_tpu_torch.serve import fleet as pfleet
from graphmine_tpu_torch.serve import wal as pwal
from graphmine_tpu_torch.serve.server import SnapshotServer
from graphmine_tpu_torch.serve.snapshot import SnapshotStore
from graphmine_tpu_torch.testing import faults
from _torch_threads import one_torch_thread  # noqa: F401

PKGS = {
    "jax": SimpleNamespace(
        fleet=jfleet, wal=jwal, Store=JSnapshotStore, faults=jfaults, Resilience=JResilienceConfig,
        sink=lambda: JMetricsSink(tracer=JTracer()), validate=jvalidate,
        server=lambda store, **kw: JSnapshotServer(store, **kw),
    ),
    "port": SimpleNamespace(
        fleet=pfleet, wal=pwal, Store=SnapshotStore, faults=faults, Resilience=ResilienceConfig,
        sink=lambda: MetricsSink(tracer=Tracer()), validate=validate_records,
        server=lambda store, **kw: SnapshotServer(store, device="cpu", **kw),
    ),
}


def _both(scenario, *args, **kw):
    """Run ``scenario(pkg, ...)`` for the JAX package and the port; return
    the port's outcome after holding it equal to the JAX one."""
    want = scenario("jax", *args, **kw)
    got = scenario("port", *args, **kw)
    assert got == want
    return got


# ---- the breaker and the replica set ---------------------------------------


_SCRIPTS = {
    "open_half_open_close": ["f", "f", "f", "tick", "due", "probe-", "tick", "due",
                             "probe+", "s", "s", "s", "s", "s", "s"],
    "rate_below_bar": ["s", "s", "f", "s", "s", "f", "s", "s", "f"],
    "flapping": ["f", "f", "f", "tick", "due", "probe+", "f", "f", "f", "tick", "due",
                 "probe-", "tick", "tick", "due", "probe+"],
    "not_due_yet": ["f", "f", "f", "due", "due", "tick", "due", "due"],
}


def _breaker_run(pkg, script):
    fleet = PKGS[pkg].fleet
    now = [100.0]
    seen = []
    b = fleet.CircuitBreaker(
        "r1", window=6, open_failures=3, open_rate=0.5,
        backoff=PKGS[pkg].Resilience(backoff_base_s=0.5, backoff_max_s=4.0),
        on_transition=lambda f, t, r: seen.append((f, t, r)), clock=lambda: now[0],
    )
    trail = []
    for step in script:
        if step == "f":
            b.record_failure("timeout")
        elif step == "s":
            b.record_success()
        elif step == "tick":
            now[0] += 10.0
        elif step == "due":
            trail.append(b.probe_due())
        elif step == "probe+":
            b.probe_result(True, "answered")
        elif step == "probe-":
            b.probe_result(False, "still slow")
        trail.append((b.state, b.allow_request()))
    snap = b.snapshot()
    return {"trail": trail, "seen": seen,
            "snap": {k: v for k, v in snap.items() if "until" not in k and "_at" not in k}}


@pytest.mark.parametrize("name", _SCRIPTS)
def test_breaker_state_sequence_matches(name):
    out = _both(_breaker_run, _SCRIPTS[name])
    if name == "open_half_open_close":
        assert [(f, t) for f, t, _ in out["seen"]] == [
            ("closed", "open"), ("open", "half_open"), ("half_open", "open"),
            ("open", "half_open"), ("half_open", "closed")]


_SETS = {
    "all_v1": [(1, "healthy")] * 3,
    "one_ahead": [(2, "healthy"), (1, "healthy"), (1, "healthy")],
    "two_ahead": [(2, "healthy"), (2, "healthy"), (1, "healthy")],
    "down_holds_nothing": [(2, "healthy"), (2, "down"), (1, "healthy")],
    "degraded_fallback": [(1, "healthy"), (1, "degraded"), (2, "healthy")],
    "draining": [(3, "draining"), (3, "healthy"), (3, "joining")],
}


def _set_run(pkg, rows):
    fleet = PKGS[pkg].fleet
    specs = [fleet.ReplicaSpec(chr(97 + i), "h", i) for i in range(len(rows))]
    rs = fleet.ReplicaSet(specs, writer="a", config=fleet.FleetConfig(probe_interval_s=0.08))
    for spec, (version, state) in zip(specs, rows):
        rep = rs.replica(spec.id)
        rep.version, rep.state = version, state
    rs._recompute()
    committed = rs.committed_version()
    picks = []
    for v in (1, 2, 3):
        got = {getattr(rs.pick(v), "spec", SimpleNamespace(id=None)).id for _ in range(6)}
        picks.append(sorted(x or "-" for x in got))
        ex = rs.pick(v, exclude=("a",))
        picks.append(ex.spec.id if ex is not None else None)
    for _ in range(6):
        rs.replica("a").breaker.record_failure("x")
    after_open = rs.pick(committed or 1)
    return {"quorum": rs.quorum, "committed": committed, "picks": picks,
            "after_open": after_open.spec.id if after_open else None,
            "read_only": rs.read_only}


@pytest.mark.parametrize("name", _SETS)
def test_replica_set_committed_version_and_picks_match(name):
    _both(_set_run, _SETS[name])


def test_committed_version_never_goes_back_in_either():
    def run(pkg):
        fleet = PKGS[pkg].fleet
        specs = [fleet.ReplicaSpec(c, "h", i) for i, c in enumerate("abc")]
        rs = fleet.ReplicaSet(specs, writer="a", config=fleet.FleetConfig())
        out = []
        for rows in ([(2, "healthy")] * 3, [(2, "down"), (2, "down"), (1, "healthy")]):
            for spec, (v, st) in zip(specs, rows):
                rs.replica(spec.id).version, rs.replica(spec.id).state = v, st
            rs._recompute()
            pick = rs.pick(2)
            out.append((rs.committed_version(), pick is not None))
        return out
    assert _both(run) == [(2, True), (2, False)]


@pytest.mark.parametrize("env", [{}, {"GRAPHMINE_FLEET_PROBE_INTERVAL_S": "0.5",
                                     "GRAPHMINE_FLEET_QUORUM": "2",
                                     "GRAPHMINE_FLEET_READ_TIMEOUT_S": "3"},
                                 {"GRAPHMINE_FLEET_MIN_HEALTHY": "x"},
                                 {"GRAPHMINE_FLEET_BREAKER_OPEN_RATE": "1.5"}])
def test_fleet_config_from_env_matches(monkeypatch, env):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    outs = []
    for pkg in PKGS:
        try:
            outs.append(("ok", PKGS[pkg].fleet.FleetConfig.from_env(down_after_probes=3)
                         .snapshot()))
        except ValueError as e:
            outs.append(("err", str(e)))
    assert outs[0] == outs[1]


# ---- the router over in-process replicas ------------------------------------


def _clique(lo, hi):
    ids = np.arange(lo, hi)
    s, d = np.meshgrid(ids, ids)
    m = s.ravel() < d.ravel()
    return s.ravel()[m], d.ravel()[m]


_PARTS = [_clique(0, 12), _clique(12, 26), _clique(26, 40)]
_SRC = np.concatenate([p[0] for p in _PARTS]).astype(np.int32)
_DST = np.concatenate([p[1] for p in _PARTS]).astype(np.int32)
_LABELS, _CC, _ = jcold_recompute(jbuild_graph(_SRC, _DST, num_vertices=40))


def _arrays(extra=0):
    """v1's arrays, or an external publish adding ``extra`` vertices (each
    joined to vertex 12), with its cold labels."""
    src, dst, v = _SRC, _DST, 40
    if extra:
        src = np.concatenate([src, np.arange(40, 40 + extra, dtype=np.int32)])
        dst = np.concatenate([dst, np.full(extra, 12, np.int32)])
        v += extra
    labels, cc, _ = jcold_recompute(jbuild_graph(src, dst, num_vertices=v))
    return {"src": src, "dst": dst, "labels": np.asarray(labels), "cc_labels": np.asarray(cc),
            "lof": np.zeros(v, np.float32)}


def _store(pkg, root):
    store = PKGS[pkg].Store(str(root))
    store.publish(_arrays(), fingerprint=graph_fingerprint(_SRC, _DST))
    return store


def _external_publish(store, extra=1):
    arrays = _arrays(extra)
    store.publish(arrays, fingerprint=graph_fingerprint(arrays["src"], arrays["dst"]))


def _post(host, port, path, payload, headers=None, timeout=60):
    req = urllib.request.Request(
        f"http://{host}:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(host, port, path, timeout=30):
    with urllib.request.urlopen(f"http://{host}:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def _config(pkg, **overrides):
    kv = dict(probe_interval_s=0.08, probe_timeout_s=4.0, read_timeout_s=0.4,
              down_after_probes=2, reload_cadence_s=0.1, rejoin_timeout_s=15.0,
              breaker_window=6, breaker_open_failures=3, breaker_open_rate=0.5,
              breaker_backoff_base_s=0.3, breaker_backoff_max_s=1.0, retry_after_s=1.0,
              default_deadline_ms=5000, promote_timeout_s=120.0)
    kv.update(overrides)
    return PKGS[pkg].fleet.FleetConfig(**kv)


class _Fleet:
    """One package's in-process fleet: ``n`` replicas (real servers on
    their own ports) behind that package's router."""

    def __init__(self, pkg, root, n=3, config=None, standby=False):
        P = self.P = PKGS[pkg]
        self.pkg = pkg
        self.sink = P.sink()
        self.store = _store(pkg, root / "snap")
        self.root = root
        self.servers = []
        kws = [{}] * n
        if standby:
            kws = [{"wal": str(root / "wal-0")}, None] + [{}] * (n - 2)
        for i, kw in enumerate(kws):
            if kw is None:
                h, p = self.servers[0]._httpd.server_address[:2]
                kw = {"wal": str(root / "wal-1"), "standby_of": f"http://{h}:{p}",
                      "primary_wal": str(root / "wal-0")}
            srv = P.server(P.Store(self.store.root), **kw)
            srv.start()
            self.servers.append(srv)
        self.addrs = [s._httpd.server_address[:2] for s in self.servers]
        self.specs = [P.fleet.ReplicaSpec(f"r{i}", h, p) for i, (h, p) in enumerate(self.addrs)]
        self.router = P.fleet.FleetRouter(
            self.specs, writer="r0", sink=self.sink, config=config or _config(pkg),
            standby="r1" if standby else None)
        self.host, self.port = self.router.start()

    def wait(self, pred, what, timeout=15.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(0.03)
        raise AssertionError(f"{self.pkg}: never {what}: {self.router.replica_set.snapshot()}")

    def wait_committed(self, version):
        self.wait(lambda: (self.router.replica_set.committed_version() or 0) >= version,
                  f"committed v{version}")

    def q(self, headers=None, vertices=(0,)):
        code, body, hdr = _post(self.host, self.port, "/query", {"vertices": list(vertices)},
                                headers)
        # the reason's tail names whichever replica failed last: random
        return (code, body.get("version"), hdr.get("X-Pinned-Version"),
                body.get("reason", "").split(":")[0])

    def stop(self):
        self.router.stop()
        for s in self.servers:
            try:
                s.stop()
            except Exception:  # noqa: BLE001 — killed replicas
                pass
        assert self.P.validate(self.sink.records) == []


def _routing(pkg, tmp_path):
    f = _Fleet(pkg, tmp_path / pkg)
    try:
        f.wait_committed(1)
        out = [f.q()]
        _external_publish(f.store)
        h1, p1 = f.addrs[1]
        out.append(_post(h1, p1, "/reload", {})[1]["swapped"])
        time.sleep(0.3)
        out.append(f.router.replica_set.committed_version())
        out += [f.q() for _ in range(4)]
        h2, p2 = f.addrs[2]
        _post(h2, p2, "/reload", {})
        f.wait_committed(2)
        out += [f.q(vertices=(40,)), f.q({"X-Pinned-Version": "1"}),
                f.q({"X-Pinned-Version": "9"})]
        code, body, _ = _post(h1, p1, "/query", {"vertices": [0]}, {"X-Serve-Version": "7"})
        out.append((code, body["version"], body["requested"]))
        verdicts = sorted({r["verdict"] for r in f.sink.records if r["phase"] == "fleet_route"})
        out.append(verdicts)
        return out
    finally:
        f.stop()


def test_consistent_version_routing_and_the_pin_match(tmp_path):
    out = _both(_routing, tmp_path)
    assert out[0] == (200, 1, "1", "")
    assert out[-3][0] == 503 and "pinned v9" in out[-3][3]
    assert out[-2] == (409, 2, 7)


def _retry_and_none(pkg, tmp_path):
    f = _Fleet(pkg, tmp_path / pkg)
    try:
        f.wait_committed(1)
        f.P.faults.replica_kill(f.servers[2])
        out = [f.q() for _ in range(6)]
        f.wait(lambda: f.router.replica_set.replica("r2").state == "down", "r2 down")
        f.P.faults.replica_kill(f.servers[0])
        f.P.faults.replica_kill(f.servers[1])
        t0 = time.monotonic()
        out.append(f.q({"X-Deadline-Ms": "800"}))
        assert time.monotonic() - t0 < 3.0
        out.append(sorted({r["verdict"] for r in f.sink.records if r["phase"] == "fleet_route"}))
        return out
    finally:
        f.stop()


def test_retry_onto_a_live_replica_and_503_when_none_match(tmp_path):
    out = _both(_retry_and_none, tmp_path)
    assert out[:6] == [(200, 1, "1", "")] * 6
    assert out[6][0] == 503 and "no eligible replica" in out[6][3]


def _stale_and_drained(pkg, tmp_path):
    f = _Fleet(pkg, tmp_path / pkg)
    try:
        f.wait_committed(1)
        f.P.faults.replica_stale(f.servers[2])
        _external_publish(f.store)
        for i in (0, 1):
            _post(*f.addrs[i], "/reload", {})
        f.wait_committed(2)
        out = []
        for _ in range(8):
            code, body, hdr = _post(f.host, f.port, "/query", {"vertices": [0]})
            out.append((code, body["version"], hdr["X-Fleet-Replica"] in {"r0", "r1"}))
        out.append(f.servers[2].engine.version)
        f.P.faults.replica_stale(f.servers[2], False)
        f.wait(lambda: f.servers[2].engine.version == 2, "r2 caught up")
        _post(*f.addrs[1], "/drain", {})
        f.wait(lambda: f.router.replica_set.replica("r1").state == "draining", "r1 draining")
        for _ in range(6):
            out.append(_post(f.host, f.port, "/query", {"vertices": [0]})[2]["X-Fleet-Replica"]
                       in {"r0", "r2"})
        _post(*f.addrs[1], "/undrain", {})
        f.wait(lambda: f.router.replica_set.replica("r1").state == "healthy", "r1 back")
        return out
    finally:
        f.stop()


def test_stale_and_drained_replicas_leave_rotation_alike(tmp_path):
    out = _both(_stale_and_drained, tmp_path)
    assert out[:8] == [(200, 2, True)] * 8 and out[8] == 1 and all(out[9:])


def _writer_loss(pkg, tmp_path):
    f = _Fleet(pkg, tmp_path / pkg)
    try:
        f.wait_committed(1)
        code, body, hdr = _post(f.host, f.port, "/delta", {"insert": [[0, 13], [0, 14]]})
        out = [(code, body["version"], hdr["X-Fleet-Replica"])]
        f.wait_committed(2)
        f.wait(lambda: all(s.engine.version == 2 for s in f.servers), "every replica at v2")
        f.P.faults.replica_kill(f.servers[0])
        f.wait(lambda: f.router.replica_set.read_only, "read-only")
        code, body, hdr = _post(f.host, f.port, "/delta", {"insert": [[0, 15]]})
        out.append((code, "read-only" in body["reason"], int(hdr["Retry-After"]) >= 1))
        out.append(f.q())
        h = _get(f.host, f.port, "/healthz")
        out.append((h["read_only"], h["ok"]))
        fz = _get(f.host, f.port, "/fleetz")
        out.append(next(r["state"] for r in fz["replicas"] if r["writer"]))
        host, port = f.addrs[0]
        f.servers[0] = f.P.server(f.P.Store(f.store.root), host=host, port=port)
        deadline = time.monotonic() + 10
        while True:
            try:
                f.servers[0].start()
                break
            except OSError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.2)
        f.wait(lambda: not f.router.replica_set.read_only, "writable again")
        code, body, _ = _post(f.host, f.port, "/delta", {"insert": [[0, 16]]})
        out.append((code, body["version"]))
        out.append([r["read_only"] for r in f.sink.records if r["phase"] == "fleet_degraded"])
        return out
    finally:
        f.stop()


def test_writer_forwarding_loss_to_read_only_and_back_match(tmp_path):
    out = _both(_writer_loss, tmp_path)
    assert out[0] == (200, 2, "r0") and out[1] == (503, True, True)
    assert out[-1] == [True, False] and out[-2] == (200, 3)


def _failover(pkg, tmp_path):
    f = _Fleet(pkg, tmp_path / pkg, standby=True)
    try:
        f.wait_committed(1)
        code, body, _ = _post(f.host, f.port, "/delta", {"insert": [[0, 13]]},
                              {"X-Delta-Id": "a", "X-Delta-Ack": "wal"})
        out = [(code, body["verdict"])]
        f.wait_committed(2)
        f.P.faults.writer_kill_mid_apply(f.servers[0])
        log = f.P.wal.WriteAheadLog(str(f.root / "wal-0"))
        log.append({"insert": [[1, 14]]}, delta_id="tail")
        log.close()
        f.wait(lambda: f.router.replica_set.writer_id == "r1", "promoted r1", timeout=30)
        assert f.servers[1].wait_applied(60)
        code, body, hdr = _post(f.host, f.port, "/delta", {"insert": [[2, 15]]},
                                {"X-Delta-Id": "b"})
        out.append((code, body["version"], hdr["X-Fleet-Replica"]))
        edges = set(zip(np.asarray(f.servers[1].engine.snapshot["src"]).tolist(),
                        np.asarray(f.servers[1].engine.snapshot["dst"]).tolist()))
        out.append({(0, 13), (1, 14), (2, 15)} <= edges)
        out.append(f.servers[1].writer_epoch)
        promotes = [r for r in f.sink.records if r["phase"] == "writer_promote"]
        out.append([(r["epoch"], r.get("replica")) for r in promotes])
        fz = _get(f.host, f.port, "/fleetz")
        out.append((fz["writer"], fz.get("standby"), fz["read_only"]))
        return out
    finally:
        f.stop()


def test_fenced_failover_onto_the_standby_matches(tmp_path):
    out = _both(_failover, tmp_path)
    assert out[0] == (202, "accepted") and out[1][0] == 200 and out[2] is True
    assert out[3] == 1


def _rolling(pkg, tmp_path, min_healthy=1):
    f = _Fleet(pkg, tmp_path / pkg, config=_config(pkg, min_healthy=min_healthy))
    try:
        f.wait_committed(1)
        _external_publish(f.store, extra=2)
        code, out, _ = _post(f.host, f.port, "/roll", {})
        res = [code, out["ok"], [(r["id"], r["version"]) for r in out["rolled"]],
               out.get("committed_version"), "min_healthy" in (out.get("aborted") or "")]
        res.append([s.engine.version for s in f.servers])
        res.append(sorted((r["from_state"], r["to_state"]) for r in f.sink.records
                          if r["phase"] == "replica_health"
                          and "draining" in (r["from_state"], r["to_state"])))
        return res
    finally:
        f.stop()


def test_rolling_reload_walks_the_fleet_alike(tmp_path):
    out = _both(_rolling, tmp_path)
    assert out[:4] == [200, True, [("r1", 2), ("r2", 2), ("r0", 2)], 2]
    assert out[5] == [2, 2, 2]


def test_rolling_reload_aborts_below_min_healthy_alike(tmp_path):
    out = _both(_rolling, tmp_path, min_healthy=3)
    assert out[:3] == [409, False, []] and out[4] is True and out[5] == [1, 1, 1]


def _surfaces(pkg, tmp_path):
    f = _Fleet(pkg, tmp_path / pkg)
    try:
        f.wait_committed(1)
        f.q()
        hz = _get(f.host, f.port, "/healthz")
        fz = _get(f.host, f.port, "/fleetz")
        sz = _get(f.host, f.port, "/statusz")
        az = _get(f.host, f.port, "/alertz")
        with urllib.request.urlopen(f"http://{f.host}:{f.port}/metrics", timeout=30) as r:
            metrics = r.read().decode()
        names = sorted({ln.split("{")[0].split(" ")[0] for ln in metrics.splitlines()
                        if ln.startswith("graphmine_fleet_")})
        return {"healthz": sorted(hz), "fleetz": sorted(fz),
                "replica_keys": sorted(fz["replicas"][0]), "statusz": sorted(sz),
                "alertz": sorted(az), "metrics": names,
                "committed": (hz["committed_version"], fz["committed_version"])}
    finally:
        f.stop()


def test_router_surfaces_carry_the_same_keys(tmp_path):
    out = _both(_surfaces, tmp_path)
    assert out["committed"] == (1, 1) and out["metrics"]
