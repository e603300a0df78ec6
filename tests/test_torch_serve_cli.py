"""Port parity: the serve and fleet CLIs (CPU).

``python -m graphmine_tpu_torch.serve info|query|delta`` print what
``tools/serve_cli.py`` prints against the same store and server (apart
from wall times and snapshot ids); ``request_with_retries`` retries,
backs off and honours ``Retry-After`` and deadlines as the JAX client
does, with one idempotency key across retries; and
``graphmine_tpu_torch.serve.fleet_cli`` answers ``status``, ``roll`` and
``promote`` as ``tools/fleet_cli.py`` does. ``up`` is held without
spawning a fleet: its replica command lines, the failure of a replica
that exits, and the teardown of its processes.
"""

import argparse
import importlib.util
import json
import random
import shutil
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

from graphmine_tpu.graph.container import build_graph as jbuild_graph
from graphmine_tpu.serve.delta import cold_recompute as jcold_recompute
from graphmine_tpu.serve.fleet import FleetConfig as JFleetConfig
from graphmine_tpu.serve.fleet import FleetRouter as JFleetRouter
from graphmine_tpu.serve.fleet import ReplicaSpec as JReplicaSpec
from graphmine_tpu.serve.server import SnapshotServer as JSnapshotServer
from graphmine_tpu.serve.snapshot import SnapshotStore as JSnapshotStore

from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
from graphmine_tpu_torch.serve import __main__ as cli
from graphmine_tpu_torch.serve import fleet_cli
from graphmine_tpu_torch.serve.fleet import FleetConfig, FleetRouter, ReplicaSpec
from graphmine_tpu_torch.serve.server import SnapshotServer
from graphmine_tpu_torch.serve.snapshot import SnapshotStore
from _torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jcli = _load_tool("serve_cli")
jfleet_cli = _load_tool("fleet_cli")

_DROP = {"seconds", "snapshot_id", "created", "parent", "snapshot_age_s", "uptime_s",
         "tenant_snapshot_age_s", "ingest_lag_s", "t"}


def _clean(body):
    if isinstance(body, dict):
        return {k: _clean(v) for k, v in body.items() if k not in _DROP}
    if isinstance(body, list):
        return [_clean(v) for v in body]
    return body


def _clique(lo, hi):
    ids = np.arange(lo, hi)
    s, d = np.meshgrid(ids, ids)
    m = s.ravel() < d.ravel()
    return s.ravel()[m], d.ravel()[m]


def _publish(root, tenant=None):
    parts = [_clique(0, 12), _clique(12, 26), _clique(26, 40)]
    src = np.concatenate([p[0] for p in parts]).astype(np.int32)
    dst = np.concatenate([p[1] for p in parts]).astype(np.int32)
    labels, cc, _ = jcold_recompute(jbuild_graph(src, dst, num_vertices=40))
    store = SnapshotStore(str(root))
    if tenant:
        store = store.for_tenant(tenant)
    store.publish({"src": src, "dst": dst, "labels": np.asarray(labels),
                   "cc_labels": np.asarray(cc),
                   "lof": np.linspace(0.5, 2.5, 40).astype(np.float32)},
                  fingerprint=graph_fingerprint(src, dst), run_id="cli")
    return store


def _run(main, argv, capsys):
    """``[exit code, the printed JSON]`` of one CLI call."""
    rc = main(argv)
    out = capsys.readouterr().out.strip()
    return [rc, json.loads(out) if out else None]


# ---- the store commands ------------------------------------------------------


@pytest.mark.parametrize("tenant", [None, "acme"])
def test_info_prints_what_the_jax_cli_prints(tmp_path, capsys, tenant):
    _publish(tmp_path / "snap")
    if tenant:
        _publish(tmp_path / "snap", tenant=tenant)
    argv = ["info", "--store", str(tmp_path / "snap")] + (["--tenant", tenant] if tenant else [])
    got, want = _run(cli.main, argv, capsys), _run(jcli.main, argv, capsys)
    assert got == want and got[0] == 0 and got[1]["version"] == 1
    assert got[1]["arrays"]["labels"] == [40]


def test_info_on_an_empty_store_fails_alike(tmp_path, capsys):
    argv = ["info", "--store", str(tmp_path / "empty")]
    assert cli.main(argv) == jcli.main(argv) == 2


@pytest.mark.parametrize("args", [
    ["--vertex", "3", "5", "13"], ["--neighbors", "3"], ["--explain", "7"],
    ["--community", "0", "--topk", "3"], ["--vertex", "1", "--neighbors", "2", "--explain", "3"],
])
def test_query_on_the_store_prints_what_the_jax_cli_prints(tmp_path, capsys, args):
    _publish(tmp_path / "snap")
    base = ["query", "--store", str(tmp_path / "snap")] + args
    got = _run(cli.main, base + ["--device", "cpu"], capsys)
    want = _run(jcli.main, base, capsys)
    assert _clean(got) == _clean(want) and got[0] == 0


@pytest.mark.parametrize("delta", [["--insert", "0,13", "--insert", "40,2"],
                                   ["--delete", "0,1", "--insert", "5,30"]])
def test_delta_on_the_store_prints_what_the_jax_cli_prints(tmp_path, capsys, delta):
    _publish(tmp_path / "p")
    shutil.copytree(tmp_path / "p", tmp_path / "j")
    got = _run(cli.main, ["delta", "--store", str(tmp_path / "p"), "--device", "cpu"] + delta,
               capsys)
    want = _run(jcli.main, ["delta", "--store", str(tmp_path / "j")] + delta, capsys)
    assert _clean(got) == _clean(want) and got[1]["version"] == 2
    a, b = SnapshotStore(str(tmp_path / "p")).load(), JSnapshotStore(str(tmp_path / "j")).load()
    for k in ("src", "dst", "labels", "cc_labels"):
        assert np.array_equal(a[k], b[k])


def test_num_shards_above_one_keeps_the_sharded_repair_refusal(tmp_path, capsys, monkeypatch):
    """``--num-shards 2`` repairs on two shards: on one device without a
    virtual mesh both subcommands refuse, naming the variable that makes
    one; with it, ``delta`` prints what the JAX CLI's sharded ``delta``
    prints and publishes the same labels."""
    _publish(tmp_path / "snap")
    shutil.copytree(tmp_path / "snap", tmp_path / "j")
    monkeypatch.delenv("GRAPHMINE_VIRTUAL_DEVICES", raising=False)
    delta = ["--num-shards", "2", "--insert", "0,13", "--delete", "0,1"]
    for argv in (["delta", "--store", str(tmp_path / "snap"), "--device", "cpu"] + delta,
                 ["serve", "--store", str(tmp_path / "snap"), "--device", "cpu",
                  "--num-shards", "2", "--port", "0"]):
        with pytest.raises(ValueError, match="GRAPHMINE_VIRTUAL_DEVICES=2"):
            cli.main(argv)
    monkeypatch.setenv("GRAPHMINE_VIRTUAL_DEVICES", "2")
    got = _run(cli.main, ["delta", "--store", str(tmp_path / "snap"), "--device", "cpu"] + delta,
               capsys)
    want = _run(jcli.main, ["delta", "--store", str(tmp_path / "j")] + delta, capsys)
    assert _clean(got) == _clean(want) and got[1]["version"] == 2
    a, b = SnapshotStore(str(tmp_path / "snap")).load(), JSnapshotStore(str(tmp_path / "j")).load()
    for k in ("labels", "cc_labels"):
        assert np.array_equal(a[k], b[k])
    assert a.meta["mesh_shape"] == b.meta["mesh_shape"] == [2]


def test_store_or_url_is_required_alike(capsys):
    for main in (cli.main, jcli.main):
        with pytest.raises(SystemExit):
            main(["query", "--vertex", "1"])
    assert "one of --store or --url" in capsys.readouterr().err


# ---- the HTTP clients against a live port server ----------------------------


@pytest.fixture
def served(tmp_path):
    _publish(tmp_path / "snap")
    srv = SnapshotServer(SnapshotStore(str(tmp_path / "snap")), wal=str(tmp_path / "wal"),
                         device="cpu")
    port = srv.start()[1]
    yield srv, f"http://127.0.0.1:{port}"
    srv.stop()


@pytest.mark.parametrize("args", [["--vertex", "3", "5"], ["--neighbors", "4", "--explain", "9"],
                                  ["--community", "1", "--topk", "2"], []])
def test_query_url_prints_what_the_jax_client_prints(served, capsys, args):
    _, url = served
    argv = ["query", "--url", url] + args
    assert _run(cli.main, argv, capsys) == _run(jcli.main, argv, capsys)


def test_delta_url_ack_wal_and_retry_dedupe_alike(served, capsys):
    srv, url = served
    got = _run(cli.main, ["delta", "--url", url, "--insert", "0,13", "--delta-id", "k1",
                          "--ack-wal"], capsys)
    assert srv.wait_applied(60)
    want = _run(jcli.main, ["delta", "--url", url, "--insert", "0,13", "--delta-id", "k1",
                            "--ack-wal"], capsys)
    assert got[0] == want[0] == 0
    assert got[1]["status"] == 202 and got[1]["verdict"] == "accepted"
    assert want[1]["status"] == 200 and want[1]["verdict"] == "duplicate" and want[1]["applied"]
    again = _run(cli.main, ["delta", "--url", url, "--insert", "0,13", "--delta-id", "k1"],
                 capsys)
    assert _clean(again) == _clean(want)
    src, dst = np.asarray(srv.engine.snapshot["src"]), np.asarray(srv.engine.snapshot["dst"])
    assert int(((src == 0) & (dst == 13)).sum()) == 1


class _ShedThenOk(BaseHTTPRequestHandler):
    sheds_left = 2
    retry_after = "1"
    seen = []

    def log_message(self, fmt, *args):  # noqa: A003
        pass

    def do_POST(self):  # noqa: N802
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        type(self).seen.append((self.headers.get("X-Delta-Id"),
                                self.headers.get("X-Deadline-Ms")))
        if type(self).sheds_left > 0:
            type(self).sheds_left -= 1
            body = json.dumps({"verdict": "shed", "reason": "test"}).encode()
            self.send_response(503)
            if type(self).retry_after:
                self.send_header("Retry-After", type(self).retry_after)
        else:
            body = json.dumps({"version": 2}).encode()
            self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def _stub(sheds, retry_after="1"):
    class H(_ShedThenOk):
        pass

    H.sheds_left, H.retry_after, H.seen = sheds, retry_after, []
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, H, "http://127.0.0.1:%d" % httpd.server_address[1]


@pytest.mark.parametrize("sheds,retry_after,max_retries", [(2, "3", 4), (100, "", 3),
                                                           (1, "", 2), (0, "1", 0)])
def test_retries_back_off_like_the_jax_client(sheds, retry_after, max_retries):
    outs = []
    for mod in (cli, jcli):
        httpd, H, url = _stub(sheds, retry_after)
        slept = []
        try:
            out = mod.request_with_retries(f"{url}/delta", {"insert": [[1, 2]]},
                                           max_retries=max_retries, sleep=slept.append,
                                           rng=random.Random("seeded"))
        finally:
            httpd.shutdown()
            httpd.server_close()
        outs.append((out["status"], out["attempts"], out["body"], slept))
    assert outs[0] == outs[1]
    if retry_after:
        assert all(s >= float(retry_after) for s in outs[0][3])


def test_deadline_bounds_retries_and_rides_every_attempt():
    for mod in (cli, jcli):
        httpd, H, url = _stub(100)
        try:
            t0 = time.monotonic()
            out = mod.request_with_retries(f"{url}/delta", {}, deadline_ms=600, max_retries=50,
                                           sleep=lambda s: time.sleep(min(s, 0.2)))
            elapsed = time.monotonic() - t0
        finally:
            httpd.shutdown()
            httpd.server_close()
        assert out["status"] == 503 and elapsed < 5.0
        deadlines = [int(d) for _, d in H.seen if d]
        assert deadlines == sorted(deadlines, reverse=True) and deadlines[0] <= 600


def test_delta_sends_one_idempotency_key_across_retries(capsys):
    for main in (cli.main, jcli.main):
        httpd, H, url = _stub(2)
        try:
            rc, out = _run(main, ["delta", "--url", url, "--insert", "1,2", "--max-retries", "4"],
                           capsys)
        finally:
            httpd.shutdown()
            httpd.server_close()
        assert rc == 0 and out["status"] == 200 and out["attempts"] == 3
        ids = [i for i, _ in H.seen]
        assert len(ids) == 3 and len(set(ids)) == 1 and ids[0] == out["delta_id"]


def test_transport_failure_is_status_zero_alike():
    outs = []
    for mod in (cli, jcli):
        out = mod.request_with_retries("http://127.0.0.1:9/x", None, max_retries=1,
                                       sleep=lambda s: None, rng=random.Random(1))
        outs.append((out["status"], out["attempts"], "error" in out["body"]))
    assert outs[0] == outs[1] == (0, 2, True)


# ---- the fleet CLI -----------------------------------------------------------


def _fleet(pkg, root, standby=False):
    Store, Server = (SnapshotStore, lambda s, **kw: SnapshotServer(s, device="cpu", **kw)) \
        if pkg == "port" else (JSnapshotStore, JSnapshotServer)
    _publish(root / "snap")
    servers = []
    for i in range(3):
        kw = {}
        if standby and i == 0:
            kw = {"wal": str(root / "wal-0")}
        elif standby and i == 1:
            h, p = servers[0]._httpd.server_address[:2]
            kw = {"wal": str(root / "wal-1"), "standby_of": f"http://{h}:{p}",
                  "primary_wal": str(root / "wal-0")}
        srv = Server(Store(str(root / "snap")), **kw)
        srv.start()
        servers.append(srv)
    Spec, Router, Config = (ReplicaSpec, FleetRouter, FleetConfig) if pkg == "port" else (
        JReplicaSpec, JFleetRouter, JFleetConfig)
    specs = [Spec(f"r{i}", *s._httpd.server_address[:2]) for i, s in enumerate(servers)]
    router = Router(specs, writer="r0", standby="r1" if standby else None,
                    config=Config(probe_interval_s=0.08, reload_cadence_s=0.1,
                                  down_after_probes=2, rejoin_timeout_s=15.0))
    host, port = router.start()
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and not all(
            r.state == "healthy" for r in router.replica_set.replicas()):
        time.sleep(0.03)
    return servers, router, f"http://{host}:{port}"


def _stop(servers, router):
    router.stop()
    for s in servers:
        s.stop()


_FLEETZ_DROP = _DROP | {"last_probe_s", "last_transition_s", "latency", "probe_ms",
                        "since_s", "age_s", "breaker", "last_reason", "reason", "probes",
                        "url", "port", "host", "ttv", "time_to_visible", "state_age_s"}


def _fz(body):
    if isinstance(body, dict):
        return {k: _fz(v) for k, v in body.items() if k not in _FLEETZ_DROP}
    if isinstance(body, list):
        return [_fz(v) for v in body]
    return body


@pytest.mark.parametrize("extra", [[], ["--shards"], ["--tenant", "acme"]])
def test_fleet_status_prints_what_the_jax_cli_prints(tmp_path, capsys, extra):
    outs = []
    for pkg, main in (("jax", jfleet_cli.main), ("port", fleet_cli.main)):
        servers, router, url = _fleet(pkg, tmp_path / pkg)
        try:
            rc = main(["status", "--url", url] + extra)
            outs.append((rc, _fz(json.loads(capsys.readouterr().out))))
        finally:
            _stop(servers, router)
    assert outs[0] == outs[1] and outs[0][0] == 0


def test_fleet_roll_and_promote_print_what_the_jax_cli_prints(tmp_path, capsys):
    outs = []
    for pkg, main in (("jax", jfleet_cli.main), ("port", fleet_cli.main)):
        servers, router, url = _fleet(pkg, tmp_path / pkg, standby=True)
        try:
            rc_roll = main(["roll", "--url", url, "--timeout-s", "60"])
            roll = json.loads(capsys.readouterr().out)
            rc_promote = main(["promote", "--url", url, "--timeout-s", "60"])
            promote = json.loads(capsys.readouterr().out)
            outs.append((rc_roll, [(r["id"], r["version"]) for r in roll["rolled"]], roll["ok"],
                         rc_promote, promote["ok"], promote.get("epoch"),
                         promote.get("writer")))
        finally:
            _stop(servers, router)
    assert outs[0] == outs[1]
    assert outs[0][:3] == (0, [("r1", 1), ("r2", 1), ("r0", 1)], True)


def test_fleet_cli_unreachable_router_fails_alike(capsys):
    for main in (jfleet_cli.main, fleet_cli.main):
        assert main(["status", "--url", "http://127.0.0.1:9"]) == 2
        assert main(["roll", "--url", "http://127.0.0.1:9", "--timeout-s", "2"]) == 2
    assert "router unreachable" in capsys.readouterr().err


def test_up_builds_the_replica_command_lines():
    args = argparse.Namespace(
        store="/s/", host="127.0.0.1", replica_base_port=8450, device="cuda", standby=True,
        obs_dir=None, metrics_out="/m.jsonl")
    cmds = [fleet_cli.replica_command(args, i) for i in range(3)]
    head = [sys.executable, "-m", "graphmine_tpu_torch.serve", "serve", "--store", "/s/",
            "--host", "127.0.0.1"]
    assert all(c[:8] == head for c in cmds)
    assert cmds[0][8:] == ["--port", "8450", "--device", "cuda", "--wal", "/s/wal-replica-0",
                           "--metrics-out", "/m.jsonl.replica0"]
    assert cmds[1][8:] == ["--port", "8451", "--device", "cuda", "--wal", "/s/wal-replica-1",
                           "--standby-of", "http://127.0.0.1:8450",
                           "--primary-wal", "/s/wal-replica-0", "--metrics-out",
                           "/m.jsonl.replica1"]
    assert cmds[2][8:] == ["--port", "8452", "--device", "cuda", "--metrics-out",
                           "/m.jsonl.replica2"]
    args.obs_dir, args.standby = "/obs", False
    assert fleet_cli.replica_command(args, 0)[8:] == ["--port", "8450", "--device", "cuda",
                                                      "--obs-dir", "/obs"]


class _FakeProc:
    """A Popen stand-in: ``exit_code`` None keeps it running; ``stubborn``
    ignores terminate."""

    def __init__(self, exit_code=None, stubborn=False):
        self.code, self.stubborn, self.calls = exit_code, stubborn, []
        self.pid = 4242

    def poll(self):
        return self.code

    def terminate(self):
        self.calls.append("terminate")
        if not self.stubborn:
            self.code = -15

    def kill(self):
        self.calls.append("kill")
        self.code = -9

    def wait(self, timeout=None):
        if self.code is None:
            raise subprocess.TimeoutExpired("fake", timeout)
        return self.code


def test_stop_processes_terminates_then_kills_the_stubborn():
    procs = [_FakeProc(), _FakeProc(stubborn=True), _FakeProc(exit_code=0)]
    fleet_cli.stop_processes(procs, timeout_s=0.01)
    assert procs[0].calls == ["terminate"] and procs[1].calls == ["terminate", "kill"]
    assert procs[2].calls == [] and all(p.code is not None for p in procs)


def test_up_fails_when_a_replica_exits_and_tears_down_the_rest(tmp_path, monkeypatch, capsys):
    spawned = []

    def fake_popen(cmd, env=None):
        assert "graphmine_tpu_torch.serve" in cmd and env["PYTHONPATH"].split(":")[0]
        proc = _FakeProc(exit_code=1 if len(spawned) == 1 else None)
        spawned.append(proc)
        return proc

    monkeypatch.setattr(fleet_cli.subprocess, "Popen", fake_popen)
    import signal

    monkeypatch.setattr(signal, "signal", lambda *a: None)  # keep pytest's SIGTERM
    rc = fleet_cli.main(["up", "--store", str(tmp_path), "--replicas", "3", "--device", "cuda",
                         "--startup-timeout-s", "0.5", "--replica-base-port", "9"])
    assert rc == 2 and len(spawned) == 3
    assert "replica 0 on port 9 never answered" in capsys.readouterr().err
    assert all(p.code is not None for p in spawned)
    assert spawned[0].calls == ["terminate"] and spawned[1].calls == []


def test_up_refuses_a_standby_without_two_replicas(capsys):
    for main in (fleet_cli.main, jfleet_cli.main):
        assert main(["up", "--store", "/nowhere", "--replicas", "1", "--standby"]) == 2
    assert "--standby needs at least 2 replicas" in capsys.readouterr().err
