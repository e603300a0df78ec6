"""Fleet CLI: run a replicated serving fleet behind one router.

Counterpart of ``tools/fleet_cli.py``, with the same subcommands and
output::

    python -m graphmine_tpu_torch.serve.fleet_cli up --store /data/snap \
        --replicas 3 --standby --port 8400 --obs-dir /data/obs
    python -m graphmine_tpu_torch.serve.fleet_cli status  --url http://127.0.0.1:8400
    python -m graphmine_tpu_torch.serve.fleet_cli roll    --url http://127.0.0.1:8400
    python -m graphmine_tpu_torch.serve.fleet_cli promote --url http://127.0.0.1:8400

``up`` spawns N replica processes with ``subprocess.Popen`` (``python -m
graphmine_tpu_torch.serve serve --device DEV``, each on its own port off
``--replica-base-port``) over one shared snapshot store, waits for each to
answer ``/healthz``, and runs the router in the foreground until
interrupted. On a card, every replica is its own process with its own
CUDA context (the router never initialises CUDA). A replica that exits or
never answers fails ``up``: it is not restarted, and never on another
device. Replica 0 is the writer. With ``--standby`` (at least 2 replicas)
the writer runs with a write-ahead log (``serve --wal``) and replica 1 as
its log-shipped standby (``--standby-of`` + ``--primary-wal``); writer
loss then auto-promotes the standby behind the store's epoch fence instead
of leaving the fleet read-only. ``status`` prints the router's
``/fleetz``; ``roll`` triggers the zero-downtime rolling reload (drain,
/reload, re-probe, rejoin, one replica at a time, writer last);
``promote`` forces the standby-to-writer failover. Clients talk to the
router exactly as to one server (``python -m graphmine_tpu_torch.serve
query|delta --url``). Fleet knobs follow ``GRAPHMINE_FLEET_*``
(``serve/fleet.py`` ``FleetConfig``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request

# The directory holding the graphmine_tpu_torch package: replica
# processes import it from there wherever they are started.
_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def _get_json(url: str, timeout: float = 10.0) -> dict:
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_healthz(host: str, port: int, timeout_s: float, proc=None) -> bool:
    """Poll ``/healthz`` until it answers ok; False past ``timeout_s`` or
    as soon as ``proc`` (the replica's process) has exited."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            return False
        try:
            if _get_json(f"http://{host}:{port}/healthz", 2.0).get("ok"):
                return True
        except Exception:  # noqa: BLE001 — still starting
            pass
        time.sleep(0.2)
    return False


def replica_command(args, i: int) -> list:
    """The ``serve`` command line of replica ``i``: the writer (0), its
    standby (1, with ``--standby``) or a read replica."""
    cmd = [
        sys.executable, "-m", "graphmine_tpu_torch.serve", "serve",
        "--store", args.store, "--host", args.host,
        "--port", str(args.replica_base_port + i), "--device", args.device,
    ]
    if args.standby and i == 0:
        cmd += ["--wal", wal_dir(args, 0)]
    elif args.standby and i == 1:
        cmd += [
            "--wal", wal_dir(args, 1),
            "--standby-of", f"http://{args.host}:{args.replica_base_port}",
            "--primary-wal", wal_dir(args, 0),
        ]
    if args.obs_dir:
        cmd += ["--obs-dir", args.obs_dir]
    elif args.metrics_out:
        cmd += ["--metrics-out", f"{args.metrics_out}.replica{i}"]
    return cmd


def wal_dir(args, i: int) -> str:
    return f"{args.store.rstrip('/')}/wal-replica-{i}"


def stop_processes(procs, timeout_s: float = 10.0) -> None:
    """Terminate every replica process and wait for it; kill the ones
    still alive after ``timeout_s``."""
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(timeout=timeout_s)


def cmd_up(args) -> int:
    import signal

    from graphmine_tpu_torch.obs.spans import Tracer
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink
    from graphmine_tpu_torch.serve.fleet import FleetRouter, ReplicaSpec

    # SIGTERM (a supervisor, subprocess.terminate) must run the same
    # teardown as Ctrl-C, or the replica processes outlive the router.
    signal.signal(signal.SIGTERM, lambda *a: sys.exit(0))

    if args.standby and args.replicas < 2:
        print("fleet_cli: --standby needs at least 2 replicas",
              file=sys.stderr)
        return 2

    procs: list = []
    router = None
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])
    )
    try:
        for i in range(args.replicas):
            procs.append(subprocess.Popen(replica_command(args, i), env=env))
        for i, proc in enumerate(procs):
            port = args.replica_base_port + i
            if not _wait_healthz(args.host, port, args.startup_timeout_s, proc):
                code = proc.poll()
                why = (
                    f"exited with code {code}" if code is not None
                    else f"never answered /healthz within "
                         f"{args.startup_timeout_s:g}s"
                )
                print(
                    f"fleet_cli: replica {i} on port {port} {why}",
                    file=sys.stderr,
                )
                return 2
        sink = None
        if args.obs_dir:
            from graphmine_tpu_torch.pipeline.metrics import shard_sink

            sink = shard_sink(args.obs_dir, "router", max_records=100_000)
        elif args.metrics_out:
            sink = MetricsSink(stream_path=args.metrics_out, tracer=Tracer())
            sink.max_records = 100_000
        specs = [
            ReplicaSpec(f"replica-{i}", args.host, args.replica_base_port + i)
            for i in range(args.replicas)
        ]
        router = FleetRouter(
            specs, writer="replica-0", host=args.host, port=args.port,
            sink=sink,
            standby="replica-1" if args.standby else None,
        )
        host, port = router.start()
        print(
            f"fleet: {args.replicas} replica(s) behind http://{host}:{port} "
            f"(writer replica-0 on port {args.replica_base_port}"
            + (", standby replica-1 log-shipping its WAL"
               if args.standby else "")
            + f"; replica pids {[p.pid for p in procs]})",
            file=sys.stderr, flush=True,
        )
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        if router is not None:
            router.stop()
        stop_processes(procs)
    return 0


def cmd_status(args) -> int:
    try:
        out = _get_json(f"{args.url.rstrip('/')}/fleetz")
    except (urllib.error.URLError, OSError) as e:
        print(f"fleet_cli: router unreachable at {args.url}: {e}",
              file=sys.stderr)
        return 2
    if getattr(args, "shards", False):
        # sharded-write-plane view: collapse each replica's probed epoch
        # + per-range version vector into a range table ("which epoch is
        # served, which range is behind or read-only")
        out = {
            "committed_version": out.get("committed_version"),
            "writer": out.get("writer"),
            "read_only": out.get("read_only"),
            "replicas": [
                {
                    "id": r.get("id"),
                    "state": r.get("state"),
                    "writer": r.get("writer"),
                    "writer_shards": r.get("writer_shards"),
                    "epoch": r.get("epoch"),
                    "shard_versions": r.get("shard_versions"),
                    "degraded_shards": r.get("degraded_shards"),
                }
                for r in out.get("replicas", [])
            ],
        }
        print(json.dumps(out, indent=1))
        return 0
    if args.tenant:
        # per-tenant view: collapse each replica's tenant_versions map
        # (the prober's /healthz payload) to the one namespace asked for
        # — the roll/catch-up story for a single tenant at a glance
        out = {
            "tenant": args.tenant,
            "committed_version": out.get("committed_version"),
            "read_only": out.get("read_only"),
            "replicas": [
                {
                    "id": r.get("id"),
                    "state": r.get("state"),
                    "version": (r.get("tenant_versions") or {}).get(
                        args.tenant
                    ),
                    "writer": r.get("writer"),
                }
                for r in out.get("replicas", [])
            ],
        }
    print(json.dumps(out, indent=1))
    return 0


def _post_router(args, path: str) -> int:
    req = urllib.request.Request(
        f"{args.url.rstrip('/')}{path}", data=b"{}", method="POST",
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=args.timeout_s) as r:
            out = json.loads(r.read())
    except urllib.error.HTTPError as e:
        out = json.loads(e.read())
    except (urllib.error.URLError, OSError) as e:
        print(f"fleet_cli: router unreachable at {args.url}: {e}",
              file=sys.stderr)
        return 2
    print(json.dumps(out, indent=1))
    return 0 if out.get("ok") else 1


def cmd_roll(args) -> int:
    return _post_router(args, "/roll")


def cmd_promote(args) -> int:
    return _post_router(args, "/promote")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("up", help="spawn N replica processes + the router")
    p.add_argument("--store", required=True, help="shared snapshot store")
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8400,
                   help="the router's port (clients talk here)")
    p.add_argument("--replica-base-port", type=int, default=8450,
                   help="replica i listens on base+i")
    p.add_argument("--obs-dir", default=None,
                   help="router + every replica stream their records to "
                        "per-process shards (<role>-<pid>.jsonl) under "
                        "this directory")
    p.add_argument("--metrics-out", default=None,
                   help="router records here; replica i appends to "
                        "PATH.replicaI")
    p.add_argument("--startup-timeout-s", type=float, default=60.0)
    p.add_argument("--device", default="cuda",
                   help="every replica's device: cuda (default) or cpu")
    p.add_argument("--standby", action="store_true",
                   help="run replica-0 WAL-durable and replica-1 as its "
                        "log-shipped standby; writer loss auto-promotes "
                        "behind the store's epoch fence instead of going "
                        "read-only")
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("status", help="print the router's /fleetz")
    p.add_argument("--url", required=True, help="router base URL")
    p.add_argument("--tenant", default=None,
                   help="collapse the view to one tenant namespace: "
                        "per-replica versions for that tenant only")
    p.add_argument("--shards", action="store_true",
                   help="collapse the view to the sharded write plane: "
                        "per-replica committed epoch + per-range version "
                        "vector + degraded ranges")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("roll", help="trigger a zero-downtime rolling reload")
    p.add_argument("--url", required=True, help="router base URL")
    p.add_argument("--timeout-s", type=float, default=300.0)
    p.set_defaults(fn=cmd_roll)

    p = sub.add_parser(
        "promote",
        help="force the standby-to-writer failover",
    )
    p.add_argument("--url", required=True, help="router base URL")
    p.add_argument("--timeout-s", type=float, default=300.0)
    p.set_defaults(fn=cmd_promote)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
