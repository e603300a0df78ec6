"""Serve CLI: run the snapshot server, query it, ingest deltas.

Counterpart of ``tools/serve_cli.py``, with the same subcommands, flags and
output::

    python -m graphmine_tpu_torch.serve info  --store /data/snap
    python -m graphmine_tpu_torch.serve query --store /data/snap --vertex 12 44 7
    python -m graphmine_tpu_torch.serve delta --store /data/snap \\
        --insert 10,11 --delete 3,4
    python -m graphmine_tpu_torch.serve serve --store /data/snap --port 8337 \\
        [--wal DIR] [--standby-of URL --primary-wal DIR] [--device cpu]

``serve`` runs a :class:`~graphmine_tpu_torch.serve.server.SnapshotServer`
on ``--device`` (CUDA unless ``--device cpu``) until interrupted; STORE is
any port or JAX publish. ``--wal DIR`` makes accepted deltas durable
before the acknowledgement (replayed on restart); ``--wal DIR
--standby-of URL [--primary-wal DIR]`` runs the log-shipped standby.
``GRAPHMINE_WRITER_SHARDS`` > 1 runs the sharded write plane.
``--num-shards`` > 1 repairs deltas on a mesh of that many shards on
``--device`` (several on one device only with ``GRAPHMINE_VIRTUAL_DEVICES``).

``info`` reads the store's manifest (and the sharded write plane's
committed epoch, when the store has one). ``query`` and ``delta`` run
in-process against ``--store`` on ``--device``, or, with ``--url``, talk
to a running server or fleet router with client-side resilience: 503s
and transport failures retry up to ``--max-retries`` times with
decorrelated-jitter backoff, honouring ``Retry-After``, and
``--deadline-ms`` bounds the whole exchange and rides every attempt as
``X-Deadline-Ms``. ``delta --url`` sends one ``X-Delta-Id`` idempotency
key reused across retries (``--delta-id`` names it), and ``--ack-wal``
asks for the 202 at durability instead of blocking to the publish.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time
import urllib.error
import urllib.request


def request_with_retries(
    url: str,
    payload: dict | None = None,
    deadline_ms: int | None = None,
    max_retries: int = 4,
    timeout_s: float = 30.0,
    sleep=time.sleep,
    rng: random.Random | None = None,
    headers: dict | None = None,
) -> dict:
    """One HTTP exchange (POST ``payload``, or GET when ``payload`` is
    None) with bounded client-side resilience.

    Retries 503s (admission sheds, fleet unavailable) and transport
    failures up to ``max_retries`` extra attempts. The delay before
    attempt ``n`` is the decorrelated-jitter backoff
    (:func:`~graphmine_tpu_torch.pipeline.resilience.backoff_s`, seeded
    per process so a fleet of clients never retries in lockstep), floored
    by the server's ``Retry-After`` hint when one came back.
    ``deadline_ms`` bounds the whole exchange and rides every attempt as
    ``X-Deadline-Ms``: the server sheds a batch still queued past the
    budget, and the client stops retrying when the budget is gone.

    ``headers`` ride every attempt verbatim: ``cmd_delta`` passes one
    ``X-Delta-Id`` generated once per logical request, so a retry after a
    lost acknowledgement dedupes in the server's log instead of applying
    twice.

    Returns ``{"status", "body", "headers", "attempts"}``; transport
    failures with no retries left return ``status: 0`` with the error
    under ``body["error"]``.
    """
    from graphmine_tpu_torch.pipeline.resilience import ResilienceConfig, backoff_s

    policy = ResilienceConfig(backoff_base_s=0.2, backoff_max_s=5.0)
    rng = rng if rng is not None else random.Random(
        f"serve_cli:{os.getpid()}"
    )
    deadline = (
        time.monotonic() + deadline_ms / 1000.0
        if deadline_ms is not None else None
    )
    attempt = 0
    last: dict = {}
    base_headers = dict(headers or {})
    while True:
        attempt += 1
        headers = {"Content-Type": "application/json", **base_headers}
        attempt_timeout = timeout_s
        if deadline is not None:
            remaining_ms = int((deadline - time.monotonic()) * 1000)
            if remaining_ms <= 0 and attempt > 1:
                return last
            remaining_ms = max(1, remaining_ms)
            headers["X-Deadline-Ms"] = str(remaining_ms)
            attempt_timeout = min(timeout_s, remaining_ms / 1000.0)
        req = urllib.request.Request(
            url,
            data=None if payload is None else json.dumps(payload).encode(),
            headers=headers,
        )
        resp_headers: dict = {}
        try:
            with urllib.request.urlopen(req, timeout=attempt_timeout) as r:
                status, raw, resp_headers = r.status, r.read(), dict(r.headers)
        except urllib.error.HTTPError as e:
            status, raw, resp_headers = e.code, e.read(), dict(e.headers)
        except Exception as e:  # noqa: BLE001 — transport weather: retryable
            status, raw = 0, json.dumps({"error": repr(e)}).encode()
        try:
            body = json.loads(raw.decode()) if raw else {}
        except ValueError:
            body = {"error": raw.decode(errors="replace")}
        last = {
            "status": status, "body": body, "headers": resp_headers,
            "attempts": attempt,
        }
        if status not in (0, 503) or attempt > max_retries:
            return last
        delay = backoff_s(policy, attempt, rng)
        retry_after = resp_headers.get("Retry-After", "")
        if retry_after:
            try:
                delay = max(delay, float(retry_after))
            except ValueError:
                pass
        if deadline is not None:
            budget = deadline - time.monotonic()
            if budget <= 0:
                return last
            delay = min(delay, budget)
        sleep(delay)


def _sink(args):
    from graphmine_tpu_torch.obs.spans import Tracer
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink, shard_sink

    obs_dir = getattr(args, "obs_dir", None)
    if obs_dir:
        # this process's records land in its own shard under --obs-dir
        role = getattr(args, "cmd", None) or "serve"
        if role == "serve" and getattr(args, "standby_of", None):
            role = "standby"
        return shard_sink(obs_dir, role)
    return MetricsSink(
        stream_path=getattr(args, "metrics_out", None), tracer=Tracer()
    )


def _store(args):
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    store = SnapshotStore(args.store)
    tenant = getattr(args, "tenant", None)
    if tenant:
        # local mode scopes to the tenant's namespace directly; HTTP
        # mode sends X-Tenant-Id instead (the server does the remap)
        store = store.for_tenant(tenant)
    return store


def cmd_info(args) -> int:
    store = _store(args)
    snap = store.load()
    if snap is None:
        print(f"serve_cli: store at {args.store!r} is empty", file=sys.stderr)
        return 2
    out = {
        **snap.meta,
        "arrays": {k: list(v.shape) for k, v in snap.arrays.items()},
    }
    # Sharded write plane: when the store carries an epochs/ directory,
    # report the committed epoch, its version vector and the range table
    # from the durable publish_epoch record.
    shards = _shardplane_info(store, snap)
    if shards is not None:
        out["shardplane"] = shards
    print(json.dumps(out, indent=1, default=str))
    return 0


def _shardplane_info(store, snap):
    """The store's committed-epoch view, read straight off disk through
    the coordinator (no server needed). None when the store has never
    run under writer_shards > 1."""
    from graphmine_tpu_torch.serve.shardplane import (
        SHARDS_DIRNAME,
        EpochCoordinator,
        ShardPlan,
    )
    from graphmine_tpu_torch.serve.snapshot import EPOCHS_DIRNAME
    from graphmine_tpu_torch.serve.wal import WriteAheadLog

    if not os.path.isdir(os.path.join(store.root, EPOCHS_DIRNAME)):
        return None
    coord = EpochCoordinator(
        store, ShardPlan.build(1, int(len(snap["labels"])))
    )
    epoch = coord.committed_epoch()
    rec = coord._read_record(coord._record_path(epoch)) if epoch else None
    out = {
        "committed_epoch": epoch,
        "version_vector": {
            str(k): v for k, v in coord.version_vector(epoch).items()
        },
        "ranges": (rec or {}).get("ranges", []),
        "num_shards": (rec or {}).get("num_shards"),
    }
    # per-shard log lag: each range's log opened read-only, its last vs
    # applied seq (the "which range is behind" column)
    wals = {}
    base = os.path.join(store.root, SHARDS_DIRNAME)
    if os.path.isdir(base):
        for name in sorted(os.listdir(base)):
            wal_dir = os.path.join(base, name, "wal")
            if not os.path.isdir(wal_dir):
                continue
            try:
                wal = WriteAheadLog(wal_dir, read_only=True)
                s = wal.snapshot()
                wals[name] = {
                    "last_seq": s.get("last_seq"),
                    "applied_seq": s.get("applied_seq"),
                    "pending_entries": s.get("pending_entries"),
                }
                wal.close()
            except (OSError, ValueError):
                wals[name] = {"error": "unreadable"}
    if wals:
        out["shard_wals"] = wals
    return out


def cmd_query(args) -> int:
    if args.url:
        base = args.url.rstrip("/")
        kw = {
            "deadline_ms": args.deadline_ms,
            "max_retries": args.max_retries,
        }
        if args.tenant:
            kw["headers"] = {"X-Tenant-Id": args.tenant}
        merged: dict = {}
        calls = []
        if args.vertex:
            calls.append(
                (f"{base}/query", {"vertices": list(args.vertex)}, None)
            )
        if args.neighbors is not None:
            calls.append((f"{base}/neighbors?v={args.neighbors}", None, None))
        if args.explain is not None:
            # nested under "explain" (the local-mode shape): /explain's
            # body shares keys with the other calls
            calls.append(
                (f"{base}/explain?vertex={args.explain}", None, "explain")
            )
        if args.community is not None:
            calls.append((
                f"{base}/topk?community={args.community}&k={args.topk}",
                None, None,
            ))
        if not calls:  # bare `query --url`: still resolve something
            calls.append((f"{base}/query", {"vertices": []}, None))
        worst, attempts = 200, 0
        for call_url, payload, nest in calls:
            out = request_with_retries(call_url, payload, **kw)
            attempts += out["attempts"]
            if out["status"] != 200:
                worst = out["status"]
            if nest is not None:
                merged[nest] = out["body"]
            else:
                merged.update(out["body"])
        print(json.dumps({
            "status": worst, "attempts": attempts, **merged,
        }))
        return 0 if worst == 200 else 1

    from graphmine_tpu_torch.serve.query import QueryEngine
    from graphmine_tpu_torch.serve.server import _jsonable

    sink = _sink(args)
    snap = _store(args).load(sink=sink)
    if snap is None:
        print(f"serve_cli: store at {args.store!r} is empty", file=sys.stderr)
        return 2
    eng = QueryEngine(snap, device=args.device)
    out: dict = {"version": eng.version}
    t0 = time.perf_counter()
    if args.vertex:
        batch = eng.query_batch(args.vertex)
        sink.emit(
            "query_batch", endpoint="cli", n=len(args.vertex),
            seconds=round(time.perf_counter() - t0, 6),
        )
        out["rows"] = batch
    if args.neighbors is not None:
        out["neighbors"] = eng.neighbors(args.neighbors)
    if args.explain is not None:
        out["explain"] = eng.explain(args.explain)
    if args.community is not None:
        out["top"] = [
            {"vertex": v, "lof": s}
            for v, s in eng.top_outliers(args.community, args.topk)
        ]
    print(json.dumps(_jsonable(out)))
    if sink.stream_path:
        sink.finalize(sink.stream_path)
    return 0


def cmd_delta(args) -> int:
    def pairs(values):
        # SRC,DST or (weighted snapshots) SRC,DST,WEIGHT
        out = []
        for v in values or ():
            parts = v.split(",")
            if len(parts) == 3:
                out.append((int(parts[0]), int(parts[1]), float(parts[2])))
            else:
                out.append(tuple(int(x) for x in parts))
        return out

    if args.file:
        with open(args.file) as f:
            payload = json.load(f)
    else:
        payload = {
            "insert": [list(p) for p in pairs(args.insert)],
            "delete": [list(p) for p in pairs(args.delete)],
        }
    if args.url:
        # ONE idempotency key per logical request, riding every retry: a
        # resend after a lost acknowledgement dedupes in the server's log
        # instead of applying twice (a log-less server ignores it).
        delta_id = args.delta_id or f"cli-{os.getpid()}-{os.urandom(6).hex()}"
        headers = {"X-Delta-Id": delta_id}
        if args.tenant:
            # the dedupe key is (tenant, delta_id) server-side
            headers["X-Tenant-Id"] = args.tenant
        if args.ack_wal:
            headers["X-Delta-Ack"] = "wal"
        out = request_with_retries(
            f"{args.url.rstrip('/')}/delta", payload,
            deadline_ms=args.deadline_ms,
            max_retries=args.max_retries,
            headers=headers,
        )
        print(json.dumps({
            "status": out["status"], "attempts": out["attempts"],
            "delta_id": delta_id,
            **out["body"],
        }))
        return 0 if out["status"] in (200, 202) else 1
    # in-process path: the ingest machinery (and the device) loads only
    # here; --url mode stays HTTP and the host-side retry policy
    from graphmine_tpu_torch.serve.delta import DeltaIngestor, EdgeDelta

    delta = EdgeDelta.from_pairs(
        insert=payload.get("insert", ()), delete=payload.get("delete", ())
    )
    sink = _sink(args)
    ing = DeltaIngestor(
        _store(args), sink=sink, num_shards=args.num_shards,
        device=args.device,
    )
    snap = ing.apply(delta)
    last = [r for r in sink.records if r.get("phase") == "delta_apply"][-1]
    print(json.dumps({
        "version": snap.version,
        "snapshot_id": snap.snapshot_id,
        "method": last["method"],
        "inserts": last["inserts"],
        "deletes": last["deletes"],
        "quarantine": last["quarantine"],
        "seconds": last["seconds"],
    }))
    if sink.stream_path:
        sink.finalize(sink.stream_path)
    return 0


def cmd_serve(args) -> int:
    from graphmine_tpu_torch.serve.server import SnapshotServer

    sink = _sink(args)
    # A serving process emits one access_log record per request forever;
    # cap the in-memory copy (the JSONL stream keeps everything on disk).
    sink.max_records = 100_000
    server = SnapshotServer(
        _store(args), host=args.host, port=args.port, sink=sink,
        prom_out=args.prom_out, num_shards=args.num_shards,
        slow_request_s=args.slow_request_s,
        wal=args.wal, standby_of=args.standby_of,
        primary_wal=args.primary_wal,
        profilez_dir=args.profilez_dir, device=args.device,
    )
    host, port = server.start()
    role = (
        f"standby of {args.standby_of}" if args.standby_of
        else ("writer (WAL-durable)" if args.wal else "writer")
    )
    print(
        f"serving snapshot v{server.engine.version} on http://{host}:{port} "
        f"[{role}, epoch {server.writer_epoch}, device {server.device}]",
        file=sys.stderr, flush=True,
    )
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
        if sink.stream_path:
            sink.finalize(sink.stream_path)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, store_required=True):
        p.add_argument("--store", required=store_required, default=None,
                       help="snapshot store directory")
        p.add_argument("--metrics-out", default=None,
                       help="append serving records to this JSONL")
        p.add_argument("--obs-dir", default=None,
                       help="stream this process's records to its own "
                            "shard (<role>-<pid>.jsonl) under this "
                            "directory (overrides --metrics-out)")

    def device(p):
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu")

    def client(p):
        p.add_argument("--url", default=None,
                       help="HTTP mode: talk to a running server/fleet "
                            "router at this base URL instead of --store")
        p.add_argument("--deadline-ms", type=int, default=None,
                       help="total budget for the exchange; also sent as "
                            "X-Deadline-Ms so the server sheds work the "
                            "client stopped waiting for")
        p.add_argument("--max-retries", type=int, default=4,
                       help="extra attempts on 503/transport failure "
                            "(decorrelated-jitter backoff, honouring the "
                            "server's Retry-After)")
        p.add_argument("--tenant", default=None,
                       help="tenant namespace: HTTP mode sends it as "
                            "X-Tenant-Id on every attempt; local mode "
                            "scopes --store to tenants/<id>/")

    p = sub.add_parser("info", help="print the current snapshot manifest")
    common(p)
    p.add_argument("--tenant", default=None,
                   help="read the manifest of this tenant's namespace "
                        "(tenants/<id>/ under --store)")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("query", help="one-shot queries against the store")
    common(p, store_required=False)
    client(p)
    device(p)
    p.add_argument("--vertex", type=int, nargs="*", default=[],
                   help="vertex ids to resolve (batched gather)")
    p.add_argument("--neighbors", type=int, default=None,
                   help="list this vertex's neighbours")
    p.add_argument("--explain", type=int, default=None,
                   help="per-vertex outlier explanation")
    p.add_argument("--community", type=int, default=None,
                   help="top-k outliers of this community")
    p.add_argument("--topk", type=int, default=10)
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser("delta", help="apply one insert/delete batch")
    common(p, store_required=False)
    client(p)
    device(p)
    p.add_argument("--insert", action="append", metavar="SRC,DST[,W]",
                   help="edge to insert (repeatable; the third field is "
                        "the edge weight for weighted snapshots)")
    p.add_argument("--delete", action="append", metavar="SRC,DST",
                   help="edge to delete (repeatable)")
    p.add_argument("--file", default=None,
                   help='JSON file {"insert": [[s,d],...], "delete": [...]}')
    p.add_argument("--num-shards", type=int, default=1,
                   help="repair deltas on a mesh of this many shards (one device "
                        "holds several only with GRAPHMINE_VIRTUAL_DEVICES)")
    p.add_argument("--delta-id", default=None,
                   help="idempotency key (X-Delta-Id) for --url mode; "
                        "default: one generated key reused across retries")
    p.add_argument("--ack-wal", action="store_true",
                   help="--url mode: ask for the 202 at durability "
                        "instead of blocking to publish (X-Delta-Ack: "
                        "wal; needs a server with --wal)")
    p.set_defaults(fn=cmd_delta)

    p = sub.add_parser(
        "serve", help="run the HTTP snapshot server",
        description="Run the HTTP snapshot server. Write-path admission "
        "bounds come from the GRAPHMINE_ADMIT_* environment: "
        "MAX_PENDING_ROWS, MAX_LAG_S, MAX_QUEUE_DEPTH, DEFER_FRAC, "
        "DEADLINE_S, RETRY_AFTER_S.",
    )
    common(p)
    device(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080, help="0 = any free port")
    p.add_argument("--prom-out", default=None,
                   help="Prometheus textfile, rewritten on every publish")
    p.add_argument("--num-shards", type=int, default=1,
                   help="repair deltas on a mesh of this many shards (one device "
                        "holds several only with GRAPHMINE_VIRTUAL_DEVICES)")
    p.add_argument("--slow-request-s", type=float, default=1.0,
                   help="access_log records at or past this carry the body digest")
    p.add_argument("--wal", default=None, metavar="DIR",
                   help="write-ahead delta log directory: accepted batches "
                        "fsync here before acknowledgement, replay on "
                        "restart, and GET /wal serves the log-shipping feed")
    p.add_argument("--standby-of", default=None, metavar="URL",
                   help="run as the log-shipped standby of the writer at "
                        "URL: refuse client writes, tail its /wal into "
                        "--wal, and take over on POST /promote")
    p.add_argument("--primary-wal", default=None, metavar="DIR",
                   help="the primary's log directory (shared storage): "
                        "promotion copies the un-shipped tail from it")
    p.add_argument("--profilez-dir", default=None,
                   help="enable POST /profilez captures into this directory")
    p.set_defaults(fn=cmd_serve)

    args = ap.parse_args(argv)
    if getattr(args, "url", None) is None and args.store is None:
        ap.error(f"{args.cmd}: one of --store or --url is required")
    if getattr(args, "url", None) is not None and args.metrics_out:
        print(
            "serve_cli: --metrics-out is ignored with --url (records are "
            "written by the server's own --metrics-out)", file=sys.stderr,
        )
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
