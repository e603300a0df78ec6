"""Serve CLI: ``python -m graphmine_tpu_torch.serve serve --store S``.

Counterpart of ``tools/serve_cli.py serve``: starts a
:class:`~graphmine_tpu_torch.serve.server.SnapshotServer` over a snapshot
store (a port or JAX publish) on ``--device`` (CUDA unless ``--device
cpu``) and serves until interrupted. The JAX package's ``serve_cli.py
query|delta --url`` clients speak HTTP and work against it unchanged.
``--wal``, ``--standby-of``, ``--primary-wal`` and ``--writer-shards``
are not taken: the durable write path, standbys and the sharded write
plane are ROADMAP item A4's later batch.
"""

from __future__ import annotations

import argparse
import sys
import time


def _sink(args):
    from graphmine_tpu_torch.obs.spans import Tracer
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink, shard_sink

    if args.obs_dir:
        return shard_sink(args.obs_dir, "serve")
    return MetricsSink(stream_path=args.metrics_out, tracer=Tracer())


def cmd_serve(args) -> int:
    from graphmine_tpu_torch.serve.server import SnapshotServer
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    sink = _sink(args)
    # A serving process emits one access_log record per request forever;
    # cap the in-memory copy (the JSONL stream keeps everything on disk).
    sink.max_records = 100_000
    server = SnapshotServer(
        SnapshotStore(args.store), host=args.host, port=args.port, sink=sink,
        prom_out=args.prom_out, slow_request_s=args.slow_request_s,
        profilez_dir=args.profilez_dir, device=args.device,
    )
    host, port = server.start()
    print(
        f"serving snapshot v{server.engine.version} on http://{host}:{port} "
        f"[writer, epoch {server.writer_epoch}, device {server.device}]",
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
    p = sub.add_parser("serve", help="run the HTTP snapshot server")
    p.add_argument("--store", required=True, help="snapshot store directory")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080, help="0 = any free port")
    p.add_argument("--prom-out", default=None,
                   help="Prometheus textfile, rewritten on every publish")
    p.add_argument("--slow-request-s", type=float, default=1.0,
                   help="access_log records at or past this carry the body digest")
    p.add_argument("--profilez-dir", default=None,
                   help="enable POST /profilez captures into this directory")
    p.add_argument("--metrics-out", default=None,
                   help="append serving records to this JSONL")
    p.add_argument("--obs-dir", default=None,
                   help="stream records to <obs-dir>/serve-<pid>.jsonl "
                        "(overrides --metrics-out)")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.set_defaults(func=cmd_serve)
    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
