"""Serving plane of the PyTorch port.

Counterpart of ``graphmine_tpu/serve`` on one device:

- :mod:`~graphmine_tpu_torch.serve.snapshot`: versioned, atomically
  published result snapshots in the JAX package's store format;
- :mod:`~graphmine_tpu_torch.serve.delta`: edge insert/delete batches
  spliced into the graph with warm-start repair on the card, guarded by a
  sampled exact check with a cold-recompute fallback;
- :mod:`~graphmine_tpu_torch.serve.query`: O(1)/O(log n) lookups over a
  loaded snapshot, with a batched one-gather path on the card;
- :mod:`~graphmine_tpu_torch.serve.admission`: write-path overload
  protection (accept/queue/coalesce/shed, LOF defer);
- :mod:`~graphmine_tpu_torch.serve.tenancy`: tenant ids and the registry;
- :mod:`~graphmine_tpu_torch.serve.wal`: the durable write-ahead delta log
  and log shipping (host code; the JAX package's directory format);
- :mod:`~graphmine_tpu_torch.serve.shardplane`: the vertex-range sharded
  write plane and its two-phase epoch commit;
- :mod:`~graphmine_tpu_torch.serve.server`: the stdlib HTTP front end,
  double-buffered, with the durable write path, standby and promote;
- :mod:`~graphmine_tpu_torch.serve.fleet`: the router over replica
  processes (consistent-version reads, breakers, failover, rolling
  reload), which never touches a device.

CLIs: ``python -m graphmine_tpu_torch.serve serve|info|query|delta`` and
``python -m graphmine_tpu_torch.serve.fleet_cli up|status|roll|promote``.
"""

from graphmine_tpu_torch.serve.admission import (
    AdmissionBounds,
    AdmissionController,
    AdmissionDecision,
    coalesce_deltas,
)
from graphmine_tpu_torch.serve.delta import (
    DeltaIngestor,
    EdgeDelta,
    RepairDebt,
    RepairResult,
)
from graphmine_tpu_torch.serve.fleet import (
    CircuitBreaker,
    FleetConfig,
    FleetRouter,
    ReplicaSet,
    ReplicaSpec,
)
from graphmine_tpu_torch.serve.query import QueryEngine
from graphmine_tpu_torch.serve.snapshot import (
    PublishFencedError,
    Snapshot,
    SnapshotStore,
)
from graphmine_tpu_torch.serve.wal import LogShipper, WriteAheadLog

__all__ = [
    "AdmissionBounds",
    "AdmissionController",
    "AdmissionDecision",
    "CircuitBreaker",
    "DeltaIngestor",
    "EdgeDelta",
    "FleetConfig",
    "FleetRouter",
    "LogShipper",
    "PublishFencedError",
    "QueryEngine",
    "ReplicaSet",
    "ReplicaSpec",
    "RepairDebt",
    "RepairResult",
    "Snapshot",
    "SnapshotStore",
    "WriteAheadLog",
    "coalesce_deltas",
]
