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
- :mod:`~graphmine_tpu_torch.serve.server`: the stdlib HTTP front end,
  double-buffered, with ``python -m graphmine_tpu_torch.serve serve``.

The JAX package's ``fleet``, ``wal`` and ``shardplane`` modules are
ROADMAP item A4's later batch.
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
from graphmine_tpu_torch.serve.query import QueryEngine
from graphmine_tpu_torch.serve.snapshot import (
    PublishFencedError,
    Snapshot,
    SnapshotStore,
)

__all__ = [
    "AdmissionBounds",
    "AdmissionController",
    "AdmissionDecision",
    "DeltaIngestor",
    "EdgeDelta",
    "PublishFencedError",
    "QueryEngine",
    "RepairDebt",
    "RepairResult",
    "Snapshot",
    "SnapshotStore",
    "coalesce_deltas",
]
