"""The multi-device layer: the mesh (in one process, or across the
processes of a ``torch.distributed`` world after
:func:`initialize_distributed`) and its collectives, the replicated,
blocked, 2-D and ring supersteps, the ring-sharded kNN/LOF and the
source-sharded PPR, under the JAX package's names
(``graphmine_tpu/parallel``)."""

from graphmine_tpu_torch.parallel.knn import sharded_knn, sharded_lof
from graphmine_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    make_multislice_mesh,
)
from graphmine_tpu_torch.parallel.ppr import sharded_personalized_pagerank
from graphmine_tpu_torch.parallel.ring import (
    ring_connected_components,
    ring_label_propagation,
    ring_pagerank,
)
from graphmine_tpu_torch.parallel.sharded import (
    ShardedGraph,
    partition_graph,
    shard_graph_arrays,
    sharded_connected_components,
    sharded_label_propagation,
    sharded_lpa_fixpoint,
    sharded_pagerank,
)


__all__ = [
    "initialize_distributed",
    "make_mesh",
    "make_multislice_mesh",
    "ShardedGraph",
    "partition_graph",
    "shard_graph_arrays",
    "sharded_label_propagation",
    "sharded_lpa_fixpoint",
    "sharded_connected_components",
    "sharded_pagerank",
    "ring_label_propagation",
    "ring_connected_components",
    "ring_pagerank",
    "sharded_knn",
    "sharded_lof",
    "sharded_personalized_pagerank",
]
