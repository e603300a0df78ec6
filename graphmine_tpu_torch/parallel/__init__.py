"""The multi-device layer, inside one process: the mesh and its
collectives, the replicated and ring supersteps, and the ring-sharded
kNN/LOF, under the JAX package's names (``graphmine_tpu/parallel``). The
source-sharded PPR (``sharded_personalized_pagerank``) raises: it waits
for ROADMAP item A7b."""

from graphmine_tpu_torch.parallel.knn import sharded_knn, sharded_lof
from graphmine_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
    make_multislice_mesh,
)
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



def sharded_personalized_pagerank(*args, **kwargs):
    """The JAX package's source-sharded PPR (``graphmine_tpu/parallel/ppr.py``):
    not ported, it waits for ROADMAP item A7b."""
    raise NotImplementedError(
        "sharded_personalized_pagerank (the source-sharded PPR) is not ported; "
        "it waits for ROADMAP item A7b"
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
