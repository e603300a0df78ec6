"""graphmine_tpu_torch — the PyTorch/CUDA port of graphmine_tpu.

A package beside the JAX package (which stays the reference), with the
same module layout and names: ``io``, ``datasets``, ``graph``, ``ops``,
``pipeline``, ``obs``, ``serve``, ``frames``, ``table``, ``compat`` (the
pyspark shim) and ``oracle``. It imports PyTorch, NumPy, SciPy and
pyarrow, never JAX and never ``graphmine_tpu``. Every entry point runs on
CUDA unless the caller passes another ``device`` (the CPU parity tests
pass ``device="cpu"``). The exact kNN of the LOF scorer runs a
hand-written CUDA kernel (``csrc/knn_topk.cu``) on CUDA tensors.

The graph operations (the blocked superstep family among them), the
``GraphFrame`` front end and the relational ``Table`` are exported here under the JAX package's names, lazily (PEP
562): ``graphmine_tpu_torch.louvain`` imports its module on first access.
The multi-device layer (the mesh, the replicated and ring supersteps, the
sharded kNN/LOF) is :mod:`graphmine_tpu_torch.parallel`, as in the JAX
package.
"""

from graphmine_tpu_torch.device import resolve_device

# export name -> (defining module, attribute); find_motifs aliases
# ops.motifs.find, as in the JAX package
_EXPORTS = {
    "Graph": ("graphmine_tpu_torch.graph.container", "Graph"),
    "build_graph": ("graphmine_tpu_torch.graph.container", "build_graph"),
    "label_propagation": ("graphmine_tpu_torch.ops.lpa", "label_propagation"),
    "connected_components": ("graphmine_tpu_torch.ops.cc", "connected_components"),
    "leiden": ("graphmine_tpu_torch.ops.louvain", "leiden"),
    "louvain": ("graphmine_tpu_torch.ops.louvain", "louvain"),
    "modularity": ("graphmine_tpu_torch.ops.modularity", "modularity"),
    "degrees": ("graphmine_tpu_torch.ops.degrees", "degrees"),
    "in_degrees": ("graphmine_tpu_torch.ops.degrees", "in_degrees"),
    "out_degrees": ("graphmine_tpu_torch.ops.degrees", "out_degrees"),
    "out_weights": ("graphmine_tpu_torch.ops.degrees", "out_weights"),
    "bfs": ("graphmine_tpu_torch.ops.paths", "bfs"),
    "bfs_distances": ("graphmine_tpu_torch.ops.paths", "bfs_distances"),
    "bfs_parents": ("graphmine_tpu_torch.ops.paths", "bfs_parents"),
    "shortest_paths": ("graphmine_tpu_torch.ops.paths", "shortest_paths"),
    "weighted_shortest_paths": ("graphmine_tpu_torch.ops.paths", "weighted_shortest_paths"),
    "adjusted_rand_index": ("graphmine_tpu_torch.ops.cluster_metrics", "adjusted_rand_index"),
    "normalized_mutual_info": ("graphmine_tpu_torch.ops.cluster_metrics",
                               "normalized_mutual_info"),
    "strongly_connected_components": ("graphmine_tpu_torch.ops.scc",
                                      "strongly_connected_components"),
    "aggregate_messages": ("graphmine_tpu_torch.ops.aggregate", "aggregate_messages"),
    "pregel": ("graphmine_tpu_torch.ops.aggregate", "pregel"),
    "find_motifs": ("graphmine_tpu_torch.ops.motifs", "find"),
    "core_numbers": ("graphmine_tpu_torch.ops.kcore", "core_numbers"),
    "degree_assortativity": ("graphmine_tpu_torch.ops.stats", "degree_assortativity"),
    "density": ("graphmine_tpu_torch.ops.stats", "density"),
    "diameter": ("graphmine_tpu_torch.ops.stats", "diameter"),
    "reciprocity": ("graphmine_tpu_torch.ops.stats", "reciprocity"),
    "GraphFrame": ("graphmine_tpu_torch.frames", "GraphFrame"),
    "Table": ("graphmine_tpu_torch.table", "Table"),
    "read_parquet": ("graphmine_tpu_torch.table", "read_parquet"),
    "pagerank": ("graphmine_tpu_torch.ops.pagerank", "pagerank"),
    "parallel_personalized_pagerank": ("graphmine_tpu_torch.ops.pagerank",
                                       "parallel_personalized_pagerank"),
    "hits": ("graphmine_tpu_torch.ops.centrality", "hits"),
    "eigenvector_centrality": ("graphmine_tpu_torch.ops.centrality", "eigenvector_centrality"),
    "katz_centrality": ("graphmine_tpu_torch.ops.centrality", "katz_centrality"),
    "closeness_centrality": ("graphmine_tpu_torch.ops.centrality", "closeness_centrality"),
    "betweenness_centrality": ("graphmine_tpu_torch.ops.centrality", "betweenness_centrality"),
    "maximal_independent_set": ("graphmine_tpu_torch.ops.mis", "maximal_independent_set"),
    "greedy_color": ("graphmine_tpu_torch.ops.mis", "greedy_color"),
    "k_truss": ("graphmine_tpu_torch.ops.ktruss", "k_truss"),
    "link_prediction": ("graphmine_tpu_torch.ops.linkpred", "link_prediction"),
    "spectral_embedding": ("graphmine_tpu_torch.ops.embedding", "spectral_embedding"),
    "svd_plus_plus": ("graphmine_tpu_torch.ops.svdpp", "svd_plus_plus"),
    "svdpp_predict": ("graphmine_tpu_torch.ops.svdpp", "svdpp_predict"),
    "graphx_label_propagation": ("graphmine_tpu_torch.oracle", "graphx_label_propagation"),
    "BlockedPlan": ("graphmine_tpu_torch.ops.blocking", "BlockedPlan"),
    "blocked_inflow": ("graphmine_tpu_torch.ops.blocking", "blocked_inflow"),
    "build_graph_and_blocked_plan": ("graphmine_tpu_torch.ops.blocking",
                                     "build_graph_and_blocked_plan"),
    "cc_superstep_blocked": ("graphmine_tpu_torch.ops.blocking", "cc_superstep_blocked"),
    "lpa_superstep_blocked": ("graphmine_tpu_torch.ops.blocking", "lpa_superstep_blocked"),
    "select_superstep_family": ("graphmine_tpu_torch.ops.blocking", "select_superstep_family"),
    "recursive_lpa_outliers_sharded": ("graphmine_tpu_torch.ops.outliers",
                                       "recursive_lpa_outliers_sharded"),
    "sharded_superstep_cost": ("graphmine_tpu_torch.obs.costmodel", "sharded_superstep_cost"),
    "sharded_superstep_footprint": ("graphmine_tpu_torch.obs.memmodel",
                                    "sharded_superstep_footprint"),
}

__all__ = ["resolve_device", *sorted(_EXPORTS)]


def __getattr__(name: str):
    """Import the defining module on first access and cache the
    attribute on the package."""
    try:
        module_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module_name), attr)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
