"""graphmine_tpu_torch — the PyTorch/CUDA port of graphmine_tpu.

A package beside the JAX package (which stays the reference), with the
same module layout and names: ``io``, ``datasets``, ``graph``, ``ops``,
``pipeline``, ``obs``, ``serve``. It imports PyTorch, NumPy, SciPy and
pyarrow, never JAX and never ``graphmine_tpu``. Every entry point runs on
CUDA unless the caller passes another ``device`` (the CPU parity tests
pass ``device="cpu"``). The exact kNN of the LOF scorer runs a
hand-written CUDA kernel (``csrc/knn_topk.cu``) on CUDA tensors.

The graph operations are exported here under the JAX package's names,
lazily (PEP 562): ``graphmine_tpu_torch.louvain`` imports its module on
first access.
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
