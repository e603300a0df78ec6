"""End-to-end single-device pipeline: load → build → LPA → census →
recursive-LPA outliers → features → kNN/LOF, then, with ``snapshot_out``,
connected components and the snapshot publish.

Counterpart of ``graphmine_tpu/pipeline/driver.py::run_pipeline`` on one
device, with the same phases in the same order and the same record names.
The resilience ladders, checkpointing, the multi-device planner and
Louvain wait for later slices (ROADMAP.md queue 1).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.io.edges import EdgeTable, load_edge_list, load_parquet_edges
from graphmine_tpu_torch.pipeline import resilience
from graphmine_tpu_torch.pipeline.config import PipelineConfig
from graphmine_tpu_torch.pipeline.metrics import MetricsSink


@dataclass
class PipelineResult:
    edge_table: EdgeTable
    graph: Graph
    labels: np.ndarray                 # community label per vertex
    num_communities: int
    community_table: tuple             # (labels present, sizes, intra-edge counts)
    outliers: object | None = None     # OutlierReport (recursive_lpa)
    lof: np.ndarray | None = None      # LOF score per vertex
    features: torch.Tensor | None = None  # standardized [V, 8] LOF input
    feature_mode: str | None = None    # "exact" or "sampled" clustering column
    metrics: MetricsSink = field(default_factory=MetricsSink)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_pipeline(config: PipelineConfig) -> PipelineResult:
    config.validate()
    device = resolve_device(config.device)
    m = MetricsSink(stream_path=config.metrics_out)
    m.emit("run_start", data_path=config.data_path, device=str(device),
           max_iter=config.max_iter)
    try:
        result = _run_pipeline(config, m, device)
        if config.snapshot_out:
            _publish_snapshot(config, result, m, device)
    except BaseException as e:
        m.emit("run_end", ok=False, error_detail=repr(e))
        raise
    m.emit("run_end", ok=True)
    return result


def _run_pipeline(config: PipelineConfig, m: MetricsSink,
                  device: torch.device) -> PipelineResult:
    from graphmine_tpu_torch.ops.bucketed_mode import (
        build_graph_and_plan,
        lpa_superstep_bucketed,
    )
    from graphmine_tpu_torch.ops.census import census_table
    from graphmine_tpu_torch.ops.lpa import num_communities
    from graphmine_tpu_torch.ops.modularity import modularity

    # ---- load -----------------------------------------------------------
    with m.span("load"), m.timed("load", path=config.data_path, format=config.data_format):
        resilience.fault_point("load", path=config.data_path)
        if config.data_format == "parquet":
            table = load_parquet_edges(config.data_path, batch_rows=config.batch_rows)
        else:
            table = load_edge_list(config.data_path, weight_col=config.edge_weight_col,
                                   quarantine=config.quarantine_inputs)
    m.emit("counts", rows_raw=table.num_rows_raw, edges=table.num_edges,
           vertices=table.num_vertices)
    # gated on the flag: the parquet loader always counts its null filter
    if table.quarantine and config.quarantine_inputs:
        m.emit("quarantine", **table.quarantine)

    # ---- build: message CSR + degree-bucketed plan, one pass -----------
    with m.span("build_graph"), m.timed("build_graph"):
        graph, plan = build_graph_and_plan(
            table.src, table.dst, num_vertices=table.num_vertices,
            edge_weights=table.weights, device=device,
        )
        _sync(device)
    m.emit("impl_selected", op="lpa_superstep", impl="bucketed",
           n=graph.num_messages, reason="single-device fused plan",
           weighted=graph.msg_weight is not None)
    m.emit("plan_build", op="lpa_superstep", buckets=len(plan.vertex_ids),
           hub_vertices=0 if plan.hist_vertex_ids is None else len(plan.hist_vertex_ids),
           max_degree=int(graph.degrees().max()) if graph.num_vertices else 0)

    # ---- LPA ------------------------------------------------------------
    with m.span("lpa"), m.timed("lpa", max_iter=config.max_iter):
        labels = torch.arange(graph.num_vertices, dtype=torch.int32, device=device)
        for it in range(config.max_iter):
            t0 = time.perf_counter()
            new = lpa_superstep_bucketed(labels, graph, plan)
            changed = int((new != labels).sum())  # syncs the superstep
            dt = time.perf_counter() - t0
            labels = new
            m.emit("lpa_iter", iteration=it + 1, labels_changed=changed,
                   seconds=round(dt, 5),
                   edges_per_sec=round(graph.num_edges / dt) if dt > 0 else None)
    del plan

    # ---- census ---------------------------------------------------------
    with m.span("census"), m.timed("census"):
        n_comm = num_communities(labels)
        present, sizes, edge_counts = census_table(labels, graph)
        q = modularity(labels, graph)
    m.emit("communities", count=n_comm, largest=int(sizes.max(initial=0)),
           modularity=round(q, 6))

    result = PipelineResult(
        edge_table=table, graph=graph, labels=labels.cpu().numpy(),
        num_communities=n_comm, community_table=(present, sizes, edge_counts),
        metrics=m,
    )

    # ---- recursive-LPA outliers ----------------------------------------
    if config.outlier_method in ("recursive_lpa", "both"):
        from graphmine_tpu_torch.ops.outliers import recursive_lpa_outliers

        with m.span("outliers_recursive_lpa"), m.timed("outliers_recursive_lpa"):
            result.outliers = recursive_lpa_outliers(
                graph, labels, max_iter=config.sub_max_iter, decile=config.decile
            )
        m.emit("outlier_summary", method="recursive_lpa",
               flagged_vertices=int(result.outliers.outlier_vertices.sum()),
               sub_communities=len(result.outliers.sub_sizes))

    # ---- features + kNN/LOF (exact or IVF, by config.lof_impl) ---------
    if config.outlier_method in ("lof", "both"):
        from graphmine_tpu_torch.graph.container import simple_undirected_edges
        from graphmine_tpu_torch.ops.features import standardize, vertex_features
        from graphmine_tpu_torch.ops.lof import lof_scores
        from graphmine_tpu_torch.ops.triangles import oriented_wedge_count

        k = min(config.lof_k, graph.num_vertices - 1)
        # Wedge-budget guard: the exact clustering column materializes every
        # oriented wedge on the host; past the budget the sampled estimator
        # takes over. One dedup serves the probe and the column.
        with m.span("features"), m.timed("features"):
            simple_edges = simple_undirected_edges(graph)
            wedges = oriented_wedge_count(graph, simple_edges=simple_edges)
            result.feature_mode = "exact" if wedges <= config.wedge_budget else "sampled"
            m.emit("feature_mode", mode=result.feature_mode, wedges=wedges,
                   wedge_budget=config.wedge_budget)
            if result.feature_mode == "sampled":
                m.emit("warning", message=f"exact clustering infeasible: {wedges:,} "
                       f"oriented wedges exceed wedge_budget={config.wedge_budget:,}; "
                       "using the wedge-sampled estimator")
            feats = standardize(vertex_features(
                graph, labels,
                include_clustering=True if result.feature_mode == "exact" else "sampled",
                simple_edges=simple_edges,
            )).contiguous()
            _sync(device)
        result.features = feats
        with m.span("outliers_lof"), m.timed("outliers_lof", k=k,
                                              features=result.feature_mode):
            scores = lof_scores(feats, k=k, impl=config.lof_impl, sink=m)
            result.lof = scores.cpu().numpy()
        m.emit("outlier_summary", method="lof", max_score=float(result.lof.max()),
               over_1_5=int((result.lof > 1.5).sum()))
    return result


def _publish_snapshot(config: PipelineConfig, result: PipelineResult, m: MetricsSink,
                      device: torch.device) -> None:
    """Publish the run's outputs as one snapshot generation at
    ``config.snapshot_out``: the edges, labels, CC labels (computed here,
    the pipeline's only CC), census and LOF, and the weights of a weighted
    run. The quality pass re-scores the store's canary probe on ``device``
    (``GRAPHMINE_QUALITY=0`` turns it off, ``GRAPHMINE_CANARY_SEED`` seeds
    a new probe); its failures are warnings, never a failed publish."""
    import os

    from graphmine_tpu_torch.obs.quality import CanaryProbe, run_quality_pass
    from graphmine_tpu_torch.ops.cc import connected_components
    from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    table, graph = result.edge_table, result.graph
    with m.span("snapshot_publish"), m.timed("snapshot_publish", path=config.snapshot_out):
        resilience.fault_point("snapshot_publish")
        cc_t, iters = connected_components(graph, return_iterations=True, sink=m)
        cc = cc_t.cpu().numpy().astype(np.int32)
        cc_sizes = np.bincount(cc, minlength=1)
        m.emit("cc_summary", components=int((cc_sizes > 0).sum()),
               largest=int(cc_sizes.max()), iterations=iters)
        present, sizes, edge_counts = result.community_table
        arrays = {
            "src": np.asarray(table.src, np.int32),
            "dst": np.asarray(table.dst, np.int32),
            "labels": np.asarray(result.labels, np.int32),
            "cc_labels": cc,
            "census_present": np.asarray(present),
            "census_sizes": np.asarray(sizes),
            "census_edges": np.asarray(edge_counts),
        }
        if result.lof is not None:
            arrays["lof"] = np.asarray(result.lof, np.float32)
        if table.weights is not None:
            arrays["weights"] = np.asarray(table.weights, np.float32)
        store = SnapshotStore(config.snapshot_out)
        quality_on = os.environ.get("GRAPHMINE_QUALITY", "1") != "0"
        parent_arrays, parent_meta, canary = {}, {}, None
        if quality_on:
            try:
                peeked = store.peek_arrays(("labels", "lof", "canary_features",
                                            "canary_is_anomaly"))
                if peeked is not None:
                    parent_arrays, parent_meta = peeked
                canary = CanaryProbe.from_arrays(parent_arrays, parent_meta)
                if canary is None:
                    canary = CanaryProbe.generate(
                        seed=int(os.environ.get("GRAPHMINE_CANARY_SEED", "0")))
                arrays.update(canary.arrays())
            except Exception as e:  # noqa: BLE001 — telemetry only
                m.emit("warning", message=f"canary probe unavailable: {e!r}")
                canary = None
        snap = store.publish(
            arrays, fingerprint=graph_fingerprint(table.src, table.dst, table.weights),
            run_id="", mesh_shape=[1],
            extra_meta={"canary": canary.meta()} if canary is not None else None, sink=m,
        )
        if quality_on:
            try:
                run_quality_pass(
                    arrays["labels"], arrays.get("lof"), snap.version,
                    parent_labels=parent_arrays.get("labels"),
                    parent_lof=parent_arrays.get("lof"),
                    parent_version=parent_meta.get("version"),
                    canary=canary, sink=m, device=device,
                )
            except Exception as e:  # noqa: BLE001 — the publish has committed
                m.emit("warning", message=f"quality pass failed: {e!r}")
        _sync(device)


def main(argv=None) -> None:
    import logging

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    from graphmine_tpu_torch.pipeline.config import parse_args

    config = parse_args(argv)
    _show(run_pipeline(config), config.show)


def _show(result: PipelineResult, n: int) -> None:
    """Terminal summary."""
    present, sizes, edges = result.community_table
    order = np.argsort(sizes)[::-1][:n]
    print(f"\nVertices: {result.edge_table.num_vertices}  "
          f"Edges: {result.edge_table.num_edges}")
    print(f"There are {result.num_communities} Communities in the Dataset.")
    print(f"\nTop {len(order)} communities (label, vertices, intra-edges):")
    for i in order:
        name = result.edge_table.names[present[i]]
        print(f"  {present[i]:>8}  {sizes[i]:>8}  {edges[i]:>8}   ({name})")
    if result.outliers is not None:
        print(f"\nRecursive-LPA outliers: {int(result.outliers.outlier_vertices.sum())} "
              f"vertices in bottom-decile sub-communities")
    if result.lof is not None:
        top = np.argsort(result.lof)[::-1][:n]
        print(f"\nTop {len(top)} LOF outliers (vertex, score, name):")
        for v in top:
            print(f"  {v:>8}  {result.lof[v]:>7.3f}   ({result.edge_table.names[v]})")
