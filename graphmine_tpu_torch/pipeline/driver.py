"""End-to-end pipeline: load → build → LPA → census → recursive-LPA
outliers → features → kNN/LOF, then, with ``snapshot_out``, connected
components and the snapshot publish.

Counterpart of ``graphmine_tpu/pipeline/driver.py::run_pipeline``, with the
same phases, records and run harness:

- every phase runs under :func:`~graphmine_tpu_torch.pipeline.resilience.run_phase`
  (transient errors retried, memory errors walked down a degradation
  ladder: the blocked LPA superstep to ``single_bucketed`` and then
  ``single_sort``, the bucketed one to ``single_sort``, the LOF kNN to
  the opposite family, IVF to the exact ``knn_topk`` kernel or back);
- the planner checks the LPA operating point against the card's memory
  before anything is allocated, resolves its superstep family (the
  bucketed plan, or the blocked one past the card's crossover or when
  ``GRAPHMINE_SUPERSTEP_FAMILY`` asks for it), built in the graph's CSR
  pass, and pre-degrades a family its model already knows cannot fit;
- LPA writes label checkpoints (every ``checkpoint_every`` supersteps and
  always the last) that ``resume`` continues from, bounds each superstep
  with the watchdog, checks the labels with the divergence tripwires and
  rolls back to the last checkpoint when one trips;
- every record carries the tracer's run, trace and span identity; a
  heartbeat thread, a Prometheus textfile, ``superstep_timing`` and
  ``memory_watermark`` records and a ``torch.profiler`` trace of the LPA
  phase make the run observable.

``community_method="louvain"`` or ``"leiden"`` runs that algorithm in
LPA's place, as the JAX driver does: no LPA plan, no checkpoints, and the
census takes its Q.

On more than one device (``num_devices``, default every visible one) LPA
runs on a mesh (:mod:`graphmine_tpu_torch.parallel`) with the planner's
schedule, ``replicated`` or ``ring``: sharded checkpoints, ``replicated``
degrading to ``ring`` on memory, the elastic rungs (halved meshes routed
round the lost device, a ``mesh_degrade`` record) on a device loss, and
LOF through the sharded kNN. When the whole graph would not fit one
device the run scales out (a ``scale_out`` record): the graph stays on the
host, the recursive outliers run over the mesh, the features on the host
(``host-8-sampled``) and the publish's CC over the mesh. A mesh that
repeats a device (``GRAPHMINE_VIRTUAL_DEVICES``) marks its ``plan``,
``partition``, ``superstep_timing`` and ``mesh_degrade`` records
``virtual: true``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from graphmine_tpu_torch.device import resolve_device, visible_devices
from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.io.edges import EdgeTable, load_edge_list, load_parquet_edges
from graphmine_tpu_torch.obs import memmodel
from graphmine_tpu_torch.obs.costmodel import WindowTimer, superstep_cost
from graphmine_tpu_torch.obs.spans import OPS
from graphmine_tpu_torch.pipeline import checkpoint as ckpt
from graphmine_tpu_torch.pipeline import planner, resilience
from graphmine_tpu_torch.pipeline.config import PipelineConfig
from graphmine_tpu_torch.pipeline.metrics import MetricsSink, maybe_profile

log = logging.getLogger("graphmine_tpu_torch")


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
    # "exact" or "sampled" clustering column; "host-8-sampled" in scale-out
    feature_mode: str | None = None
    metrics: MetricsSink = field(default_factory=MetricsSink)
    scale_out: bool = False            # the graph stayed on the host
    mesh_devices: tuple = ()           # the run's mesh (empty on one device)


def _sync(device: torch.device) -> None:
    """Wait for the current stream's work on ``device`` (a CUDA device)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _host_copy(labels: torch.Tensor) -> np.ndarray:
    """The labels on the host, copied on a side stream of their CUDA
    device: the watchdog's hook runs while a hung superstep may still sit
    on the current stream, and a copy queued behind it would hang too.
    The labels themselves were completed at the previous boundary."""
    if not labels.is_cuda:
        return labels.numpy().copy()
    with torch.cuda.stream(torch.cuda.Stream(labels.device)):
        return labels.cpu().numpy()


def run_pipeline(config: PipelineConfig) -> PipelineResult:
    config.validate()
    device = resolve_device(config.device)
    from graphmine_tpu_torch.obs.spans import Tracer

    # Records stream to metrics_out as emitted, each with the tracer's
    # identity; run_start opens this run's segment of the file.
    tracer = Tracer(run_id=config.run_id)
    m = MetricsSink(stream_path=config.metrics_out, tracer=tracer)
    m.emit("run_start", pid=os.getpid(), data_path=config.data_path, device=str(device),
           community_method=config.community_method, max_iter=config.max_iter)
    hb = None
    if config.heartbeat_every_s:
        from graphmine_tpu_torch.obs.heartbeat import Heartbeat

        hb = Heartbeat(m, every_s=config.heartbeat_every_s, prom_path=config.prom_out).start()
    run_err: BaseException | None = None
    try:
        result = _run_pipeline(config, m, device)
        if config.snapshot_out:
            _publish_snapshot(config, result, m, device)
        return result
    except BaseException as e:
        run_err = e
        raise
    finally:
        # Finalized on every exit: stop the heartbeat, close the run with
        # run_end, publish the registry, close or complete the stream. A
        # failed flush must not mask the pipeline's own outcome.
        if hb is not None:
            hb.stop()
        if run_err is None:
            m.emit("run_end", ok=True)
        else:
            m.emit("run_end", ok=False, error=resilience.classify_error(run_err),
                   error_detail=repr(run_err))
        tracer.close()
        if config.prom_out:
            try:
                m.registry.write_textfile(config.prom_out, labels={"run_id": tracer.run_id})
            except OSError as prom_err:
                log.warning("could not write --prom-out %s: %r", config.prom_out, prom_err)
        if config.metrics_out:
            try:
                m.finalize(config.metrics_out)
            except OSError as flush_err:
                log.warning("could not write --metrics-out %s: %r", config.metrics_out,
                            flush_err)


def _run_pipeline(config: PipelineConfig, m: MetricsSink,
                  device: torch.device) -> PipelineResult:
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.blocking import build_graph_and_blocked_plan, plan_build_stats
    from graphmine_tpu_torch.ops.bucketed_mode import build_graph_and_plan
    from graphmine_tpu_torch.ops.census import census_table
    from graphmine_tpu_torch.ops.lpa import num_communities
    from graphmine_tpu_torch.ops.modularity import modularity

    policy = config.resilience

    # ---- load -----------------------------------------------------------
    def _load():
        resilience.fault_point("load", path=config.data_path)
        if config.data_format == "parquet":
            return load_parquet_edges(config.data_path, batch_rows=config.batch_rows)
        return load_edge_list(config.data_path, weight_col=config.edge_weight_col,
                              quarantine=config.quarantine_inputs)

    with m.span("load"), m.timed("load", path=config.data_path, format=config.data_format):
        table = resilience.run_phase("load", _load, policy, m)
    m.emit("counts", rows_raw=table.num_rows_raw, edges=table.num_edges,
           vertices=table.num_vertices)
    # gated on the flag: the parquet loader always counts its null filter
    if table.quarantine and config.quarantine_inputs:
        m.emit("quarantine", **table.quarantine)

    # ---- plan: LPA's operating point against the card's memory ---------
    # (Louvain and Leiden read no LPA plan, so none is built for them)
    v, e = table.num_vertices, table.num_edges
    mesh_devices = _mesh_devices(config, device)
    n_dev = len(mesh_devices)
    run_plan = sstep_plan = None
    if config.community_method == "lpa" and config.backend != "graphframes":
        run_plan, sstep_plan = _plan_lpa(config, table, m, device, mesh_devices)
    # Scale-out: a distributed schedule whose whole graph would not also fit
    # one device keeps the graph on the host; the mesh takes LPA, the
    # recursive outliers, the LOF kNN and the publish's CC.
    scale_out = (run_plan is not None and run_plan.schedule != "single"
                 and run_plan.estimates.get("single", 0) > run_plan.hbm_bytes)
    if scale_out:
        m.emit("scale_out", message="full graph exceeds one device: host-resident graph; "
               "outlier phases run distributed (recursive LPA over the intra-community "
               "subgraph, sharded kNN/LOF)")
    graph_device = torch.device("cpu") if scale_out else device

    # ---- build: message CSR + the family's plan, one pass ---------------
    def _build():
        resilience.fault_point("build_graph")
        if sstep_plan is None or sstep_plan.family == "sort":
            g = build_graph(table.src, table.dst, num_vertices=v, edge_weights=table.weights,
                            device=graph_device)
            _sync(graph_device)
            return g, [None]
        build = (build_graph_and_blocked_plan if sstep_plan.family == "blocked"
                 else build_graph_and_plan)
        t0 = time.perf_counter()
        g, plan = build(table.src, table.dst, num_vertices=v, edge_weights=table.weights,
                          device=device)
        _sync(device)
        m.emit("plan_build", op="lpa_superstep", seconds=round(time.perf_counter() - t0, 6),
               cached=False,
               cost=superstep_cost("lpa_superstep", sstep_plan.family, v, g.num_messages, e,
                                   plan=plan).record(),
               max_degree=int(g.degrees().max()) if g.num_vertices else 0,
               **plan_build_stats(plan, e))
        # a holder, so the LPA loop can release the plan when the ladder
        # leaves its superstep
        return g, [plan]

    with m.span("build_graph"), m.timed("build_graph"):
        graph, plan_holder = resilience.run_phase("build_graph", _build, policy, m)

    # ---- community detection: LPA, or Louvain / Leiden ------------------
    if config.community_method in ("louvain", "leiden"):
        from graphmine_tpu_torch.ops.louvain import leiden, louvain

        if config.checkpoint_dir:
            m.emit("warning", message="checkpoint/resume applies to LPA only; "
                   f"{config.community_method} runs are not checkpointed")
        algo = leiden if config.community_method == "leiden" else louvain
        with m.span(config.community_method), m.timed(config.community_method,
                                                      gamma=config.gamma):
            labels, q_algo = algo(graph, gamma=config.gamma)
            _sync(device)
    elif config.backend == "graphframes":
        from graphmine_tpu_torch.pipeline.backends import lpa_graphframes

        with m.span("lpa"), m.timed("lpa", backend="graphframes"):
            labels = torch.as_tensor(lpa_graphframes(table, config.max_iter).astype(np.int32),
                                     device=device)
        q_algo = None
    else:
        with m.span("lpa"), m.timed("lpa", max_iter=config.max_iter):
            labels = _run_lpa(config, table, graph, m, plan_holder, run_plan, sstep_plan,
                              device, mesh_devices)
        q_algo = None
    del plan_holder
    labels = labels.to(graph.device)

    # ---- census ---------------------------------------------------------
    def _census():
        resilience.fault_point("census")
        q = q_algo if q_algo is not None else modularity(labels, graph, gamma=config.gamma)
        return num_communities(labels), census_table(labels, graph), q

    with m.span("census"), m.timed("census"):
        n_comm, (present, sizes, edge_counts), q = resilience.run_phase(
            "census", _census, policy, m)
    m.emit("communities", count=n_comm, largest=int(sizes.max(initial=0)),
           modularity=round(q, 6))

    result = PipelineResult(
        edge_table=table, graph=graph, labels=labels.cpu().numpy(),
        num_communities=n_comm, community_table=(present, sizes, edge_counts),
        metrics=m, scale_out=scale_out,
        mesh_devices=tuple(mesh_devices) if n_dev > 1 else (),
    )

    # ---- recursive-LPA outliers ----------------------------------------
    if config.outlier_method in ("recursive_lpa", "both"):
        from graphmine_tpu_torch.ops.outliers import (
            recursive_lpa_outliers,
            recursive_lpa_outliers_sharded,
        )

        if scale_out:
            # the one-device masked pass would put the whole graph on one
            # device, which the planner just ruled out: filter on the host,
            # run the planner's schedule on the mesh
            from graphmine_tpu_torch.parallel.mesh import make_mesh

            def scorer():
                return recursive_lpa_outliers_sharded(
                    graph, labels, make_mesh(n_dev, devices=mesh_devices),
                    max_iter=config.sub_max_iter, decile=config.decile,
                    schedule=run_plan.schedule)

            timing_kv = dict(schedule=run_plan.schedule, devices=n_dev)
        else:
            def scorer():
                return recursive_lpa_outliers(graph, labels, max_iter=config.sub_max_iter,
                                              decile=config.decile)

            timing_kv = {}

        def _outliers():
            resilience.fault_point("outliers_recursive")
            return scorer()

        with m.span("outliers_recursive_lpa"), m.timed("outliers_recursive_lpa", **timing_kv):
            result.outliers = resilience.run_phase("outliers_recursive", _outliers, policy, m)
        m.emit("outlier_summary", method="recursive_lpa",
               flagged_vertices=int(result.outliers.outlier_vertices.sum()),
               sub_communities=len(result.outliers.sub_sizes))

    # ---- features + kNN/LOF: the planner's family, the other as rung ----
    if config.outlier_method in ("lof", "both"):
        _run_lof(config, graph, labels, result, m, run_plan, device, mesh_devices, scale_out)
    return result


def _mesh_devices(config: PipelineConfig, device: torch.device) -> list:
    """The run's devices: the first ``num_devices`` (default all) of
    :func:`~graphmine_tpu_torch.device.visible_devices` of ``device``'s
    kind, ``device`` first
    (:func:`~graphmine_tpu_torch.parallel.mesh.device_mesh`); more than
    are visible raises, as the JAX pipeline's mesh does. The driver's
    mesh lives in one process, as the JAX driver's does: inside a
    ``torch.distributed`` world (whose meshes span processes) it raises."""
    from graphmine_tpu_torch.parallel.mesh import device_mesh

    n = config.num_devices or len(visible_devices(device))
    mesh = device_mesh(n, device)
    if mesh.process:
        raise ValueError("the pipeline driver runs its mesh inside one process, as the JAX "
                         "package's driver does; run it outside a torch.distributed world")
    return list(mesh.devices)


def _virtual(devices) -> dict:
    """``{"virtual": True}`` for a mesh that repeats a device, else ``{}``:
    the key every plan, partition, superstep_timing and mesh_degrade record
    of such a mesh carries."""
    devices = list(devices)
    return {"virtual": True} if len(set(devices)) < len(devices) else {}


def _plan_lpa(config: PipelineConfig, table: EdgeTable, m: MetricsSink,
              device: torch.device, mesh_devices: list) -> tuple:
    """``(run_plan, sstep_plan)`` of an LPA run: the operating point
    checked against the card's memory (the ``plan`` record), and on one
    device the superstep family with its plan-time pre-degrade and the
    ``impl_selected`` record (``sstep_plan`` is None on a mesh)."""
    v, e = table.num_vertices, table.num_edges
    policy = config.resilience
    weighted = table.weights is not None
    n_dev = len(mesh_devices)
    run_plan = planner.plan_run(
        v, e, n_dev, weighted=weighted, requested=config.schedule,
        hbm=planner.hbm_bytes_per_device(lambda: planner.device_hbm_bytes(device)),
    )
    m.emit("plan", schedule=run_plan.schedule, bytes_per_device=run_plan.bytes_per_device,
           hbm_budget=run_plan.hbm_bytes, reason=run_plan.reason,
           mem=memmodel.schedule_footprint(run_plan.schedule, v, e, n_dev,
                                           weighted=weighted).record(),
           **(_virtual(mesh_devices) if run_plan.schedule != "single" else {}))
    if run_plan.schedule != "single":
        return run_plan, None
    sstep_plan = planner.plan_superstep(v, 2 * e, weighted=weighted)
    if sstep_plan.family == "sort" and not os.environ.get("GRAPHMINE_SUPERSTEP_FAMILY"):
        # the plan shares the graph's CSR pass, so the driver keeps the
        # bucketed superstep at every size unless the env forces sort
        sstep_plan = dataclasses.replace(
            sstep_plan, family="bucketed", degrade_to="sort",
            reason=sstep_plan.reason + " — driver single path: plan build shares the "
            "graph's CSR pass, bucketed kernel kept",
        )
    if policy.degradation == "auto":
        # a family whose modeled footprint exceeds the budget cannot
        # survive the build: consume its rung now, with the inventory
        fam, _fit, steps = memmodel.predegrade_superstep(
            sstep_plan.family, v, 2 * e, e, weighted, run_plan.hbm_bytes)
        for depth, (frm, to, oversized) in enumerate(steps, 1):
            m.emit("degrade", stage="plan_superstep", to=to, depth=depth, kind="mem_plan",
                   error=(f"plan-time memory pre-degrade: modeled {frm!r} footprint "
                          f"{oversized.total_bytes:,} B exceeds the "
                          f"{run_plan.hbm_bytes:,} B budget"),
                   mem=oversized.record())
        if steps:
            sstep_plan = dataclasses.replace(
                sstep_plan, family=fam, degrade_to=planner._SUPERSTEP_DEGRADE[fam],
                reason=sstep_plan.reason + f" — pre-degraded to {fam!r}: modeled footprint "
                f"of {steps[0][0]!r} exceeds the memory budget")
    m.emit("impl_selected", op="lpa_superstep", impl=sstep_plan.family, n=2 * e,
           reason=sstep_plan.reason, weighted=weighted,
           thresholds=planner.crossover_thresholds(),
           cost=superstep_cost("lpa_superstep", sstep_plan.family, v, 2 * e, e,
                               weighted=weighted).record())
    return run_plan, sstep_plan


def _run_lof(config: PipelineConfig, graph: Graph, labels: torch.Tensor,
             result: PipelineResult, m: MetricsSink, run_plan, device: torch.device,
             mesh_devices: list, scale_out: bool) -> None:
    """Features, then LOF on the planner's kNN family with the opposite
    family as its degradation rung: an OOM in the IVF index's chunk
    tables steps across to the exact ``knn_topk`` kernel, an OOM in the
    exact kNN down to the index. On a mesh whose chunks hold ``k``
    candidates LOF runs through the sharded kNN (the IVF search split over
    the mesh, or the ring); in scale-out the features come from the host
    graph with the sampled clustering column."""
    from graphmine_tpu_torch.graph.container import simple_undirected_edges
    from graphmine_tpu_torch.ops.features import (
        standardize,
        vertex_features,
        vertex_features_host,
    )
    from graphmine_tpu_torch.ops.lof import lof_scores
    from graphmine_tpu_torch.ops.triangles import oriented_wedge_count
    from graphmine_tpu_torch.parallel.knn import can_shard

    v = graph.num_vertices
    n_dev = len(mesh_devices)
    k = min(config.lof_k, v - 1)
    use_sharded = n_dev > 1 and can_shard(v, n_dev, k)
    lof_plan = planner.plan_lof(v, k, requested=config.lof_impl)
    if use_sharded and config.lof_impl in ("xla", "pallas"):
        m.emit("warning", message=f"lof_impl={config.lof_impl!r} forces an exact "
               "single-device kernel; the multi-device path runs the exact ring-sharded "
               "kNN/LOF instead (auto/ivf apply to the sharded scorer)")
    if scale_out and not use_sharded:
        m.emit("warning", message="lof skipped in scale-out mode: the single-device scorer "
               "cannot hold a graph this size; add devices so the sharded kNN/LOF can run")
        return
    with m.span("features"), m.timed("features"):
        if scale_out:
            # the host twin; the exact wedge pipeline is infeasible exactly
            # when the graph exceeds one device, so the sampled estimator
            result.feature_mode = "host-8-sampled"
            feats = standardize(torch.from_numpy(vertex_features_host(
                graph, labels, include_clustering="sampled"))).to(device).contiguous()
        else:
            # Wedge-budget guard: the exact clustering column materializes
            # every oriented wedge on the host; past the budget the sampled
            # estimator takes over. One dedup serves the probe and the column.
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
    n_feat = int(feats.shape[1])
    lof_devices = n_dev if use_sharded else 1
    mem_holder = [memmodel.lof_footprint(lof_plan.impl, v, k, features=n_feat,
                                         devices=lof_devices)]
    if use_sharded:
        from graphmine_tpu_torch.parallel.knn import sharded_lof
        from graphmine_tpu_torch.parallel.mesh import make_mesh

        def _lof(impl):
            return sharded_lof(feats, make_mesh(n_dev, devices=mesh_devices), k=k, impl=impl,
                               sink=m)

        first = lof_plan.impl
        rung_name = f"lof_sharded_{lof_plan.degrade_to}"
        rung_impl = lof_plan.degrade_to
    else:
        def _lof(impl):
            return lof_scores(feats, k=k, impl=impl, sink=m)

        first = config.lof_impl
        rung_name = f"lof_{lof_plan.degrade_to}"
        rung_impl = "xla" if lof_plan.degrade_to == "exact" else "ivf"

    def _score():
        resilience.fault_point("outliers_lof")
        return _lof(first)

    def _rung():
        # the failed family's tensors are gone (run_phase cleared its
        # frames): return their cached blocks before the rung allocates
        mem_holder[0] = memmodel.lof_footprint(lof_plan.degrade_to, v, k, features=n_feat,
                                               devices=lof_devices)
        resilience.release_device_memory()
        return _lof(rung_impl)

    with m.span("outliers_lof"), m.timed("outliers_lof", k=k, devices=lof_devices,
                                          features=result.feature_mode):
        scores = resilience.run_phase(
            "outliers_lof", _score, config.resilience, m,
            ladder=((rung_name, _rung),),
            degrade_context=lambda: {"mem": mem_holder[0].record()},
        )
        result.lof = scores.cpu().numpy()
        memmodel.emit_memory_watermark(
            m, "lof_knn", mem_holder[0], memmodel.device_sample(device),
            budget_bytes=run_plan.hbm_bytes if run_plan is not None else None,
            impl=mem_holder[0].family)
    m.emit("outlier_summary", method="lof", max_score=float(result.lof.max()),
           over_1_5=int((result.lof > 1.5).sum()))


def _emit_superstep_telemetry(m: MetricsSink, new: torch.Tensor, old: torch.Tensor,
                              chunk: int, ndev: int, variant: str, iteration: int) -> int:
    """``superstep_telemetry`` record of one superstep: labels changed per
    shard (``chunk`` is the partition's padded chunk; the shard count is
    clamped to the chunks that cover real vertices, so the counts sum to
    the total) and the max/mean imbalance. Returns the changed count."""
    n = int(new.shape[0])
    d = max(1, min(int(ndev), -(-n // max(chunk, 1))))
    diff = (new != old).to(torch.int32)
    pad = d * chunk - n
    if pad > 0:
        diff = torch.cat([diff, diff.new_zeros(pad)])
    per = diff[: d * chunk].view(d, chunk).sum(dim=1).cpu().numpy()
    changed = int(per.sum())
    mean = changed / d
    m.emit("superstep_telemetry", iteration=iteration, labels_changed=changed,
           frontier=changed, shard_changed=per.tolist(), shard_max=int(per.max()),
           shard_min=int(per.min()),
           imbalance=round(float(per.max()) / mean if mean > 0 else 1.0, 3),
           devices=int(ndev), variant=variant)
    return changed


def _run_lpa(config: PipelineConfig, table: EdgeTable, graph: Graph, m: MetricsSink,
             plan_holder: list, run_plan, sstep_plan, device: torch.device,
             mesh_devices: list) -> torch.Tensor:
    """LPA one superstep at a time under the run harness: resume,
    checkpoints, watchdog, tripwires, the memory rungs (blocked →
    ``single_bucketed`` → ``single_sort`` on one device, ``replicated`` →
    ``ring`` on a mesh), the elastic device rungs of a mesh and the
    per-superstep records."""
    from graphmine_tpu_torch.obs.costmodel import sharded_superstep_cost
    from graphmine_tpu_torch.ops.blocking import (
        BlockedPlan,
        build_family_plan,
        lpa_superstep_blocked,
        plan_build_stats,
        timed_plan_build,
    )
    from graphmine_tpu_torch.ops.bucketed_mode import BucketedModePlan, lpa_superstep_bucketed
    from graphmine_tpu_torch.ops.lpa import lpa_superstep
    from graphmine_tpu_torch.parallel.mesh import make_mesh, surviving_mesh
    from graphmine_tpu_torch.parallel.sharded import (
        partition_graph,
        partition_graph_on_mesh,
        shard_graph_arrays,
    )

    v, e, msgs = graph.num_vertices, graph.num_edges, graph.num_messages
    is_weighted = graph.msg_weight is not None
    policy = config.resilience
    n_dev = len(mesh_devices)
    chips = max(n_dev, 1)
    # superstep durations accumulate here and flush as superstep_timing
    # records at the telemetry cadence (the loop syncs every superstep)
    wtimer = WindowTimer()
    labels = torch.arange(v, dtype=torch.int32, device=device)
    start_iter = 0
    # ties every checkpoint to this graph, id assignment and weights
    fingerprint = (ckpt.graph_fingerprint(table.src, table.dst, table.weights)
                   if config.checkpoint_dir else None)

    def _reload_checkpoint():
        return ckpt.load_newest(config.checkpoint_dir, fingerprint=fingerprint, sink=m)

    def _to_device(host_labels) -> torch.Tensor:
        return torch.from_numpy(np.asarray(host_labels, dtype=np.int32)).to(device)

    if config.resume and config.checkpoint_dir:
        loaded = _reload_checkpoint()
        if loaded is not None:
            saved_labels, start_iter = loaded
            if start_iter > config.max_iter:
                raise ValueError(
                    f"checkpoint at iteration {start_iter} exceeds max_iter="
                    f"{config.max_iter}; delete the checkpoint or raise max_iter"
                )
            labels = _to_device(saved_labels)
            m.emit("resume", iteration=start_iter)
    if config.schedule == "ring" and run_plan.schedule == "single":
        m.emit("warning", message="schedule='ring' needs >1 device; running the "
               "single-device superstep instead")

    # Loop state shared by every rung: a retry or a degradation resumes
    # from the last good superstep; supersteps are deterministic, so the
    # labels equal an uninterrupted run's. `current` is the active
    # operating point: the elastic rungs shrink ndev, and the sharded
    # checkpoints split by whatever is current.
    state = {"labels": labels, "it": start_iter}
    current: dict = {"variant": run_plan.schedule, "ndev": n_dev}
    last_watermark: dict = {"rec": None}

    def _mem_watermark(iteration: int, variant: str, ndev: int) -> None:
        rec = memmodel.emit_memory_watermark(
            m, "lpa_superstep", current.get("mem"), memmodel.device_sample(device),
            budget_bytes=run_plan.hbm_bytes, iteration=int(iteration), variant=variant,
            devices=int(ndev))
        if rec is not None:
            last_watermark["rec"] = rec

    def _lpa_degrade_context() -> dict:
        ctx = {}
        if current.get("mem") is not None:
            ctx["mem"] = current["mem"].record()
        w = last_watermark["rec"]
        if w is not None:
            ctx["last_watermark"] = {k: w.get(k) for k in (
                "t", "op", "iteration", "predicted_bytes", "achieved_bytes",
                "headroom_frac", "source", "span_path")}
        return ctx

    # Device indices named by a device-loss error: a rung mesh routes
    # round them instead of re-enrolling a device that just failed.
    dead_devices: set = set()

    def _rung_mesh(ndev: int):
        if dead_devices:
            try:
                return surviving_mesh(ndev, exclude=sorted(dead_devices), devices=mesh_devices)
            except ValueError:
                pass  # too few survivors: the first-N mesh (the parse may over-match)
        return make_mesh(ndev, devices=mesh_devices)

    def _note_dead_devices() -> None:
        """The chip indices of the device-loss error behind this descent
        (run_phase records it in the degrade event before the rung runs);
        best effort: an unattributed loss still degrades."""
        import re

        device_degrades = [r for r in m.of_phase("degrade") if r.get("kind") == "device"]
        if device_degrades:
            for tok in re.findall(r"(?:chip|device)\s+#?(\d+)",
                                  device_degrades[-1].get("error", "")):
                dead_devices.add(int(tok))

    def make_superstep(variant: str, ndev: int):
        """The per-superstep callable of one operating point (schedule x
        device count)."""
        if variant in ("replicated", "ring"):
            from graphmine_tpu_torch.parallel.ring import ring_label_propagation
            from graphmine_tpu_torch.parallel.sharded import sharded_label_propagation

            mesh = _rung_mesh(ndev)
            lpa_only = variant == "replicated" and run_plan.lpa_only
            with m.timed("partition", shards=ndev, schedule=variant, **_virtual(mesh.devices)):
                if variant == "replicated" and all(d.type == "cuda" for d in mesh.devices):
                    # each card builds its own shard from the edge list
                    sg = partition_graph_on_mesh(graph.src, graph.dst, v, mesh,
                                                 lpa_only=lpa_only, edge_weights=table.weights)
                else:
                    sg = shard_graph_arrays(
                        partition_graph(graph, mesh=mesh,
                                        build_bucket_plan=variant == "replicated"),
                        mesh, lpa_only=lpa_only)
                _sync(device)
            current["chunk_size"] = sg.chunk_size
            current["cost"] = sharded_superstep_cost("lpa_superstep", sg, e, num_messages=msgs)
            current["mem"] = memmodel.sharded_superstep_footprint("lpa_superstep", sg,
                                                                  schedule=variant)
            run = ring_label_propagation if variant == "ring" else sharded_label_propagation
            return lambda lbl: run(sg, mesh, max_iter=1, init_labels=lbl)
        current["chunk_size"] = v
        if variant == "single_sort":
            # the degradation rung: the sort-based superstep over the bare
            # message CSR, no padded plan matrices, the same labels
            current["cost"] = superstep_cost("lpa_superstep", "sort", v, msgs, e,
                                             weighted=is_weighted)
            current["mem"] = memmodel.superstep_footprint(
                "lpa_superstep", "sort", v, msgs, num_edges=e, weighted=is_weighted)
            return lambda lbl: lpa_superstep(lbl, graph)
        if variant == "single_bucketed":
            # the blocked → bucketed rung: the blocked plan went on entry;
            # build the bucketed one (same labels, no tile or stream) and
            # record its build like every other plan's
            plan, secs = timed_plan_build(lambda: build_family_plan(graph, "bucketed"))
            plan_holder[0] = plan
            m.emit("plan_build", op="lpa_superstep", seconds=round(secs, 6), cached=False,
                   cost=superstep_cost("lpa_superstep", "bucketed", v, msgs, e,
                                       plan=plan).record(),
                   **plan_build_stats(plan, e))
        plan = plan_holder[0]
        if plan is None:
            raise ValueError("the fused LPA superstep needs the plan built with the graph")
        current["cost"] = superstep_cost("lpa_superstep", "auto", v, msgs, e, plan=plan)
        current["mem"] = memmodel.superstep_footprint("lpa_superstep", "auto", v, msgs,
                                                      num_edges=e, plan=plan)
        if isinstance(plan, BlockedPlan):
            return lambda lbl: lpa_superstep_blocked(lbl, graph, plan)
        return lambda lbl: lpa_superstep_bucketed(lbl, graph, plan)

    def save_ck(iteration: int, host_labels=None) -> None:
        lab = state["labels"] if host_labels is None else host_labels
        if current["ndev"] > 1:
            # a mesh writes the sharded manifest (re-shardable on restore:
            # an elastic descent resumes on fewer devices)
            ckpt.save_sharded(config.checkpoint_dir, lab, iteration, fingerprint=fingerprint,
                              num_shards=current["ndev"], sink=m)
        else:
            ckpt.save_labels(config.checkpoint_dir, lab, iteration, fingerprint=fingerprint,
                             sink=m)

    # Built supersteps survive retry re-entry (no re-partition); operating
    # points that ran >= 1 superstep arm the watchdog (the first one of a
    # point is never bounded: it carries the point's warm-up); `entered`
    # points ran their entry preamble (salvage, mesh_degrade) once.
    superstep_cache: dict = {}
    warmed: set = set()
    entered: set = set()
    trip_k = policy.tripwire_every_k

    def check_tripwire(new: torch.Tensor, it: int, variant: str) -> None:
        """Labels outside [0, V) mean corrupted state: roll back to the
        last checkpoint, then raise the retryable DivergenceError naming
        the shard (the partition's real chunk). One host sync, on the
        existing cadence."""
        bad = (new < 0) | (new >= v)
        n_bad = int(bad.sum())
        if not n_bad:
            return
        chunk = current.get("chunk_size") or v
        shard = int(torch.argmax(bad.to(torch.int32))) // max(chunk, 1)
        err = resilience.DivergenceError("label_out_of_range", shard, it + 1)
        m.tripwire(err.kind, err.shard, err.iteration, stage="lpa", bad_vertices=n_bad,
                   variant=variant)
        restored = _reload_checkpoint() if config.checkpoint_dir else None
        if restored is not None:
            state["labels"] = _to_device(restored[0])
            state["it"] = restored[1]
            m.emit("resume", iteration=restored[1], reason="tripwire")
        raise err

    def make_runner(variant: str | None, ndev: int | None = None):
        """The remaining-supersteps loop at one operating point. ``ndev``
        None inherits the mesh size current at entry (a memory rung leans
        the schedule where the elastic ladder already moved the run); an
        explicit one is an elastic rung. ``variant`` None inherits the
        current schedule: a device rung rebuilds the schedule the run was
        using (replicated OOMs, ring rescues, a device dies: the smaller
        mesh runs ring)."""

        def run():
            nd = current["ndev"] if ndev is None else ndev
            var = current["variant"] if variant is None else variant
            key = (var, nd)
            if key not in entered:
                entered.add(key)
                if nd < current["ndev"]:
                    # elastic descent: route round the implicated devices and
                    # salvage the loop state (in memory when the copy to the
                    # host still works, else the last checkpoint, re-sharded)
                    _note_dead_devices()
                    try:
                        host_labels = _host_copy(state["labels"])
                        resumed_from = "memory"
                    except Exception as salvage_err:
                        restored = _reload_checkpoint() if config.checkpoint_dir else None
                        if restored is None:
                            raise RuntimeError(
                                "device loss with no recoverable state: the in-memory labels "
                                f"died with the mesh ({salvage_err!r}) and no checkpoint "
                                "exists; set checkpoint_dir to make device loss survivable"
                            ) from salvage_err
                        host_labels, state["it"] = restored
                        resumed_from = "checkpoint"
                    state["labels"] = _to_device(host_labels)
                    m.emit("mesh_degrade", from_devices=current["ndev"], to_devices=nd,
                           schedule=var, iteration=state["it"], resumed_from=resumed_from,
                           dead_devices=sorted(dead_devices), **_virtual(mesh_devices))
            current["ndev"], current["variant"] = nd, var
            # a rung's entry: release what the failed operating point held
            # (its cached superstep and a plan this rung does not run),
            # then return the freed blocks to the card
            stale = [k for k in superstep_cache if k != key]
            for k in stale:
                del superstep_cache[k]
                warmed.discard(k)
            keeps_plan = var == "single" or (
                var == "single_bucketed" and isinstance(plan_holder[0], BucketedModePlan))
            if plan_holder[0] is not None and not keeps_plan:
                plan_holder[0] = None
                stale.append("plan")
            if stale:
                resilience.release_device_memory()
            if key not in superstep_cache:
                superstep_cache[key] = make_superstep(var, nd)
            one_iter = superstep_cache[key]
            virt = _virtual(_rung_mesh(nd).devices) if nd > 1 else {}
            m.registry.gauge("graphmine_devices_alive", "devices in the active LPA mesh").set(nd)
            # a window never mixes two operating points
            wtimer.reset()
            _mem_watermark(state["it"], var, nd)
            while state["it"] < config.max_iter:
                it = state["it"]

                def step_sync():
                    resilience.fault_point("lpa_superstep", iteration=it + 1, variant=var,
                                           state=state, num_shards=nd)
                    with OPS.span("lpa.superstep", sink=m):
                        new = one_iter(state["labels"])
                    _sync(device)
                    return new

                with m.span("superstep", emit=False, iteration=it + 1):
                    was_warm = key in warmed
                    t0 = time.perf_counter()
                    # checkpoint-then-abort: on a hung superstep the last
                    # good labels (iteration it) are saved from a host copy
                    new = resilience.run_with_watchdog(
                        "lpa_superstep", step_sync,
                        policy.superstep_timeout_s if was_warm else None, m,
                        on_timeout=((lambda it=it: save_ck(it, _host_copy(state["labels"])))
                                    if config.checkpoint_dir else None),
                    )
                    dt = time.perf_counter() - t0
                    warmed.add(key)
                    if was_warm:
                        wtimer.add(dt)
                    # every Nth superstep and always the last
                    will_save = bool(config.checkpoint_dir) and (
                        (it + 1) % config.checkpoint_every == 0 or it + 1 == config.max_iter)
                    # a superstep that will be persisted is always checked
                    if trip_k and ((it + 1) % trip_k == 0 or will_save):
                        check_tripwire(new, it, var)
                    if will_save or it + 1 == config.max_iter or (
                            trip_k and (it + 1) % trip_k == 0):
                        changed = _emit_superstep_telemetry(
                            m, new, state["labels"], current.get("chunk_size") or v, nd, var,
                            it + 1)
                        wtimer.flush(m, "lpa_superstep", current.get("cost"), it + 1, e,
                                     variant=var, **virt)
                        _mem_watermark(it + 1, var, nd)
                    else:
                        changed = int((new != state["labels"]).sum())
                    state["labels"] = new
                    state["it"] = it + 1
                    reg = m.registry
                    reg.gauge("graphmine_superstep", "last completed LPA superstep").set(it + 1)
                    reg.gauge("graphmine_labels_changed",
                              "labels changed in the last superstep").set(changed)
                    reg.counter("graphmine_supersteps_total",
                                "LPA supersteps completed this run").inc()
                    m.lpa_iteration(it + 1, changed, e, dt, chips)
                    if will_save:
                        save_ck(it + 1)
            return state["labels"]

        return run

    family = sstep_plan.family if sstep_plan is not None else "bucketed"
    rungs = planner.degradation_ladder(run_plan.schedule, n_dev, family=family)
    # Elastic device rungs (a device loss): halved meshes running the
    # schedule current at the descent; the one-device floor runs the sort
    # superstep, only when the whole graph fits one device.
    device_rungs = []
    for d2 in planner.elastic_device_ladder(run_plan.schedule, n_dev):
        if d2 > 1:
            device_rungs.append((f"elastic@{d2}dev", make_runner(None, d2)))
        elif run_plan.estimates.get("single", 0) <= run_plan.hbm_bytes:
            device_rungs.append(("single_sort@1dev", make_runner("single_sort", 1)))
    if run_plan.schedule != "single":
        primary = run_plan.schedule
    else:
        primary = "single_sort" if family == "sort" else "single"
    with maybe_profile(config.profile_dir, sink=m):
        return resilience.run_phase(
            "lpa", make_runner(primary), policy, m,
            ladder=tuple((r, make_runner(r)) for r in rungs),
            device_ladder=tuple(device_rungs),
            # supersteps advanced since the last failure: a new incident
            progress=lambda: state["it"],
            degrade_context=_lpa_degrade_context,
        )


def _publish_snapshot(config: PipelineConfig, result: PipelineResult, m: MetricsSink,
                      device: torch.device) -> None:
    """Publish the run's outputs as one snapshot generation at
    ``config.snapshot_out``: the edges, labels, CC labels (computed here,
    the pipeline's only CC: over the mesh when the graph stayed on the
    host), census and LOF, and the weights of a weighted run, under
    ``run_phase`` (transient weather retries). The quality
    pass re-scores the store's canary probe on ``device``
    (``GRAPHMINE_QUALITY=0`` turns it off, ``GRAPHMINE_CANARY_SEED`` seeds
    a new probe) and mirrors its gauges into the sink's registry; its
    failures are warnings, never a failed publish."""
    from graphmine_tpu_torch.obs.quality import CanaryProbe, run_quality_pass
    from graphmine_tpu_torch.ops.cc import connected_components
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    table, graph = result.edge_table, result.graph

    def _publish():
        resilience.fault_point("snapshot_publish")
        if result.scale_out:
            cc_t, iters = _sharded_cc(graph, result.mesh_devices, m)
        else:
            # sink=m: impl_selected, plan_build and the superstep_timing record
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
            arrays, fingerprint=ckpt.graph_fingerprint(table.src, table.dst, table.weights),
            run_id=m.tracer.run_id if m.tracer is not None else "",
            mesh_shape=[max(len(result.mesh_devices), 1)],
            extra_meta={"canary": canary.meta()} if canary is not None else None, sink=m,
        )
        if quality_on:
            try:
                run_quality_pass(
                    arrays["labels"], arrays.get("lof"), snap.version,
                    parent_labels=parent_arrays.get("labels"),
                    parent_lof=parent_arrays.get("lof"),
                    parent_version=parent_meta.get("version"),
                    canary=canary, sink=m, device=device, registry=m.registry,
                )
            except Exception as e:  # noqa: BLE001 — the publish has committed
                m.emit("warning", message=f"quality pass failed: {e!r}")
        _sync(device)
        return snap

    with m.span("snapshot_publish"):
        resilience.run_phase("snapshot_publish", _publish, config.resilience, m)


def _sharded_cc(graph: Graph, mesh_devices, m: MetricsSink) -> tuple:
    """``(cc labels, supersteps)`` of a host graph over the mesh, with the
    ``partition`` record and the CC window's ``superstep_timing``."""
    from graphmine_tpu_torch.obs.costmodel import (
        emit_superstep_timing,
        sharded_superstep_cost,
        timed_fixpoint,
    )
    from graphmine_tpu_torch.parallel.mesh import make_mesh
    from graphmine_tpu_torch.parallel.sharded import (
        partition_graph,
        shard_graph_arrays,
        sharded_connected_components,
    )

    mesh = make_mesh(len(mesh_devices), devices=mesh_devices)
    virt = _virtual(mesh.devices)
    with m.timed("partition", shards=mesh.size, schedule="replicated", **virt):
        sg = shard_graph_arrays(partition_graph(graph, mesh=mesh), mesh)
    (cc, tele), secs, cold = timed_fixpoint(
        lambda: sharded_connected_components(sg, mesh, telemetry=True))
    emit_superstep_timing(
        m, "cc_superstep",
        sharded_superstep_cost("cc_superstep", sg, graph.num_edges,
                               num_messages=graph.num_messages, weighted=False),
        tele.iterations, tele.iterations, secs, graph.num_edges, variant="sharded",
        cold_compile=cold, **virt)
    return cc, tele.iterations


def main(argv=None) -> None:
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
