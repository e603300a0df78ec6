"""The JAX package's distributed example, on one mesh of the port.

``examples/distributed_scale.py`` of the JAX package runs the whole
``parallel`` surface after ``initialize_distributed``: the mesh, the
replicated LPA on each shard body, CC, the ring LPA, PageRank on both
schedules, the source-sharded PPR, the ring kNN and LOF, then a sharded
checkpoint saved, loaded and resumed on half the shards. :func:`run_flow`
is that flow on any :class:`~graphmine_tpu_torch.parallel.mesh.Mesh`: an
in-process one, or a process mesh whose shards are the ranks of a world,
in which case every rank calls it and gets the same results back.

Run it across processes (one shard a rank; ranks sharing one card need
``GRAPHMINE_VIRTUAL_DEVICES`` set to their count)::

    torchrun --nproc-per-node 4 -m graphmine_tpu_torch.parallel.distributed_flow --out DIR

Each rank writes its results to ``DIR/rank<r>.npz`` and the seconds it
took to join the world and to run the flow to ``DIR/rank<r>.json``;
``--device cpu`` runs a gloo world on the host.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

# the flow's fixed sizes: the supersteps, the power iterations, the kNN's
# k and the PPR sources (ids taken modulo V)
LPA_ITERS = 5
PAGERANK_ITERS = 30
KNN_K = 16
PPR_SOURCES = (0, 7, 42, 99, 512)
FEATURES = 8


def flow_inputs(num_vertices: int, num_edges: int, seed: int) -> tuple:
    """``(src, dst, points)``: a planted-community graph and a normal
    ``[V, 8]`` float32 cloud, both from ``seed``."""
    from graphmine_tpu_torch import datasets

    src, dst, _, _ = datasets.planted_anomaly_graph(num_vertices, num_edges, seed=seed)
    points = np.random.default_rng(seed + 1).normal(size=(num_vertices, FEATURES))
    return src.astype(np.int32), dst.astype(np.int32), points.astype(np.float32)


def _smaller_mesh(mesh, n: int):
    """A 1-D mesh of the first ``n`` shards of ``mesh`` (on a process
    mesh the first ``n`` ranks; every rank builds it)."""
    from graphmine_tpu_torch.parallel.mesh import make_mesh

    if mesh.process:
        return make_mesh(n)
    return make_mesh(n, devices=mesh.devices[:n])


def run_flow(mesh, src, dst, num_vertices: int, points, checkpoint_dir: str) -> dict:
    """The example's flow on ``mesh`` (its graphs and points built on the
    mesh's home device): LPA on the sort, bucketed, blocked and 2-D bodies
    (the bucketed one with its tripwires armed and its telemetry), CC on
    the sort and 2-D bodies, ring LPA and CC, PageRank on both schedules,
    PPR, the ring kNN and LOF, then ``save_sharded`` of the bucketed
    labels, ``load_sharded`` and one superstep resumed on a mesh of
    ``min(2, D)`` shards. Returns the results as host arrays; ``resumed``
    only where this process holds a shard of the smaller mesh."""
    import torch

    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.degrees import out_degrees
    from graphmine_tpu_torch.parallel.knn import sharded_knn, sharded_lof
    from graphmine_tpu_torch.parallel.ppr import sharded_personalized_pagerank
    from graphmine_tpu_torch.parallel.ring import (
        ring_connected_components,
        ring_label_propagation,
        ring_pagerank,
    )
    from graphmine_tpu_torch.parallel.sharded import (
        partition_graph,
        shard_graph_arrays,
        sharded_connected_components,
        sharded_label_propagation,
        sharded_pagerank,
    )
    from graphmine_tpu_torch.pipeline.checkpoint import load_sharded, save_sharded

    def host(t):
        return t.cpu().numpy()

    home, v = mesh.home, int(num_vertices)
    g = build_graph(src, dst, num_vertices=v, device=home)
    gd = build_graph(src, dst, num_vertices=v, symmetric=False, device=home)

    def placed(graph, **kw):
        return shard_graph_arrays(partition_graph(graph, mesh=mesh, **kw), mesh)

    sort = placed(g)
    bodies = {"sort": sort, "bucketed": placed(g, build_bucket_plan=True),
              "blocked": placed(g, build_blocked_plan=True), "2d": placed(g, build_plan2d=True)}
    out = {}
    for name, sg in bodies.items():
        if name == "bucketed":
            labels, tele = sharded_label_propagation(sg, mesh, max_iter=LPA_ITERS,
                                                     tripwire_every=2, telemetry=True)
            out["lpa_changed"] = tele.labels_changed
            out["lpa_shard_changed"] = tele.shard_changed
        else:
            labels = sharded_label_propagation(sg, mesh, max_iter=LPA_ITERS)
        out[f"lpa_{name}"] = host(labels)
    cc, tele = sharded_connected_components(sort, mesh, tripwire_every=1, telemetry=True)
    out["cc"], out["cc_changed"] = host(cc), tele.labels_changed
    out["cc_iterations"] = np.asarray(tele.iterations)
    out["cc_2d"] = host(sharded_connected_components(bodies["2d"], mesh))
    out["ring_lpa"] = host(ring_label_propagation(sort, mesh, max_iter=LPA_ITERS))
    out["ring_cc"] = host(ring_connected_components(sort, mesh))
    sgd = placed(gd)
    od = out_degrees(gd)
    out["pagerank"] = host(sharded_pagerank(sgd, mesh, od, max_iter=PAGERANK_ITERS))
    out["ring_pagerank"] = host(ring_pagerank(sgd, mesh, od, max_iter=PAGERANK_ITERS))
    sources = [s % v for s in PPR_SOURCES]
    out["ppr"] = host(sharded_personalized_pagerank(gd, sources, mesh, max_iter=PAGERANK_ITERS))
    pts = torch.from_numpy(np.asarray(points, np.float32)).to(home)
    d2, idx = sharded_knn(pts, mesh, KNN_K)
    out["knn_d2"], out["knn_idx"] = host(d2), host(idx)
    out["lof"] = host(sharded_lof(pts, mesh, k=KNN_K, impl="exact"))

    save_sharded(checkpoint_dir, out["lpa_bucketed"], iteration=LPA_ITERS, mesh=mesh)
    restored, it = load_sharded(checkpoint_dir, mesh=mesh)
    out["restored"], out["restored_iteration"] = restored, np.asarray(it)
    smaller = _smaller_mesh(mesh, min(2, mesh.size))
    small_sg = shard_graph_arrays(partition_graph(g, mesh=smaller), smaller)
    if smaller.local:
        out["resumed"] = host(sharded_label_propagation(small_sg, smaller, max_iter=1,
                                                        init_labels=restored))
    return out


def main(argv=None) -> int:
    """One rank of a world: join it (``initialize_distributed``, the
    launcher's environment), run :func:`run_flow` on the mesh of every
    rank, write ``--out/rank<r>.npz`` (and the seconds to
    ``--out/rank<r>.json``) and leave the world."""
    import torch.distributed as dist

    from graphmine_tpu_torch.parallel.mesh import initialize_distributed, make_mesh, world

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory for rank<r>.npz")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--vertices", type=int, default=4096)
    ap.add_argument("--edges", type=int, default=60_000)
    ap.add_argument("--seed", type=int, default=9)
    ap.add_argument("--timeout-s", type=float, default=None,
                    help="the world's timeout, for the rendezvous and each collective "
                         "(default: initialize_distributed's)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if not initialize_distributed(device=args.device, initialization_timeout=args.timeout_s):
        raise SystemExit("no world to join: launch with torchrun (or set RANK, WORLD_SIZE, "
                         "MASTER_ADDR and MASTER_PORT)")
    try:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        t1 = time.perf_counter()
        src, dst, points = flow_inputs(args.vertices, args.edges, args.seed)
        results = run_flow(make_mesh(), src, dst, args.vertices, points,
                           str(out / "checkpoint"))
        w = world()
        np.savez(out / f"rank{w.rank}.npz", backend=np.asarray(w.backend),
                 virtual=np.asarray(w.virtual), world_size=np.asarray(w.size), **results)
        (out / f"rank{w.rank}.json").write_text(json.dumps(
            {"join_seconds": t1 - t0, "flow_seconds": time.perf_counter() - t1}))
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
