#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``graphmine_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3, then the kernel alone
    python3 chip_smoke.py --community-only # phases 1-3, then phase 8
    python3 chip_smoke.py --frames-only    # phases 1-3, then phase 9
    python3 chip_smoke.py --blocked-only   # phases 1-3, then phase 10
    python3 chip_smoke.py --mesh-only      # phases 1-3, then phase 11
    python3 chip_smoke.py --serve-mesh-only  # phases 1-3, then phase 12
    python3 chip_smoke.py --dist-only      # phases 1-3, then phase 13

In order, and failing on the first phase that fails:

1. prints the card's name and power limit (``nvidia-smi``) and turns TF32
   off for matrix products and cuDNN;
2. builds, at once, the kernel of the exact path from
   ``graphmine_tpu_torch/csrc/knn_topk.cu`` (``nvcc``) and the edge-list
   parser from ``csrc/graph_builder.cpp`` (the host C++ compiler), and
   prints both build times on the ``build_seconds`` line;
3. holds the kernel against its plain PyTorch version on the card: the
   fast instance (F <= 8, k <= 128) on tie-free normal clouds and on clouds
   of points on the integer grid [0, 4)^F, full of exact distance ties (one
   of 4,096 points and, in the full run, one at the main path's shape,
   262,144 x 8); the general instance at (4096, 8, 200), (4096, 8, 1024),
   (20000, 12, 64), (2000, 33, 300), on a [0, 4)^16 grid at k = 256, and at
   (4096, 8, 2000), whose keys live in device scratch: distances bit-equal
   (max_abs_err 0), kNN indices equal, ties included, rows ascending, self
   excluded;
4. runs the port's pipeline on the card and on the CPU on small planted
   graphs (4,096 vertices): unweighted with the exact kNN, with edge
   weights in quarters (sums exact in float32), with the IVF kNN, from a
   parquet file, with the exact kNN at lof_k = 200 (the kernel's general
   instance, its launch counts set to 0 before and read after), and with a
   snapshot publish: labels and recursive-LPA flags equal, CC labels
   equal, features within rtol 1e-5 / atol 1e-6, LOF within rtol 1e-4 on
   99.9% of vertices and 1e-2 on all (the features' last bits differ
   between the card's and the CPU's math libraries, and LOF amplifies a
   near-tie that rounds apart), the published store loaded back through
   the port's ``SnapshotStore`` under the graph's fingerprint, and the IVF
   run twice on the card bit-equal;
4b. drives the run harness on the same small graph, on the card and on
   the CPU, with a snapshot publish in every run: a preemption (a fatal
   fault at the third superstep, then a ``resume`` run), a corrupted
   current checkpoint (rollback, then completion), a poisoned label
   vector with ``tripwire_every_k=1`` (a ``tripwire`` record, a rollback,
   then completion), a hung superstep (a fault hook that sleeps, bounded
   by ``superstep_timeout_s``: ``watchdog_timeout`` with
   ``checkpointed=true``, then a resume) and a real
   ``torch.cuda.OutOfMemoryError`` at the second superstep (``degrade`` to
   ``single_sort``): labels, flags and CC labels equal to the
   uninterrupted run's and the CPU's, LOF within phase 4's tolerances;
5. drives the main path, the JAX package's default pipeline on the JAX
   e2e tier's input: ``run_pipeline`` on a parquet file of
   ``planted_anomaly_graph(1 << 18, 25_000_000, seed=9)`` written as
   ``bench.py`` writes it (dictionary-encoded ``_c1``/``_c2`` string
   columns of ``d<id>.example`` names) with the default config
   (``max_iter=5``, ``outlier_method="both"``, ``lof_k=128``,
   ``lof_impl="auto"``: the IVF index at this size), ``batch_rows=4_000_000``
   and ``snapshot_out`` in the work directory, the launch counts set to 0
   just before and read just after; prints the ``main_path`` line with the
   resolved LOF impl, any ``ivf_fallback``, the ``quarantine`` record, the
   CC count and giant component, the publish's seconds and bytes and the
   ``canary_score`` record (its probe runs ``knn_topk``: launches >= 1),
   after loading the store back under the graph's fingerprint;
5c. drives the main path again through the run harness at full width:
   the config from the port's ``parse_args`` on the JAX CLI's flags
   (:func:`harness_flags`: checkpoints every superstep, tripwires, the
   watchdog, a heartbeat, a Prometheus textfile, the metrics stream, a run
   id, a profiler trace of the LPA phase, a publish), with a transient
   error planted at the third superstep (retried in process) and a real
   ``torch.cuda.OutOfMemoryError`` at the first ``outliers_lof`` hit (the
   IVF family), after which the planner's exact rung runs ``knn_topk``;
   labels, flags and features bit-equal to phase 5's, LOF bit-equal to
   the exact scorer on phase 5's features, and the records, checkpoints,
   Prometheus file and trace as :func:`check_harness` lists; prints the
   ``harness`` line (:func:`harness_summary`);
5b. drives the weighted exact path on an edge list (native ingest): the
   same graph with a third column of weights
   ``default_rng(7).integers(1, 16, E) / 4``, ``edge_weight_col=2`` and
   ``lof_impl="exact"``, counts reset and read the same way; prints the
   ``weighted_path`` line (``launches.knn_topk`` >= 1);
6. holds the fast instance against its plain version at the shape 5b
   gave it (the pipeline's own feature matrix, whose duplicate rows tie;
   indices equal there too) and the general instance on normal clouds at
   (65536, 8, 256) and (65536, 16, 128), times each instance, the plain
   version and one library call (``cdist`` + ``topk``) with CUDA events
   (their ``kernels`` line, with the operations bound, and the unfused
   floors on a line of their own are printed after phase 11); then holds
   the IVF kNN of phase
   5's features and of clustered clouds with planted outliers (262,144 x 8
   at k = 128, and the JAX package's gate cloud, 20,000 x 8 at k = 32)
   against the kernel's exact kNN: |AUROC(IVF LOF) - AUROC(exact LOF)| <=
   0.005 and the same indices with TF32 allowed on all three, recall >=
   0.999 on the gate cloud (the recall at k = 128 is reported); prints the
   ``ivf`` line; the ``kernels`` entries carry phase 7's launches of
   their instance (``serving_launches``);
7. serves (between 5c and 5b, while phase 4's and phase 5's stores are
   on disk), the launch counts set to 0 just before each part and read
   just after: 7a, two ``SnapshotServer``s over copies of phase 4's
   4,096-vertex store, one on the card and one on the CPU, the same
   requests to both (``/healthz``, ``/vertex``, ``/neighbors``, ``/topk``,
   ``/explain``, a 257-id ``/query``, three deltas: insert-only,
   delete-only, mixed): bodies equal apart from timing fields, labels, CC
   labels, repair methods, iterations and versions equal, LOF within
   phase 4's tolerances, and a 150,000-row delta answered 503 with
   ``Retry-After`` and the state unchanged; 7b, a server on the card over
   phase 5's store (262,144 vertices, 25,007,860 edges): 256 single
   ``/vertex`` reads, 32 4,096-id ``/query`` posts drawn as ``bench.py``'s
   serve tier draws them, the LOF bootstrap delta, a delta of 0.05% of E
   (not a 0.2% one too: cut for the smoke's time limit), the shed, a reader
   posting ``/query`` throughout the
   applies (no error, every answer equal to the published snapshot of
   the version it names); every publish's CC labels equal a cold
   ``connected_components`` of its graph, a warm repair's labels are an
   LPA fixpoint, the version chain advances by one; ``knn_topk`` runs at
   least once a publish (the canary); then the apply's stages timed alone
   (:func:`serving_stage_times`); prints the ``serve`` line;
7c. (after 7b, on phase 4's store, the card against the CPU, correctness
   only) a ``serve --wal --device cuda`` process takes three deltas with
   ``X-Delta-Ack: wal`` and a duplicate ``X-Delta-Id``, is SIGKILLed right
   after the third 202 and restarted on the same store and log; a writer
   and its log-shipped standby (``--standby-of``, ``--primary-wal``), the
   writer SIGKILLed right after a 202, the standby promoted (a new epoch,
   then a write), and the deposed writer's publish refused at the store;
   a ``writer_shards = 2`` server on the card beside a ``writer_shards =
   1`` one on the CPU. Labels, CC labels, repair methods, iterations and
   versions equal the CPU server's fed the same deltas without a kill
   (LOF too where no writer restarted), nothing applied twice, the shard
   records present; prints the ``replicated`` line;
7d. on a copy of phase 4's store (not phase 5's: cut for the smoke's
   time limit), ``fleet_cli up --replicas 3 --standby --device
   cuda`` (writer, its standby, one read replica) behind the router, a
   reader posting ``/query`` through the router throughout: 256 ``/vertex``
   and 32 4,096-id ``/query`` through the router, 7b's 0.05% delta with
   ``X-Delta-Ack: wal`` (ms to the 202, seconds until the router serves
   it), a second delta and the writer SIGKILLed at once, the router's
   auto-promotion (seconds from the kill to a 202 on the promoted writer),
   a ``roll``; no reader error (the reader obeys 503 + Retry-After), every
   answer equal to the captured snapshot of its version, the committed
   version never going back, no acknowledged delta lost, every captured
   version's CC equal to a cold recompute; prints the ``fleet`` line with
   each process's peak device bytes (``/statusz``) and ``nvidia-smi``'s
   per-process use. The replicas' ``canary_score`` records (one
   ``knn_topk`` launch each) join the ``kernels`` line's
   ``serving_launches``; every process a part starts is stopped when it
   ends, pass or fail;
8. (after phase 6) Louvain and Leiden, and the graph-ops surface: 8a, on
   phase 4's graph, ``run_pipeline`` with ``community_method`` "louvain"
   and "leiden", ``lof_impl="exact"``, unweighted and in quarter weights,
   on the card and on the CPU: labels, community counts and
   recursive-LPA flags equal, Q (float32) within 1e-6, LOF within phase
   4's tolerances; the unweighted Louvain run's store loaded back under the
   graph's fingerprint; then every op of the surface (degrees, BFS and its
   parents and paths, 16-landmark shortest paths, weighted shortest paths,
   SCC, k-core, ``aggregate_messages``, five ``pregel`` supersteps, a motif,
   assortativity, reciprocity, density, diameter, ARI and NMI) on that
   graph, card against CPU: integer outputs equal, floats within rtol 1e-5
   / atol 1e-6 (float sums reduce in another order on each device); prints
   the ``community_small`` line. 8b, on phase 5's parquet file with phase
   5's ``batch_rows``: ``run_pipeline`` with ``community_method="leiden"``
   and ``lof_impl="exact"`` (the fast instance at its full shape: launches
   >= 1), then ``louvain`` on its graph; prints the ``community`` line
   (wall and phase seconds, Q, communities, the largest, peak device
   bytes, Louvain's seconds and Q); then every op once on its graph's
   first quarter of the edges (cut from all of them for the smoke's time
   limit; directed where the op reads direction, BFS from
   vertex 0), held to its
   own invariants; prints the ``ops`` line with each op's seconds;
9. (after phase 8) the GraphFrames entry point: 9a, on phase 4's graph,
   ``GraphFrame`` on the card and on the CPU runs PageRank (plain, with
   the quarter weights, with a seeded ``reset``), PPR from 8 sources,
   HITS, eigenvector and Katz (``tol=0``, a fixed iteration count, so the
   stop rule cannot land the two devices an iteration apart), closeness
   from 16 landmarks, exact betweenness, MIS and ``greedy_color`` (seed
   0), ``k_truss(4)``, the five link-prediction scores of 4,096 seeded
   pairs, ``spectral_embedding(dim=8)``, SVD++ on seeded 1-5 ratings from
   one seeded ``init`` and ``lof_scores(k=20, lof_impl="exact")``:
   integers equal, floats within rtol 1e-5 / atol 1e-6, the embedding's
   columns |cos| >= 0.9999 after sign alignment, LOF within phase 4's
   tolerances; then the pyspark script :data:`SHIM_SCRIPT` (parquet read,
   renames, the null filter, the RDD vertex dictionary, a per-row UDF,
   ``GraphFrame(v, e)``, ``labelPropagation(maxIter=5)``, ``pageRank``,
   the census loop) through ``python -m graphmine_tpu_torch.compat
   --device cuda`` and ``--device cpu`` on a CommonCrawl-shaped ``_c0..
   _c3`` parquet of phase 4's graph with null-domain rows: stdout
   identical; prints the ``frames_small`` line. 9b, on phase 5's parquet
   file with phase 5's ``batch_rows`` (phase 5's own loaded table in the
   full run), its first quarter of the edges (cut from all of them for
   the smoke's time limit): ``GraphFrame.from_edge_table`` on the
   card, then each op once, held to its own invariants (PageRank sums to
   1 and equals a CPU run within rtol 1e-4; MIS independent and maximal
   and the colouring proper over every message; each of 4,096 sampled
   ``k_truss(4)`` edges in two kept triangles; link prediction of 250,000
   pairs (cut from 1,000,000) against each formula on a sample;
   orthonormal embedding columns; SVD++'s RMSE falls; ``lof_scores(k=20,
   lof_impl="exact")`` launches ``knn_topk``'s fast instance); prints the
   ``frames`` line with each op's seconds. 9c, the shim at scale: the
   same script on ``planted_anomaly_graph(1 << 16, 500_000, seed=9)``
   (cut from 1,000,000 rows) written CommonCrawl-shaped with 64
   null-domain rows, through the shim
   on the card; its LPA partition equals the ``GraphFrame`` API's on the
   same file, name by name; prints the ``compat`` line; the ``kernels``
   entries of phase 6 carry phase 9's launches of their instance
   (``frames_launches``);
10. the blocked superstep family: 10a
   (:func:`blocked_small`) on phase 4's graph, unweighted and in quarter
   weights, ~60 bins: the plan built on the card equal to the CPU's array
   for array, every LPA and CC superstep card == CPU == the bucketed
   superstep on the card, ``blocked_inflow`` and PageRank on a
   ``BlockedPlan`` card against CPU within rtol 1e-5, ``run_pipeline``
   with ``GRAPHMINE_SUPERSTEP_FAMILY=blocked`` against the bucketed
   default (labels, flags, census equal, LOF within phase 4's
   tolerances) and the same run with a real out-of-memory error at
   superstep 3, which takes the ``single_bucketed`` rung and ends on the
   same labels; prints the ``blocked_small`` line. 10b
   (:func:`blocked_rung`): ``datasets.load("com-livejournal", seed=0)``
   on the host (its R-MAT stand-in: 4M vertices, 34,812,723 edges), both
   plans on the card: 5 LPA supersteps a family, labels bit-equal; CC to
   the fixpoint a family, labels and superstep counts equal; PageRank 20
   iterations on the directed graph, blocked against the segment path, L1
   <= 1e-5 and max relative <= 1e-4; prints the ``blocked`` line. 10c
   (:func:`blocked_ladder`): R-MAT graphs at edge factor 8.3, scales 20 to
   24, drawn on the card: the median of 5 supersteps of each family after
   a warm-up (labels equal each time), the bin pass's slots/s against a
   random gather's on the same M slots, each family's peak bytes; at scale
   22 the bin budget swept over 2^16, 2^18 and 2^20; prints the
   ``blocked_ladder`` line (with the crossover scale, None when blocked
   never wins from a scale on) and the phase's seconds;
11. the multi-device pipeline on a virtual mesh (``GRAPHMINE_VIRTUAL_DEVICES``:
   the shards share the card, so every exchange is a copy inside it):
   11a (:func:`mesh_small`) on phase 4's graph at D = 1, 2 and 4, card
   against CPU: the partition arrays equal, sharded and ring LPA
   (unweighted and in quarter weights), CC with its superstep count and
   the sharded recursive-LPA flags equal to the single-device ops,
   sharded and ring PageRank within L1 1e-5 and max relative 1e-4, the
   sharded kNN's distances within rtol 1e-5 of ``knn_topk`` with 0 index
   mismatches on a tie-free cloud, the sharded LOF within phase 4's
   tolerance; a D = 4 checkpoint resumed at D = 2 and a device loss at
   superstep 3 (4 -> 2, one ``mesh_degrade`` record) give the labels of
   an uninterrupted run; prints the ``mesh_small`` line. 11b
   (:func:`mesh_full`): on phase 5's graph (from its store; phase 5 is
   the D = 1 pipeline; the 4-shard pipelines at this size are left to
   11c, for the smoke's time limit, and 11a holds both schedules' pipelines card ==
   CPU), each schedule's superstep at D = 1 and 4 (median of 5 after a
   warm-up, partition seconds, peak bytes beside the model's) and the
   ring kNN at D = 1 beside ``knn_topk``; prints the
   ``mesh`` line. 11c (:func:`mesh_scale_out`): phase 5's parquet
   through ``run_pipeline`` at 4 shards with ``GRAPHMINE_HBM_BYTES``
   between the planner's replicated and single-device estimates: the
   ``scale_out`` record, ``host-8-sampled`` features, the sharded
   recursive outliers, LOF through the sharded scorer (IVF on the mesh)
   equal to one device's on the same features, and a store whose labels and
   CC equal phase 5's, the launch counts set to 0 just before and read
   just after; prints the ``mesh_scale_out`` line and the phase's
   seconds;
12. the serving plane's sharded repair on a virtual mesh of 4 shards:
   12a (:func:`serve_mesh_small`) on phase 4's store, 7a's three deltas
   through ``DeltaIngestor(num_shards=4)`` with the ``sort`` family forced
   and with ``sharded_2d``, on the card, and on the CPU in a child process
   that runs beside the card's 12a and 12b's repair together with the
   single-shard ingestor: the two families' publishes equal on each
   device and on the CPU equal to the single-shard ingestor's (labels, CC
   labels, edges, LOF within phase 4's tolerances, versions, methods, and
   iterations for ``sort``), the card's equal to the CPU's (iterations,
   families and ``shard_exchange`` records too); ``knn_topk`` launched by
   the sharded ingestors' LOF refresh (the launch counts set to 0 just
   before them and read just after); a
   pre-degrade under ``GRAPHMINE_HBM_BYTES=512`` (the
   ``degrade`` record, the ``sort`` family, the same publish); one delta
   over HTTP through ``SnapshotServer(num_shards=2)``; the source-sharded
   PPR and betweenness against the single-device ops within rtol 1e-5 /
   atol 1e-7; prints the ``serve_mesh_small`` line. 12b on phase 5's
   graph (50,015,720 messages) at 4 shards: first, beside 12a's CPU side,
   a delta of 0.05% of E repaired by ``repair_labels`` and by the sharded
   ingestor's ``_repair`` for ``sort`` and ``sharded_2d``
   (:func:`serve_mesh_repair`: labels, CC and method equal, iterations for
   ``sort``); then, once the child has finished, for the replicated
   bucketed, the blocked and the 2-D partition (:func:`serve_mesh_full`),
   the partition's seconds, 5 LPA supersteps equal to phase 5's labels, CC
   to its fixpoint equal to phase 5's, the median of 5 single LPA and CC
   supersteps after a warm-up, peak bytes beside the memory model's and
   the ``shard_exchange`` record's modeled bytes per superstep; prints the
   ``serve_mesh`` line and the phase's seconds. The ``kernels`` line of
   phase 6 follows phase 13, its entries carrying phase 11c's launches
   (``mesh_launches``) and 12a's (``serve_mesh_launches``; phase 13
   launches no kernel: the ring kNN's hop is plain). Every time on a
   virtual mesh is marked ``virtual``;
13. the multi-process mesh (:func:`run_dist`): 13a runs the JAX
   package's distributed example flow
   (``graphmine_tpu_torch/parallel/distributed_flow.py``) on phase 11's
   4,096-vertex graph in a 1-rank NCCL world and in 2- and 4-rank worlds
   sharing the card (virtual, gloo), every rank's results equal to each
   other's and to the in-process mesh of the same size on the card, and
   that mesh's equal to the CPU's (a child process; PageRank and PPR
   within L1 1e-5, LOF within phase 4's tolerance); on a host of several
   cards a world (and an in-process mesh) takes a card a rank, over NCCL,
   while the cards last; 13b runs phase 5's
   graph on 2 ranks sharing the card: 5 LPA supersteps and CC equal to
   phase 5's, the median of 5 single supersteps and of 5 all-gathers,
   the partition's seconds and each rank's peak bytes. A world whose rank
   fails or that times out is killed and fails the phase. Prints the
   ``dist`` line and the phase's seconds, then the ``kernels`` line;
14. prints the smoke's total seconds, the card line again and the last
   line, ``{"ok": true, "device": {...}}``.

``--kernels-only`` skips the pipelines: after phase 3 it holds and times
the fast instance at the main path's shape (262,144 x 8, k = 128) on a
normal cloud (the ``kernels`` entry, with its plain and library times), on
the [0, 4)^8 grid cloud and on a constant cloud (every distance 0, so each
row inserts only its first k candidates: the kernel's time with next to no
top-k work), and the general instance at phase 6's shapes, then prints the
``kernels`` line, the floor line and the last line.

It exits non-zero, printing no result, where CUDA is absent or where the
port's package is not beside this file.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parent

V_MAIN = 1 << 18
E_MAIN = 25_000_000
SEED_MAIN = 9
LOF_K = 128
PARITY_CASES = ((130, 4, 3), (513, 3, 20), (2000, 5, 50), (4096, 8, 8), (4096, 8, 128),
                (65536, 8, 128))
TIED_CASE = (4096, 8, 128)  # integer points in [0, 4)^8: most distances tie
FULL_SHAPE = (V_MAIN, 8, LOF_K)  # the kNN's shape on the main path
# The general instance (F <= 64, keys beside its ring): normal clouds and a
# [0, 4)^16 grid at k = 256; then each rows-a-warp choice with the queries
# in registers (F <= 8) and in shared memory, at N off a whole tile, F = 1
# and F = 64 among them, and a [0, 4)^8 grid at k = 256.
GENERAL_CASES = ((4096, 8, 200), (4096, 8, 1024), (20000, 12, 64), (2000, 33, 300))
GENERAL_TIED_CASE = (4096, 16, 256)
GENERAL_PLAN_CASES = ((3001, 1, 130), (2500, 5, 300), (3001, 3, 600), (3001, 8, 1300),
                      (3001, 16, 100), (3001, 64, 150), (3001, 24, 350), (3001, 40, 500),
                      (3001, 64, 1300))
GENERAL_GRID_CASE = (4096, 8, 256)
# The wide instance (F > 64, or keys too many for the general one): F = 65,
# and keys in device scratch.
WIDE_CASE = (3001, 65, 150)
GLOBAL_SCRATCH_CASE = (4096, 8, 2000)
GENERAL_TIMED = ((65536, 8, 256), (65536, 16, 128), (V_MAIN, 8, 256))
WIDE_TIMED = (65536, 65, 128)
SMALL_LOF_K = 32
WIDE_LOF_K = 200  # phase 4's exact run past the fast instance's k: the general instance
WIDEST_LOF_K = 1500  # phase 4's exact run past the general instance's keys: the wide one
BATCH_ROWS = 4_000_000  # the JAX e2e tier's streaming batch
# The IVF gates of the JAX package's LOF policy tests
IVF_MIN_RECALL = 0.999
IVF_MAX_DELTA_AUROC = 0.005

# One H100 SXM (the published dense peaks at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
HARNESS_RUN_ID = "smoke-5c"
HARNESS_TIMEOUT_S = 2.0  # phase 4b's watchdog bound (a superstep there takes ms)
KNN_SOURCE = "graphmine_tpu_torch/csrc/knn_topk.cu"
KNN_REPLACES = "graphmine_tpu/pallas_kernels/knn_pallas.py:117"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Chip smoke of graphmine_tpu_torch on one GPU.")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernels-only", action="store_true",
                      help="phases 1-3, then the kernel alone at the main path's shape")
    mode.add_argument("--community-only", action="store_true",
                      help="phases 1-3, then phase 8 (Louvain, Leiden and the graph ops)")
    mode.add_argument("--frames-only", action="store_true",
                      help="phases 1-3, then phase 9 (the GraphFrames entry point)")
    mode.add_argument("--blocked-only", action="store_true",
                      help="phases 1-3, then phase 10 (the blocked superstep family)")
    mode.add_argument("--mesh-only", action="store_true",
                      help="phases 1-3, then phase 11 (the multi-device pipeline on a "
                           "virtual mesh)")
    mode.add_argument("--serve-mesh-only", action="store_true",
                      help="phases 1-3, then phase 12 (the serving plane's sharded repair "
                           "on a virtual mesh)")
    mode.add_argument("--dist-only", action="store_true",
                      help="phases 1-3, then phase 13 (the multi-process mesh)")
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _digits(x: np.ndarray, width: int, pad: int = ord(" ")) -> np.ndarray:
    """``[len(x), width]`` ASCII digits of non-negative integers,
    right-aligned, padded on the left with ``pad``."""
    out = np.full((len(x), width), pad, np.uint8)
    v = x.astype(np.int64)
    for c in range(width - 1, -1, -1):
        out[:, c] = np.where((v > 0) | (c == width - 1), v % 10 + ord("0"), pad)
        v = v // 10
    return out


def write_edge_list(path: Path, src: np.ndarray, dst: np.ndarray,
                    weights: np.ndarray | None = None) -> None:
    """Whitespace edge list ``src dst [weight]`` per line, formatted with
    NumPy in bulk (ids right-aligned in a fixed width, padded with spaces;
    weights, which must be non-negative multiples of 0.01, as
    ``<int>.<2 digits>``)."""
    width = len(str(int(max(src.max(initial=0), dst.max(initial=0)))))
    col = lambda c: np.full((len(src), 1), ord(c), np.uint8)
    parts = [_digits(src, width), col(" "), _digits(dst, width)]
    if weights is not None:
        cents = np.rint(np.asarray(weights, np.float64) * 100).astype(np.int64)
        if (cents < 0).any() or not np.array_equal(cents / 100, np.asarray(weights, np.float64)):
            raise ValueError("weights must be non-negative multiples of 0.01")
        w_width = len(str(int(cents.max(initial=0) // 100)))
        parts += [col(" "), _digits(cents // 100, w_width), col("."),
                  _digits(cents % 100, 2, pad=ord("0"))]
    path.write_bytes(np.concatenate(parts + [col("\n")], axis=1).tobytes())


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card over ``reps`` runs, after
    one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def check_knn(pts, k: int, d_k, i_k, d_p, i_p) -> dict:
    """Hold the kernel's kNN (``d_k, i_k``) against the plain version's.

    Distances must be bit-equal (max_abs_err 0) and every row ascending,
    in range and free of self. Indices must be equal, ties included: both
    compute the same float32 operations in the same order and send ties
    to the smaller index."""
    import torch

    n = pts.shape[0]
    require(d_k.shape == i_k.shape == (n, k), f"kernel output shape {tuple(d_k.shape)}")
    require(d_k.dtype == torch.float32 and i_k.dtype == torch.int32, "kernel output types")
    require(bool(torch.isfinite(d_k).all()), "kernel distances not finite")
    err = (d_k - d_p).abs()
    require(torch.equal(d_k.view(torch.int32), d_p.view(torch.int32)),
            f"distances differ by up to {float(err.max())}")
    require(bool((d_k[:, 1:] >= d_k[:, :-1]).all()), "kernel rows not ascending")
    require(bool(((i_k >= 0) & (i_k < n)).all()), "kernel index out of range")
    rows = torch.arange(n, device=pts.device)[:, None]
    require(not bool((i_k == rows).any()), "kernel row holds itself")
    mismatches = int((i_k != i_p.to(i_k.dtype)).sum())
    require(mismatches == 0, f"{mismatches} kernel indices differ from the plain version's")
    return {"max_abs_err": float(err.max()), "index_mismatches": mismatches}


def knn_work(n: int, f: int, k: int) -> tuple[float, int]:
    """Float32 operations and bytes of the exact kNN of ``n`` points of ``f``
    features: every off-diagonal pair costs 2f+3 operations (f products and
    f-1 sums for the cross term, the doubling, the two norm terms and the
    clamp), and the points are read once and ``[n, k]`` distances and int32
    indices written once."""
    return float(n) * (n - 1) * (2 * f + 3), n * f * 4 + n * k * (4 + 4)


def knn_bound_ms(n: int, f: int, k: int) -> tuple[float, str]:
    """Least time one H100 could take for :func:`knn_work` at its published
    float32 peak and memory rate, and which of the two binds.

    The 67 TFLOP/s peak counts a fused multiply-add as two operations. The
    kernel may not fuse: its distances must be bit-equal to the plain
    version's, which rounds every product and sum on its own. Each of its
    operations is then one instruction, at half that rate: see
    :func:`knn_unfused_floor_ms`, twice this bound where operations bind."""
    ops, moved = knn_work(n, f, k)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, moved / PEAK_HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def knn_unfused_floor_ms(n: int, f: int, k: int) -> float:
    """Least time of :func:`knn_work` at one float32 instruction per
    operation (no fused multiply-add: half the 67 TFLOP/s peak), the floor
    of any kernel bit-equal to the plain version."""
    ops, moved = knn_work(n, f, k)
    return 1e3 * max(ops / (PEAK_FP32_FLOPS / 2), moved / PEAK_HBM_BYTES_PER_S)


def library_knn(pts, k: int, row_tile: int = 4096):
    """One PyTorch library call per row tile (``cdist`` + ``topk``), the
    yardstick of the kernel's speed; the port never calls it."""
    import torch

    n = pts.shape[0]
    out_d = torch.empty((n, k), dtype=torch.float32, device=pts.device)
    out_i = torch.empty((n, k), dtype=torch.int64, device=pts.device)
    for r0 in range(0, n, row_tile):
        r1 = min(r0 + row_tile, n)
        d = torch.cdist(pts[r0:r1], pts)
        d[torch.arange(r1 - r0, device=pts.device), torch.arange(r0, r1, device=pts.device)] = float("inf")
        top = torch.topk(d, k, dim=1, largest=False)
        out_d[r0:r1], out_i[r0:r1] = top.values, top.indices
    return out_d, out_i


def hold(pts, k: int) -> dict:
    """The kernel held against its plain version on ``pts`` (see
    :func:`check_knn`), with the instance that ran."""
    import torch

    from graphmine_tpu_torch.kernels import knn_cuda
    from graphmine_tpu_torch.ops.knn import _tiled_knn

    d_k, i_k = knn_cuda.knn_topk(pts, k)
    d_p, i_p = _tiled_knn(pts, k)
    torch.cuda.synchronize()
    plan = knn_cuda.launch_plan(pts.shape[0], pts.shape[1], k)
    return {**check_knn(pts, k, d_k, i_k, d_p, i_p),
            **{key: plan[key]
               for key in ("instance", "topk", "queries", "rows_per_warp", "stages")}}


def wide_beside(pts, k: int) -> dict:
    """The wide instance, which the general one replaced at its shapes, on
    the same ``pts`` as a general entry, in the same call: its parity
    against the plain version and its mean milliseconds over 5 launches."""
    import torch

    from graphmine_tpu_torch.kernels import knn_cuda
    from graphmine_tpu_torch.ops.knn import _tiled_knn

    plan = knn_cuda.wide_plan(pts.shape[0], pts.shape[1], k)
    d_k, i_k = knn_cuda.run_plan(pts, k, plan)
    d_p, i_p = _tiled_knn(pts, k)
    torch.cuda.synchronize()
    parity = check_knn(pts, k, d_k, i_k, d_p, i_p)
    ms = cuda_ms(lambda: knn_cuda.run_plan(pts, k, plan), reps=5)
    return {"wide_ms": ms, "wide_max_abs_err": parity["max_abs_err"],
            "wide_index_mismatches": parity["index_mismatches"]}


def kernel_ms(pts, k: int) -> float:
    """The kernel's mean milliseconds on ``pts`` over 5 launches."""
    from graphmine_tpu_torch.kernels import knn_cuda

    return cuda_ms(lambda: knn_cuda.knn_topk(pts, k), reps=5)


def kernel_entry(pts, k: int, cloud: str, launches) -> dict:
    """The ``kernels`` line's entry for ``knn_topk`` on ``pts``: the
    instance, parity, the kernel's, the plain version's and the library
    call's times, and the bound."""
    from graphmine_tpu_torch.ops.knn import _tiled_knn

    n, f = pts.shape
    parity, ms = hold(pts, k), kernel_ms(pts, k)
    log(f"knn_topk on the {cloud} cloud n={n} f={f} k={k}: {parity}, {ms:.3f} ms")
    plain_ms = cuda_ms(lambda: _tiled_knn(pts, k), reps=1)
    library_ms = cuda_ms(lambda: library_knn(pts, k), reps=1)
    bound_ms, bound_by = knn_bound_ms(n, f, k)
    return {
        "name": "knn_topk", "instance": parity["instance"], "route": "cuda",
        "source": KNN_SOURCE, "replaces": KNN_REPLACES,
        "cloud": cloud, "shape": {"n": n, "f": f, "k": k}, "launches": launches,
        "max_abs_err": parity["max_abs_err"], "index_mismatches": parity["index_mismatches"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms,
    }


def true_d2(pts, idx, row_tile: int = 8192):
    """Float64 squared distances from each row of ``pts`` to the points
    ``idx [N, k]`` names, recomputed from the coordinates."""
    import torch

    out = torch.empty(idx.shape, dtype=torch.float64, device=pts.device)
    p64 = pts.to(torch.float64)
    for r0 in range(0, idx.shape[0], row_tile):
        diff = p64[r0:r0 + row_tile, None, :] - p64[idx[r0:r0 + row_tile].long()]
        out[r0:r0 + row_tile] = (diff * diff).sum(-1)
    return out


def ivf_quality(pts, k: int, exact, ivf, is_outlier, min_recall: float | None = IVF_MIN_RECALL,
                row_tile: int = 8192) -> dict:
    """Hold an approximate kNN ``ivf = (d2, idx)`` against the exact one.

    ``recall``: the share of IVF neighbours no farther than the exact k-th
    neighbour (distances recomputed in float64 from the points, with a
    relative slack of 1e-5), so a tied neighbour the exact kNN left out
    counts as found; ``index_recall``: the plain share of exact indices
    found. ``delta_auroc``: AUROC of the IVF kNN's LOF minus the exact
    one's on ``is_outlier``. Rows must hold k distinct in-range points other
    than themselves. Fails above |delta| 0.005, and below ``min_recall``
    unless it is ``None``."""
    import torch

    from graphmine_tpu_torch.ops.lof import auroc, lof_from_knn

    (d_e, i_e), (d_i, i_i) = exact, ivf
    n = pts.shape[0]
    require(i_i.shape == i_e.shape == (n, k), f"IVF output shape {tuple(i_i.shape)}")
    require(bool(torch.isfinite(d_i).all()), "IVF distances not finite")
    require(bool(((i_i >= 0) & (i_i < n)).all()), "IVF index out of range")
    require(not bool((i_i == torch.arange(n, device=i_i.device)[:, None]).any()),
            "IVF row holds itself")
    srt = torch.sort(i_i, dim=1).values
    require(not bool((srt[:, 1:] == srt[:, :-1]).any()), "IVF row repeats a neighbour")
    kth = true_d2(pts, i_e, row_tile).max(dim=1).values
    hits = true_d2(pts, i_i, row_tile) <= kth[:, None] * (1 + 1e-5)
    found = sum(int((i_i[r0:r0 + row_tile, :, None] == i_e[r0:r0 + row_tile, None, :]).any(-1).sum())
                for r0 in range(0, n, row_tile))
    a_e = auroc(lof_from_knn(d_e, i_e, k).cpu().numpy(), is_outlier)
    a_i = auroc(lof_from_knn(d_i, i_i, k).cpu().numpy(), is_outlier)
    q = {"recall": float(hits.double().mean()), "index_recall": found / (n * k),
         "auroc_exact": a_e, "auroc_ivf": a_i, "delta_auroc": a_i - a_e}
    log(f"IVF against exact: {q}")
    require(min_recall is None or q["recall"] >= min_recall,
            f"IVF recall {q['recall']} < {min_recall}")
    require(abs(q["delta_auroc"]) <= IVF_MAX_DELTA_AUROC,
            f"IVF AUROC moved by {q['delta_auroc']} (> {IVF_MAX_DELTA_AUROC})")
    return q


def blob_cloud(n: int, f: int = 8, seed: int = 42):
    """Clustered cloud with planted shell outliers, the kind the JAX
    package's LOF policy tests gate the IVF index on: 16 Gaussian blobs,
    and 1% of points moved to a shell 4-6 from their blob's center."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(16, f)).astype(np.float32) * 4
    assign = rng.integers(0, 16, n)
    pts = centers[assign] + rng.normal(size=(n, f)).astype(np.float32)
    is_out = rng.random(n) < 0.01
    n_out = int(is_out.sum())
    d = rng.normal(size=(n_out, f)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts[is_out] = centers[assign[is_out]] + d * rng.uniform(4.0, 6.0, (n_out, 1)).astype(np.float32)
    return pts, is_out


def floor_key(entry: dict) -> str:
    """``"<name> <instance> n=.. f=.. k=.."``: an entry's key on the floor
    line."""
    sh = entry["shape"]
    return f"{entry['name']} {entry['instance']} n={sh['n']} f={sh['f']} k={sh['k']}"


def with_serving_launches(entries: list, serve_launches: dict) -> list:
    """The ``kernels`` entries, each with phase 7's launch count of its
    instance (``serving_launches``; ``launches`` stays the main path's)."""
    return [{**e, "serving_launches": serve_launches[f"knn_topk_{e['instance']}"]}
            for e in entries]


def print_kernels(entries: list) -> None:
    """The ``kernels`` line, then each entry's unfused floor (computed from
    its shape, not measured) on a line of its own."""
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"unfused_floor_ms": {
        floor_key(e): knn_unfused_floor_ms(e["shape"]["n"], e["shape"]["f"], e["shape"]["k"])
        for e in entries}}), flush=True)


def general_entries(launches, constant: bool = False, features=None) -> list:
    """The ``kernels`` entries of the general instance at
    :data:`GENERAL_TIMED` (seeded normal clouds; ``features``, the weighted
    path's, at its own shape where given), each with the wide instance on
    the same points (:func:`wide_beside`); ``launches``: the general
    instance's count in phase 4's lof_k = 200 run, or None. With
    ``constant``, each entry also holds and times the kernel on a constant
    cloud (every distance 0: each row inserts only its first k candidates,
    so the time is the distance stream's with next to no top-k work)."""
    import torch

    rng = np.random.default_rng(6)
    out = []
    for n, f, k in GENERAL_TIMED:
        pts = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).cuda()
        cloud = "normal"
        if features is not None and tuple(features.shape) == (n, f):
            pts, cloud = features, "weighted_path_features"
        out.append({**kernel_entry(pts, k, cloud, launches), **wide_beside(pts, k)})
        require(out[-1]["instance"] == "general", f"({n}, {f}, {k}) did not run the general instance")
        log(f"the wide instance on the same points: {out[-1]['wide_ms']:.3f} ms")
        if constant:
            pts = torch.ones((n, f), dtype=torch.float32, device="cuda")
            parity, ms = hold(pts, k), kernel_ms(pts, k)
            log(f"knn_topk on the constant cloud n={n} f={f} k={k}: {parity}, {ms:.3f} ms")
            out[-1]["other_clouds"] = [{"cloud": "constant", "ms": ms, **parity}]
        del pts
    return out


def wide_entry(launches) -> dict:
    """The ``kernels`` entry of the wide instance at :data:`WIDE_TIMED` on a
    seeded normal cloud; ``launches``: its count in phase 4's lof_k = 1500
    run, or None."""
    import torch

    n, f, k = WIDE_TIMED
    pts = torch.from_numpy(np.random.default_rng(8).normal(size=(n, f)).astype(np.float32)).cuda()
    entry = kernel_entry(pts, k, "normal", launches)
    require(entry["instance"] == "wide", f"({n}, {f}, {k}) did not run the wide instance")
    return entry


def write_parquet(path: Path, src: np.ndarray, dst: np.ndarray, num_vertices: int) -> None:
    """An outlinks parquet file as ``bench.py``'s e2e tier writes one:
    ``_c1``/``_c2`` string columns of ``d<id:07d>.example`` names,
    dictionary-encoded on disk."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    names = pa.array([f"d{i:07d}.example" for i in range(num_vertices)])
    col = lambda ids: pa.DictionaryArray.from_arrays(pa.array(ids, pa.int32()),
                                                     names).cast(pa.string())
    pq.write_table(pa.table({"_c1": col(src), "_c2": col(dst)}), path)


def generator_ids(names: np.ndarray) -> np.ndarray:
    """The generator's vertex ids behind the loaded names: integers as
    they are, ``d<id>.example`` parquet names by their digits."""
    if len(names) and isinstance(names[0], str) and names[0].startswith("d"):
        return np.array([int(s[1:8]) for s in names], np.int64)
    return names.astype(np.int64)


def main(argv=None) -> int:
    t_start = time.perf_counter()
    args = parse_args(argv)
    if not (ROOT / "graphmine_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no graphmine_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke runs on the card only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    # ---- 1. the card ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(smi, flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    from graphmine_tpu_torch.io import native
    from graphmine_tpu_torch.kernels import knn_cuda

    # ---- 2. build: the kernel and the parser, at once --------------------
    with ThreadPoolExecutor(2) as pool:
        knn_job = pool.submit(knn_cuda.build, verbose=True)
        parser_job = pool.submit(native.build)
        build_s, parser_s = knn_job.result(), parser_job.result()
    log(f"kernel built in {build_s:.2f} s, parser in {parser_s:.2f} s")
    print(json.dumps({"build_seconds": build_s, "parser_build_seconds": parser_s}), flush=True)

    # ---- 3. kernel against plain version: tie-free clouds, tied grids ---
    rng, rng_plans = np.random.default_rng(0), np.random.default_rng(1)
    normal = lambda n, f, g=rng: g.normal(size=(n, f))
    grid = lambda n, f, g=rng: g.integers(0, 4, size=(n, f))
    # (points, k, cloud, the instance the shape must run)
    clouds = [(normal(n, f), k, "normal", "fast") for n, f, k in PARITY_CASES]
    clouds.append((grid(*TIED_CASE[:2]), TIED_CASE[2], "grid", "fast"))
    if not args.kernels_only:  # --kernels-only holds this one in its own phase
        clouds.append((grid(*FULL_SHAPE[:2]), FULL_SHAPE[2], "grid", "fast"))
    clouds += [(normal(n, f), k, "normal", "general") for n, f, k in GENERAL_CASES]
    clouds.append((grid(*GENERAL_TIED_CASE[:2]), GENERAL_TIED_CASE[2], "grid", "general"))
    clouds.append((normal(*GLOBAL_SCRATCH_CASE[:2]), GLOBAL_SCRATCH_CASE[2], "normal", "wide"))
    clouds += [(normal(n, f, rng_plans), k, "normal", "general") for n, f, k in GENERAL_PLAN_CASES]
    n, f, k = GENERAL_GRID_CASE
    clouds.append((grid(n, f, rng_plans), k, "grid", "general"))
    clouds.append((normal(*WIDE_CASE[:2], rng_plans), WIDE_CASE[2], "normal", "wide"))
    general_plans = set()
    for cloud, k, kind, instance in clouds:
        pts = torch.from_numpy(cloud.astype(np.float32)).to(dev)
        res = hold(pts, k)
        n, f = cloud.shape
        require(res["instance"] == instance, f"({n}, {f}, {k}) ran the {res['instance']} instance")
        if (n, f, k) == GLOBAL_SCRATCH_CASE:
            require(res["topk"] == "global", f"({n}, {f}, {k}) did not keep its keys in scratch")
        if instance == "general":
            general_plans.add((res["queries"], res["rows_per_warp"]))
        log(f"knn_topk parity {kind} n={n} f={f} k={k}: {res}")
    every = {(q, r) for q, rows in knn_cuda.GENERAL_ROWS_PER_WARP.items() for r in rows}
    require(general_plans == every, f"general plans never held: {sorted(every - general_plans)}")
    del pts

    if args.kernels_only:
        # ---- the kernel alone at the main path's shape ------------------
        n, f, k = FULL_SHAPE
        full = {"normal": rng.normal(size=(n, f)), "grid": rng.integers(0, 4, size=(n, f)),
                "constant": np.ones((n, f))}
        full = {kind: torch.from_numpy(c.astype(np.float32)).to(dev) for kind, c in full.items()}
        entry = kernel_entry(full.pop("normal"), k, "normal", launches=None)
        entry["other_clouds"] = []
        for kind, pts in full.items():
            parity, ms = hold(pts, k), kernel_ms(pts, k)
            log(f"knn_topk on the {kind} cloud n={n} f={f} k={k}: {parity}, {ms:.3f} ms")
            entry["other_clouds"].append({"cloud": kind, "ms": ms, **parity})
        del full, pts
        print_kernels([entry] + general_entries(launches=None, constant=True)
                      + [wide_entry(launches=None)])
    else:
        work = ROOT / "build" / "chip_smoke"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            (run_community_only if args.community_only
             else run_frames_only if args.frames_only
             else run_blocked_only if args.blocked_only
             else run_mesh_only if args.mesh_only
             else run_serve_mesh_only if args.serve_mesh_only
             else run_dist_only if args.dist_only else run_main_path)(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    print(json.dumps({"smoke_seconds": time.perf_counter() - t_start}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def reset_launches() -> None:
    """Set every launch count to 0."""
    from graphmine_tpu_torch.kernels import knn_cuda

    knn_cuda.launches = 0
    knn_cuda.instance_launches = dict.fromkeys(knn_cuda.instance_launches, 0)


def read_launches() -> dict:
    """The launch counts since :func:`reset_launches`: ``knn_topk`` (all
    instances) and one count per instance."""
    from graphmine_tpu_torch.kernels import knn_cuda

    return {"knn_topk": knn_cuda.launches,
            **{f"knn_topk_{name}": n for name, n in knn_cuda.instance_launches.items()}}


def small_inputs(work: Path) -> tuple:
    """Phase 4's graph, ``planted_anomaly_graph(4096, 60_000, seed=9)``,
    as an edge list with weights in quarters (``small.txt``) and as a
    parquet file (``small.parquet``) in ``work``."""
    from graphmine_tpu_torch import datasets

    v = 4096
    src, dst, _, _ = datasets.planted_anomaly_graph(v, 60_000, seed=SEED_MAIN)
    small, small_pq = work / "small.txt", work / "small.parquet"
    write_edge_list(small, src, dst, np.random.default_rng(7).integers(1, 16, len(src)) / 4)
    write_parquet(small_pq, src, dst, v)
    return small, small_pq


def small_pipelines(work: Path) -> dict:
    """Phase 4: the pipeline on the card against the CPU on 4,096-vertex
    planted graphs: exact kNN, quarter weights, the IVF index, parquet
    input, the exact kNN at lof_k = 200 and at lof_k = 1500, and a snapshot
    publish. Returns the launch counts of the lof_k = 200 (``"wide_k"``) and
    lof_k = 1500 (``"widest_k"``) runs on the card."""
    import torch

    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    small, small_pq = small_inputs(work)
    edges = dict(data_path=str(small), data_format="edgelist")
    cases = {"exact": dict(edges, lof_impl="exact"),
             "weighted": dict(edges, lof_impl="exact", edge_weight_col=2),
             "ivf": dict(edges, lof_impl="ivf"),
             "parquet": dict(data_path=str(small_pq), batch_rows=20_000),
             "wide_k": dict(edges, lof_impl="exact", lof_k=WIDE_LOF_K),
             "widest_k": dict(edges, lof_impl="exact", lof_k=WIDEST_LOF_K),
             "snapshot": dict(edges, lof_impl="exact", snapshot_out="store")}
    counts = {}
    for case, kw in cases.items():
        runs = {}
        for d in ("cuda", "cpu"):
            cfg = {"outlier_method": "both", "lof_k": SMALL_LOF_K, "device": d, **kw}
            if "snapshot_out" in kw:
                cfg["snapshot_out"] = str(work / f"store_{d}")
            reset_launches()
            runs[d] = run_pipeline(PipelineConfig(**cfg))
            if d == "cuda":
                torch.cuda.synchronize()
                if case in ("wide_k", "widest_k"):
                    counts[case] = read_launches()
        gpu, cpu = runs["cuda"], runs["cpu"]
        require(np.array_equal(gpu.edge_table.names, cpu.edge_table.names), f"{case}: names")
        require(np.array_equal(gpu.labels, cpu.labels), f"{case}: LPA labels differ from the CPU's")
        require(np.array_equal(gpu.outliers.outlier_vertices, cpu.outliers.outlier_vertices),
                f"{case}: recursive-LPA flags differ from the CPU's")
        np.testing.assert_allclose(gpu.features.cpu().numpy(), cpu.features.numpy(),
                                   rtol=1e-5, atol=1e-6)
        rel = np.abs(gpu.lof - cpu.lof) / np.abs(cpu.lof)
        log(f"small pipeline, {case}: LOF relative error max {rel.max():.3g}, "
            f"share above 1e-4 {(rel > 1e-4).mean():.3g}")
        require((rel <= 1e-4).mean() >= 0.999 and rel.max() <= 1e-2,
                f"{case}: LOF differs from the CPU's beyond rtol 1e-4 for 0.1% of vertices")
        require((gpu.graph.msg_weight is not None) == ("edge_weight_col" in kw), f"{case}: weights")
        if case == "snapshot":
            fp = graph_fingerprint(gpu.edge_table.src, gpu.edge_table.dst)
            snaps = {d: SnapshotStore(str(work / f"store_{d}")).load(fingerprint=fp)
                     for d in ("cuda", "cpu")}
            require(np.array_equal(snaps["cuda"]["cc_labels"], snaps["cpu"]["cc_labels"]),
                    "snapshot: CC labels differ from the CPU's")
            require(np.array_equal(snaps["cuda"]["labels"], gpu.labels), "snapshot: labels")
            require(gpu.metrics.of_phase("cc_summary") and
                    gpu.metrics.of_phase("canary_score"), "snapshot: records")
            log(f"small pipeline, snapshot: {gpu.metrics.of_phase('cc_summary')[0]}, "
                f"store version {snaps['cuda'].version}")
        log(f"small pipeline, {case}: card == CPU ({gpu.num_communities} communities)")
    require(counts["wide_k"]["knn_topk_general"] >= 1,
            f"the lof_k={WIDE_LOF_K} run never launched the general instance: {counts['wide_k']}")
    require(counts["widest_k"]["knn_topk_wide"] >= 1,
            f"the lof_k={WIDEST_LOF_K} run never launched the wide instance: {counts['widest_k']}")
    log(f"lof_k={WIDE_LOF_K} and {WIDEST_LOF_K} run launches: {counts}")
    from graphmine_tpu_torch.ops.ann import ivf_knn

    feats = runs["cuda"].features
    first, again = ivf_knn(feats, 32), ivf_knn(feats, 32)
    torch.cuda.synchronize()
    require(torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]),
            "two IVF runs on the card differ")
    return counts


def drive(cfg, label: str) -> tuple:
    """One ``run_pipeline`` with the launch counts set to 0 just before and
    read just after: ``(result, wall seconds, launches, peak bytes)``."""
    import torch

    from graphmine_tpu_torch.pipeline import run_pipeline

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = run_pipeline(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    log(f"{label}: {wall:.1f} s, launches {launches}")
    return res, wall, launches, torch.cuda.max_memory_allocated()


def records(sink, phase: str) -> list:
    """The ``phase`` records of a metrics sink, without their phase and
    time keys."""
    return [{k: v for k, v in r.items() if k not in ("phase", "t")} for r in sink.of_phase(phase)]


def path_summary(res, is_anomaly, wall: float, launches: dict, peak: int) -> dict:
    """Check a full-size pipeline result and summarise it for its line."""
    from graphmine_tpu_torch.ops.lof import auroc

    v = res.graph.num_vertices
    require(res.labels.shape == (v,) and res.lof.shape == (v,), "output shapes")
    require(bool(np.isfinite(res.lof).all()), "LOF scores not finite")
    require(1 < res.num_communities < v, f"{res.num_communities} communities")
    flagged = int(res.outliers.outlier_vertices.sum())
    require(flagged > 0 and len(res.outliers.thresholds) >= 10,
            "recursive LPA populated no bottom decile")
    lof_auroc = auroc(res.lof, is_anomaly[generator_ids(res.edge_table.names)])
    require(lof_auroc > 0.5, f"LOF AUROC {lof_auroc} no better than chance")
    m = res.metrics
    # the pipeline's LOF comes first; a publish's canary probe adds its own
    lof_sel = [r for r in m.of_phase("impl_selected") if r["op"] == "lof_knn"][0]
    return {
        "graph": f"planted_anomaly_graph({V_MAIN}, {E_MAIN}, seed={SEED_MAIN})",
        "wall_seconds": wall, "phase_seconds": m.phase_seconds(),
        "vertices": v, "edges": res.graph.num_edges, "messages": res.graph.num_messages,
        "weighted": res.graph.msg_weight is not None,
        "communities": res.num_communities, "flagged_vertices": flagged,
        "lof_over_1_5": int((res.lof > 1.5).sum()), "feature_mode": res.feature_mode,
        "lof_impl": lof_sel["impl"],
        "ivf_index": records(m, "ivf_index"), "ivf_fallback": records(m, "ivf_fallback"),
        "quarantine": records(m, "quarantine"),
        "plan": {key: m.of_phase("plan_build")[0][key]
                 for key in ("buckets", "hub_vertices", "max_degree")},
        "wedges": m.of_phase("feature_mode")[0]["wedges"],
        "lof_k": LOF_K, "lof_auroc": lof_auroc, "peak_device_bytes": peak,
        "memory_watermarks": [{k: r.get(k) for k in ("op", "impl", "iteration",
                                                     "predicted_bytes", "achieved_bytes",
                                                     "peak_bytes_in_use")}
                              for r in m.of_phase("memory_watermark")],
        "launches": launches,
    }


def ivf_entry(pts, is_outlier, cloud: str, k: int = LOF_K,
              min_recall: float | None = None) -> dict:
    """The IVF kNN of ``pts`` held against the kernel's exact kNN
    (:func:`ivf_quality`, recall gated only with ``min_recall``), run again
    with TF32 allowed (indices must not change), and both timed."""
    import torch

    from graphmine_tpu_torch.kernels import knn_cuda
    from graphmine_tpu_torch.ops.ann import ivf_knn
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink

    sink = MetricsSink()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf = ivf_knn(pts, k, sink=sink)
    torch.cuda.synchronize()
    ivf_ms = 1e3 * (time.perf_counter() - t0)
    exact = knn_cuda.knn_topk(pts, k)
    q = ivf_quality(pts, k, exact, ivf, is_outlier, min_recall)
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        t0 = time.perf_counter()
        ivf_tf32 = ivf_knn(pts, k)
        torch.cuda.synchronize()
        ivf_tf32_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    require(torch.equal(ivf_tf32[1], ivf[1]), f"{cloud}: IVF indices change with TF32 allowed")
    exact_ms = cuda_ms(lambda: knn_cuda.knn_topk(pts, k), reps=3)
    entry = {"cloud": cloud, "n": pts.shape[0], "f": pts.shape[1], "k": k, **q,
             "min_recall": min_recall,
             "tf32_indices_equal": True, "ivf_ms": ivf_ms, "ivf_tf32_ms": ivf_tf32_ms,
             "exact_ms": exact_ms,
             "ivf_index": records(sink, "ivf_index"), "ivf_fallback": records(sink, "ivf_fallback")}
    log(f"IVF on the {cloud} cloud: {entry}")
    return entry


def publish_summary(res, store: Path) -> dict:
    """Load the main path's store back under the graph's fingerprint,
    check it against the run, and summarise the publish: CC count and
    giant component, the publish's seconds and bytes, the store's version
    and the ``canary_score`` record."""
    from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    m = res.metrics
    t0 = time.perf_counter()
    snap = SnapshotStore(str(store)).load(
        fingerprint=graph_fingerprint(res.edge_table.src, res.edge_table.dst))
    load_s = time.perf_counter() - t0
    require(snap is not None and np.array_equal(snap["labels"], res.labels), "store labels")
    require(np.array_equal(snap["lof"], res.lof), "store LOF")
    cc = snap["cc_labels"]
    v = res.graph.num_vertices
    require(cc.shape == (v,) and (cc <= np.arange(v)).all() and (cc[cc] == cc).all(),
            "CC labels are not each component's smallest vertex")
    sizes = np.bincount(cc)
    (cc_rec,) = m.of_phase("cc_summary")
    require(cc_rec["components"] == int((sizes > 0).sum()) and cc_rec["largest"] == sizes.max(),
            "cc_summary disagrees with the store")
    (published,) = [r for r in m.of_phase("snapshot_publish") if "bytes" in r]
    (canary,) = records(m, "canary_score")
    require(canary["recall_at_k"] > 0, f"canary recall {canary['recall_at_k']}")
    cc_plan = [r for r in records(m, "impl_selected") if r["op"] == "cc_superstep"]
    return {"cc_components": cc_rec["components"], "cc_giant": cc_rec["largest"],
            "cc_supersteps": cc_rec["iterations"], "cc_plan": cc_plan[0]["impl"],
            "snapshot_publish_seconds": m.phase_seconds()["snapshot_publish"],
            "store_write_seconds": published["seconds"], "store_bytes": published["bytes"],
            "store_version": snap.version, "store_load_seconds": load_s,
            "canary_score": canary}


def _jsonl(path: Path) -> list:
    return [json.loads(line) for line in open(path)]


def _planted(plan) -> object:
    """A fault injector of the port with ``plan``'s ``(site, factory, at)``
    rules."""
    from graphmine_tpu_torch.testing import faults

    inj = faults.FaultInjector()
    for site, factory, at in plan:
        inj.add(site, factory, at=at)
    return inj


def small_harness(work: Path, devices=("cuda", "cpu")) -> list:
    """Phase 4b: the run harness on phase 4's small graph (``small.txt``
    in ``work``), on each of ``devices``. Each case's completed run must
    equal the uninterrupted run on its device (labels, flags and CC labels
    bit-equal, LOF within phase 4's tolerances) and the card's must equal
    the CPU's. Returns one summary per case."""
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from graphmine_tpu_torch.pipeline import checkpoint as ckpt
    from graphmine_tpu_torch.pipeline.resilience import ResilienceConfig, SuperstepTimeout
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore
    from graphmine_tpu_torch.testing import faults

    def cfg(d, tag, resilience=None, **kw):
        return PipelineConfig(
            data_path=str(work / "small.txt"), data_format="edgelist", lof_impl="exact",
            lof_k=SMALL_LOF_K, outlier_method="both", device=d,
            snapshot_out=str(work / "harness" / d / tag / "store"),
            resilience=ResilienceConfig(backoff_base_s=0.001, backoff_max_s=0.01,
                                        **(resilience or {})), **kw)

    def outcome(res, d, tag) -> dict:
        store = SnapshotStore(str(work / "harness" / d / tag / "store"))
        snap = store.load(fingerprint=ckpt.graph_fingerprint(res.edge_table.src,
                                                             res.edge_table.dst))
        return {"labels": res.labels, "flags": res.outliers.outlier_vertices,
                "cc": snap["cc_labels"], "lof": res.lof, "metrics": res.metrics}

    def fails(d, tag, plan, exc, **kw):
        """A run that must die of ``exc``; returns its records."""
        out = work / "harness" / d / f"{tag}.jsonl"
        out.parent.mkdir(parents=True, exist_ok=True)
        with _planted(plan).installed():
            try:
                run_pipeline(cfg(d, tag, metrics_out=str(out), **kw))
            except exc:
                return _jsonl(out)
        raise AssertionError(f"{tag} on {d}: the run did not fail with {exc.__name__}")

    cases: dict = {}
    for d in devices:
        runs = {"base": outcome(run_pipeline(cfg(d, "base")), d, "base")}
        ck = str(work / "harness" / d / "ck")
        # a preemption: fatal at the third superstep, then a new run resumes
        fails(d, "preempted", [("lpa_superstep", faults.preemption, 3)],
              faults.SimulatedPreemption, checkpoint_dir=ck)
        res = run_pipeline(cfg(d, "preemption", checkpoint_dir=ck, resume=True))
        require(res.metrics.of_phase("resume")[0]["iteration"] == 2, f"{d}: resume iteration")
        runs["preemption"] = outcome(res, d, "preemption")
        # the current generation corrupted: rollback to the previous one
        faults.corrupt_file(os.path.join(ck, "lpa_labels.npz"))
        res = run_pipeline(cfg(d, "corrupt", checkpoint_dir=ck, resume=True))
        require(res.metrics.of_phase("checkpoint_rollback")
                and res.metrics.of_phase("checkpoint_rollback_ok")
                and res.metrics.of_phase("resume")[0]["iteration"] == 4, f"{d}: rollback")
        runs["corrupt"] = outcome(res, d, "corrupt")
        # poisoned labels: the tripwire rolls back to the last checkpoint
        with _planted([("lpa_superstep", faults.poison_labels(shard=1, num_shards=4), 3)]
                      ).installed():
            res = run_pipeline(cfg(d, "poison", checkpoint_dir=str(work / "harness" / d / "ck2"),
                                   resilience={"tripwire_every_k": 1}))
        (tw,) = res.metrics.of_phase("tripwire")
        require(tw["iteration"] == 3 and tw["bad_vertices"] > 0
                and res.metrics.of_phase("resume")[0]["reason"] == "tripwire", f"{d}: tripwire")
        runs["poison"] = outcome(res, d, "poison")
        # a hung superstep: the watchdog checkpoints from a host copy, aborts
        ck3 = str(work / "harness" / d / "ck3")
        recs = fails(d, "hung", [("lpa_superstep", faults.hang(60.0), 2)], SuperstepTimeout,
                     checkpoint_dir=ck3, checkpoint_every=10,
                     resilience={"superstep_timeout_s": HARNESS_TIMEOUT_S})
        (wd,) = [r for r in recs if r["phase"] == "watchdog_timeout"]
        require(wd["checkpointed"] is True and ckpt.load_labels(ck3)[1] == 1,
                f"{d}: watchdog checkpoint")
        res = run_pipeline(cfg(d, "hang", checkpoint_dir=ck3, resume=True))
        runs["hang"] = outcome(res, d, "hang")
        # a real out-of-memory error from the allocator: degrade to sort
        with _planted([("lpa_superstep", lambda d=d: faults.device_oom(d), 2)]).installed():
            res = run_pipeline(cfg(d, "oom"))
        (deg,) = res.metrics.of_phase("degrade")
        require(deg["to"] == "single_sort", f"{d}: degrade {deg}")
        runs["oom"] = outcome(res, d, "oom")
        for case, got in runs.items():
            base = runs["base"]
            for key in ("labels", "flags", "cc"):
                require(np.array_equal(got[key], base[key]), f"{d} {case}: {key} differ from "
                        "the uninterrupted run's")
            _lof_close(got["lof"], base["lof"], f"{d} {case} against the uninterrupted run")
        cases[d] = runs
    summary = []
    for case in cases[devices[0]]:
        gpu, cpu = cases[devices[0]][case], cases[devices[-1]][case]
        for key in ("labels", "flags", "cc"):
            require(np.array_equal(gpu[key], cpu[key]), f"{case}: {key} differ from the CPU's")
        _lof_close(gpu["lof"], cpu["lof"], f"{case}: card against CPU")
        trail = [r["phase"] for r in gpu["metrics"].records
                 if r["phase"] in ("retry", "degrade", "resume", "tripwire",
                                   "checkpoint_rollback", "checkpoint_rollback_ok")]
        summary.append({"case": case, "communities": int(len(np.unique(gpu["labels"]))),
                        "recovery": trail})
        log(f"harness small, {case}: card == CPU == uninterrupted, recovery {trail}")
    return summary


def _lof_close(got, want, what: str) -> None:
    """Phase 4's LOF tolerance: rtol 1e-4 on 99.9% of vertices, 1e-2 on all."""
    rel = np.abs(got - want) / np.abs(want)
    require((rel <= 1e-4).mean() >= 0.999 and rel.max() <= 1e-2,
            f"{what}: LOF beyond rtol 1e-4 for 0.1% of vertices (max {rel.max():.3g})")


def harness_flags(work: Path, parquet: Path) -> list:
    """Phase 5c's command line: flags of the JAX package's CLI, as
    ``python -m graphmine_tpu.pipeline`` takes them."""
    return ["--data-path", str(parquet), "--batch-rows", str(BATCH_ROWS),
            "--checkpoint-dir", str(work / "ck"), "--checkpoint-every", "1",
            "--tripwire-every-k", "1", "--superstep-timeout-s", "120",
            "--heartbeat-every-s", "1", "--prom-out", str(work / "graphmine.prom"),
            "--metrics-out", str(work / "metrics.jsonl"), "--run-id", HARNESS_RUN_ID,
            "--profile-dir", str(work / "prof"), "--snapshot-out", str(work / "store5c")]


def harness_summary(records: list, wall: float, peak: int, launches: dict) -> dict:
    """The ``harness`` line from phase 5c's recorded stream: wall and
    phase seconds (top-level spans), record counts, checkpoint bytes and
    save seconds, the memory model's predicted peak beside the measured
    one, heartbeats, and the ten ops with the most self device time in
    the profiled LPA window."""
    counts: dict = {}
    for r in records:
        counts[r["phase"]] = counts.get(r["phase"], 0) + 1
    of = lambda phase: [r for r in records if r["phase"] == phase]
    saves = of("checkpoint_save")
    marks = of("memory_watermark")
    prof = [r for r in of("profile_capture") if r.get("ok")]
    return {
        "run_id": records[0].get("run_id"),
        "wall_seconds": wall,
        "phase_seconds": {r["name"]: r["seconds"] for r in of("span")
                          if r["span_path"].count("/") == 1},
        "records": counts,
        "checkpoint_bytes": saves[-1]["bytes"] if saves else None,
        "checkpoint_save_seconds": [r.get("seconds") for r in saves],
        "predicted_peak_bytes": max((r["predicted_bytes"] for r in marks), default=None),
        "predicted_peak_op": max(marks, key=lambda r: r["predicted_bytes"])["op"] if marks
        else None,
        "max_memory_allocated": peak,
        "heartbeats": counts.get("heartbeat", 0),
        "lpa_superstep_seconds": [r["seconds"] for r in of("lpa_iter")],
        "profile_trace": prof[0]["trace"] if prof else None,
        "profile_start_seconds": prof[0].get("start_seconds") if prof else None,
        "profile_stop_seconds": prof[0].get("seconds") if prof else None,
        "top_kernels": [{"name": k["name"], "self_device_ms": k["self_device_ms"],
                         "calls": k["calls"]} for k in (prof[0]["top_device_ops"][:10]
                                                        if prof else [])],
        "launches": launches,
    }


def check_harness(res, records: list, work: Path, phase5: dict, launches: dict) -> None:
    """Phase 5c's requirements against phase 5's results."""
    import torch

    from graphmine_tpu_torch.obs.schema import validate_records
    from graphmine_tpu_torch.ops.lof import lof_scores
    from graphmine_tpu_torch.pipeline import checkpoint as ckpt

    require(np.array_equal(res.labels, phase5["labels"]), "5c: labels differ from phase 5's")
    require(np.array_equal(res.outliers.outlier_vertices, phase5["flags"]),
            "5c: recursive-LPA flags differ from phase 5's")
    require(torch.equal(res.features, phase5["features"]), "5c: features differ from phase 5's")
    exact = lof_scores(phase5["features"], k=LOF_K, impl="exact").cpu().numpy()
    require(np.array_equal(res.lof, exact), "5c: LOF differs from the exact scorer's")
    require(launches["knn_topk"] >= 2, f"5c: knn_topk launches {launches}")
    of = lambda phase: [r for r in records if r["phase"] == phase]
    retries = of("retry")
    require(len(retries) == 1 and retries[0]["stage"] == "lpa", f"5c: retries {retries}")
    degrades = of("degrade")
    require(len(degrades) == 1 and degrades[0]["stage"] == "outliers_lof"
            and degrades[0]["to"] == "lof_exact", f"5c: degrades {degrades}")
    require([r["iteration"] for r in of("checkpoint_save")] == [1, 2, 3, 4, 5],
            "5c: checkpoint saves")
    newest = ckpt.load_newest(str(work / "ck"))
    require(newest is not None and newest[1] == 5 and np.array_equal(newest[0], res.labels),
            "5c: the newest checkpoint is not the final labels at iteration 5")
    require(not of("tripwire"), "5c: a tripwire fired")
    require(len(of("heartbeat")) >= 1, "5c: no heartbeat")
    prom = (work / "graphmine.prom").read_text()
    require(f'graphmine_supersteps_total{{run_id="{HARNESS_RUN_ID}"}} 5' in prom,
            "5c: graphmine_supersteps_total is not 5 in the Prometheus file")
    prof = of("profile_capture")
    require(len(prof) == 1 and prof[0]["ok"] and Path(prof[0]["trace"]).is_file(),
            f"5c: profile capture {prof}")
    ops = {r["op"] for r in of("superstep_timing")}
    require({"lpa_superstep", "cc_superstep"} <= ops, f"5c: superstep_timing ops {ops}")
    require(of("memory_watermark"), "5c: no memory_watermark record")
    require(all(r.get("run_id") == HARNESS_RUN_ID for r in records), "5c: run ids")
    problems = validate_records(records)
    require(not problems, f"5c: the record stream does not validate: {problems[:5]}")


def run_harness_path(work: Path, parquet: Path, phase5: dict) -> None:
    """Phase 5c: the main path under the run harness, with a transient
    error at the third superstep and a real out-of-memory error at the
    IVF family's first hit; prints the ``harness`` line."""
    import torch

    from graphmine_tpu_torch.pipeline.config import parse_args
    from graphmine_tpu_torch.testing import faults

    hwork = work / "harness5c"
    hwork.mkdir()
    cfg = parse_args(harness_flags(hwork, parquet))
    with _planted([("lpa_superstep", faults.transient_error, 3),
                   ("outliers_lof", lambda: faults.device_oom("cuda"), 1)]).installed():
        res, wall, launches, peak = drive(cfg, "harness path")
    records = _jsonl(hwork / "metrics.jsonl")
    check_harness(res, records, hwork, phase5, launches)
    summary = harness_summary(records, wall, peak, launches)
    summary["labels_equal_phase5"] = summary["features_equal_phase5"] = True
    summary["lof_equal_exact"] = True
    summary["communities"] = res.num_communities
    print(json.dumps({"harness": summary}), flush=True)
    del res
    torch.cuda.empty_cache()


# ---- 7. serving -------------------------------------------------------------

SHED_ROWS = 150_000   # past the default max_pending_rows (100,000): shed
SERVE_QUERY_IDS = 4096
SERVE_QUERY_REPS = 32
SERVE_VERTEX_GETS = 256
# of E: inserts; deletes are half as many (no 0.2% delta too: left out to
# keep the smoke inside its time limit)
SERVE_DELTA_FRACS = (0.0005,)
# Response keys that carry wall times or random ids, not results.
_TIMING_KEYS = {"seconds", "snapshot_age_s", "tenant_snapshot_age_s", "ingest_lag_s",
                "snapshot_id", "uptime_s"}


def http(port: int, method: str, path: str, body=None, timeout: float = 600.0,
         headers=None) -> tuple:
    """One request to a local server: ``(status, headers, parsed body)``."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                                 headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _results(body):
    """A response body without its timing fields."""
    if isinstance(body, dict):
        return {k: _results(v) for k, v in body.items() if k not in _TIMING_KEYS}
    if isinstance(body, list):
        return [_results(v) for v in body]
    return body


def shed_payload(num_vertices: int) -> dict:
    """A :data:`SHED_ROWS`-row insert batch (seeded) that admission sheds."""
    ins = np.random.default_rng(11).integers(0, num_vertices, (SHED_ROWS, 2))
    return {"insert": ins.tolist()}


def check_shed(port: int, before_version: int) -> dict:
    """POST the shed batch: 503 with Retry-After, and the served version
    unchanged. Returns the refusal body."""
    status, headers, body = http(port, "POST", "/delta", shed_payload(8))
    require(status == 503 and body.get("verdict") == "shed",
            f"the {SHED_ROWS}-row delta was not shed: {status} {body}")
    require(int(headers.get("Retry-After", "0")) >= 1, f"no Retry-After on the shed: {headers}")
    version = http(port, "GET", "/healthz")[2]["version"]
    require(version == before_version, f"the shed delta moved the version to {version}")
    return body


def check_publish(snap, parent, method: str, device) -> None:
    """One accepted publish against the store's own graph: CC labels equal
    a cold ``connected_components`` of the spliced graph on ``device``; a
    warm repair's labels are a fixpoint of one exact ``lpa_superstep`` over
    every vertex; the version chain advances by one."""
    import torch

    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.cc import connected_components
    from graphmine_tpu_torch.ops.lpa import lpa_superstep

    require(snap.version == parent.version + 1 and snap.parent == parent.snapshot_id,
            f"version chain: v{parent.version} -> v{snap.version}")
    w = snap.get("weights")
    g = build_graph(snap["src"], snap["dst"], num_vertices=len(snap["labels"]),
                    edge_weights=w, device=device)
    cold_cc = connected_components(g).cpu().numpy()
    require(np.array_equal(cold_cc, snap["cc_labels"]),
            f"v{snap.version}: CC labels differ from a cold recompute")
    if method == "warm":
        lbl = torch.from_numpy(np.asarray(snap["labels"], np.int32)).to(g.device)
        require(torch.equal(lpa_superstep(lbl, g), lbl),
                f"v{snap.version}: warm labels are not an LPA fixpoint")
    del g


def serve_compare(store: Path, work: Path, devices=("cuda", "cpu")) -> dict:
    """Phase 7a: two servers over copies of one small store, one on each
    of ``devices``, the same requests to both: bodies equal apart from
    timing fields (LOF within phase 4's tolerances after the deltas),
    deltas with equal labels, CC labels, repair methods, iterations and
    versions, and the shed answered 503 with the state unchanged."""
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink
    from graphmine_tpu_torch.serve.server import SnapshotServer
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    servers, sinks, ports = [], [], []
    for i, d in enumerate(devices):
        copy = work / f"serve7a_{i}_{d}"
        shutil.copytree(store, copy)
        sinks.append(MetricsSink())
        servers.append(SnapshotServer(SnapshotStore(str(copy)), sink=sinks[i], device=d))
        ports.append(servers[i].start()[1])
    both = range(len(devices))
    try:
        base = servers[0].engine.snapshot
        v, src, dst = len(base["labels"]), base["src"], base["dst"]
        rng = np.random.default_rng(5)
        ids = rng.integers(0, v, 257).tolist()
        comm = int(base["labels"][ids[0]])
        reads = [("GET", "/healthz", None), ("GET", f"/vertex?v={ids[1]}", None),
                 ("GET", f"/neighbors?v={ids[2]}", None),
                 ("GET", f"/topk?community={comm}&k=10", None),
                 ("GET", f"/explain?vertex={ids[3]}", None), ("POST", "/query", {"vertices": ids})]
        for method, path, body in reads:
            got = [http(ports[i], method, path, body) for i in both]
            require(got[0][0] == got[1][0] == 200, f"{path}: status {[g[0] for g in got]}")
            require(_results(got[0][2]) == _results(got[1][2]), f"{path}: bodies differ")
        pick = rng.integers(0, len(src), 24)
        edges = [[int(src[i]), int(dst[i])] for i in pick]
        new = rng.integers(0, v, (24, 2)).tolist()
        deltas = [{"insert": new[:12] + [[v, 0], [v, 1]]}, {"delete": edges[:12]},
                  {"insert": new[12:], "delete": edges[12:]}]
        out = []
        for body in deltas:
            got = [http(ports[i], "POST", "/delta", body) for i in both]
            require(got[0][0] == got[1][0] == 200, f"delta: status {[g[0] for g in got]}")
            require(_results(got[0][2]) == _results(got[1][2]),
                    f"delta: bodies differ: {got[0][2]} {got[1][2]}")
            recs = [sinks[i].of_phase("delta_apply")[-1] for i in both]
            keys = ("method", "iterations", "budget", "inserts", "deletes", "version",
                    "quarantine", "lof_mode")
            require(all(recs[0][k] == recs[1][k] for k in keys),
                    f"delta_apply records differ: {[{k: r[k] for k in keys} for r in recs]}")
            snaps = [servers[i].engine.snapshot for i in both]
            for name in ("labels", "cc_labels", "src", "dst"):
                require(np.array_equal(snaps[0][name], snaps[1][name]), f"delta: {name} differ")
            _lof_close(snaps[0]["lof"], snaps[1]["lof"], "delta")
            out.append({k: recs[0][k] for k in keys})
        got = [http(ports[i], "POST", "/query", {"vertices": ids}) for i in both]
        a, b = (_results(g[2]) for g in got)
        _lof_close(np.asarray(a.pop("lof")), np.asarray(b.pop("lof")), "query after deltas")
        require(a == b, "query after deltas: bodies differ")
        versions = [srv.engine.version for srv in servers]
        sheds = [check_shed(ports[i], versions[i]) for i in both]
        require(sheds[0] == sheds[1], "shed bodies differ")
        return {"vertices": v, "deltas": out, "versions": versions, "shed": sheds[0]}
    finally:
        for srv in servers:
            srv.stop()


def _quantiles_us(lat) -> dict:
    p50, p99 = np.percentile(np.asarray(lat) * 1e6, [50, 99])
    return {"p50_us": float(p50), "p99_us": float(p99)}


def serve_full(store: Path, device="cuda", query_reps: int = SERVE_QUERY_REPS,
               vertex_gets: int = SERVE_VERTEX_GETS) -> dict:
    """Phase 7b: a server on ``device`` over ``store`` (the main path's
    published store on the card): single and batched reads, the LOF
    bootstrap delta, two deltas drawn as ``bench.py``'s serve tier draws
    them, and the shed, with a reader posting ``/query`` throughout the
    applies. Every publish is held by :func:`check_publish`; every reader
    answer must match the published snapshot of the version it names.
    Returns the ``serve`` line."""
    import threading

    import torch

    from graphmine_tpu_torch.pipeline.metrics import MetricsSink
    from graphmine_tpu_torch.serve.server import SnapshotServer
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    sink = MetricsSink()
    t0 = time.perf_counter()
    srv = SnapshotServer(SnapshotStore(str(store)), sink=sink, device=device)
    port = srv.start()[1]
    start_s = time.perf_counter() - t0
    try:
        base = srv.engine.snapshot
        v, e = len(base["labels"]), len(base["src"])
        require(http(port, "GET", "/healthz")[2]["ok"], "healthz")
        rng = np.random.default_rng(7)
        lat = []
        for vtx in rng.integers(0, v, vertex_gets):
            t = time.perf_counter()
            status, _, row = http(port, "GET", f"/vertex?v={int(vtx)}")
            lat.append(time.perf_counter() - t)
            require(status == 200 and row["label"] == int(base["labels"][vtx]), "vertex row")
        vertex_q = _quantiles_us(lat)
        ids = rng.integers(0, v, SERVE_QUERY_IDS)
        body = {"vertices": ids.tolist()}
        lat = []
        t_all = time.perf_counter()
        for _ in range(query_reps):
            t = time.perf_counter()
            status, _, out = http(port, "POST", "/query", body)
            lat.append(time.perf_counter() - t)
            require(status == 200 and np.array_equal(out["label"], base["labels"][ids]), "query")
        query_q = {**_quantiles_us(lat),
                   "lookups_per_s": query_reps * len(ids) / (time.perf_counter() - t_all)}
        stages = srv.engine.stage_snapshot()

        snaps = {base.version: base}
        seen, errors, stop = [], [], threading.Event()

        def reader_ids(n: int) -> np.ndarray:
            return np.random.default_rng(1000 + n).integers(0, v, SERVE_QUERY_IDS)

        def digest(labels, comps) -> str:
            return hashlib.sha1(np.asarray(labels, np.int32).tobytes()
                                + np.asarray(comps, np.int32).tobytes()).hexdigest()

        def reader():
            n = 0
            while not stop.is_set():
                n += 1
                try:
                    status, _, ans = http(port, "POST", "/query",
                                          {"vertices": reader_ids(n).tolist()})
                    if status != 200:
                        errors.append(status)
                    else:
                        seen.append((ans["version"], n, digest(ans["label"], ans["component"])))
                except Exception as exc:  # noqa: BLE001 -- counted, then held to zero
                    errors.append(repr(exc))
                time.sleep(0.02)

        thread = threading.Thread(target=reader, daemon=True)
        thread.start()
        deltas = [("lof_bootstrap", {"insert": [[0, 1]]})]
        out_deltas = []
        try:
            for frac in (None,) + SERVE_DELTA_FRACS:
                cur = srv.engine.snapshot
                if frac is not None:
                    n_d = max(8, int(e * frac))
                    cur_v = len(cur["labels"])
                    ins = np.stack([rng.integers(0, cur_v, n_d), rng.integers(0, cur_v, n_d)], 1)
                    idx = rng.integers(0, len(cur["src"]), n_d // 2)
                    dele = np.stack([cur["src"][idx], cur["dst"][idx]], 1)
                    deltas.append((f"{frac:g}_of_E", {"insert": ins.tolist(),
                                                       "delete": dele.tolist()}))
                name, payload = deltas[-1]
                n_admit = len(sink.of_phase("admission"))
                t = time.perf_counter()
                status, _, res = http(port, "POST", "/delta", payload)
                apply_s = time.perf_counter() - t
                require(status == 200, f"delta {name}: {status} {res}")
                rec = sink.of_phase("delta_apply")[-1]
                (adm,) = sink.of_phase("admission")[n_admit:]
                snap = srv.engine.snapshot
                require(snap.version == res["version"] == rec["version"], f"delta {name}: version")
                check_publish(snap, cur, rec["method"], device)
                snaps[snap.version] = snap
                stage = sink.of_phase("delta_stages")[-1]["stages"]
                out_deltas.append({
                    "delta": name, "inserts": rec["inserts"], "deletes": rec["deletes"],
                    "rows": len(payload.get("insert", ())) + len(payload.get("delete", ())),
                    "verdict": adm["verdict"], "lof_mode": rec["lof_mode"],
                    "lof_stale": rec["lof_stale"], "repair_method": rec["method"],
                    "iterations": rec["iterations"], "budget": rec["budget"],
                    "apply_seconds": apply_s, "delta_apply_seconds": rec["seconds"],
                    "repair_seconds": rec["repair_seconds"], "lof_seconds": rec["lof_seconds"],
                    "engine_swap_seconds": stage["apply_s"] - rec["seconds"],
                    "version": snap.version,
                })
                log(f"serve delta {name}: {out_deltas[-1]}")
        finally:
            stop.set()
            thread.join(timeout=600)
        require(not errors, f"the reader saw errors: {errors[:5]}")
        require(seen, "the reader saw no answer")
        for version, n, got in seen:
            snap = snaps.get(version)
            require(snap is not None, f"the reader saw version {version}, never published")
            q = reader_ids(n)
            require(got == digest(snap["labels"][q], snap["cc_labels"][q]),
                    f"the reader saw a torn answer at version {version}")
        shed = check_shed(port, srv.engine.version)
        if device != "cpu" and torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return {
            "vertices": v, "edges": e, "store_bytes": base.nbytes, "server_start_seconds": start_s,
            "vertex": vertex_q, "query": {**query_q, "ids": len(ids), "reps": query_reps,
                                          "stages": stages},
            "deltas": out_deltas, "shed": shed,
            "reader": {"answers": len(seen), "errors": len(errors),
                       "versions": sorted({s[0] for s in seen})},
        }
    finally:
        srv.stop()


def serving_stage_times(snap, device="cuda", n_scored: int = 18_754, window: int = 4096,
                        k: int = 16) -> dict:
    """The plain PyTorch and host stages of a delta apply, timed alone on
    ``snap`` (the last publish of 7b): one sort-based ``lpa_superstep`` and
    its ``segment_mode``, one ``cc_superstep``, the streaming LOF's
    ``cross_knn`` scoring of ``n_scored`` rows against a ``window``-point
    window and its exact ``fit_lof``, the IVF re-fit of the window with
    trained centers (CUDA events, ms); then the host stages (seconds): the
    simple-edge dedup and the sampled clustering of the LOF pass's
    features, the rest of the features on the card, and a query engine
    build (its host CSR)."""
    import torch

    from graphmine_tpu_torch.graph.container import build_graph, simple_undirected_edges
    from graphmine_tpu_torch.ops.ann import default_n_clusters, ivf_knn, kmeans
    from graphmine_tpu_torch.ops.cc import cc_superstep
    from graphmine_tpu_torch.ops.features import vertex_features
    from graphmine_tpu_torch.ops.knn import cross_knn
    from graphmine_tpu_torch.ops.lpa import lpa_superstep
    from graphmine_tpu_torch.ops.segment import segment_mode
    from graphmine_tpu_torch.ops.streaming_lof import fit_lof
    from graphmine_tpu_torch.ops.triangles import sampled_clustering_coefficient
    from graphmine_tpu_torch.serve.query import QueryEngine

    out = {}
    t = time.perf_counter()
    g = build_graph(snap["src"], snap["dst"], num_vertices=len(snap["labels"]), device=device)
    torch.cuda.synchronize()
    out["build_graph_s"] = time.perf_counter() - t
    lbl = torch.from_numpy(np.asarray(snap["labels"], np.int32)).to(g.device)
    v = g.num_vertices
    out["lpa_superstep_ms"] = cuda_ms(lambda: lpa_superstep(lbl, g), reps=3)
    out["segment_mode_ms"] = cuda_ms(lambda: segment_mode(g.msg_recv, lbl[g.msg_send], v),
                                     reps=3)
    cc = torch.from_numpy(np.asarray(snap["cc_labels"], np.int32)).to(g.device)
    out["cc_superstep_ms"] = cuda_ms(lambda: cc_superstep(cc, g), reps=3)
    t = time.perf_counter()
    simple = simple_undirected_edges(g)
    out["simple_edges_s"] = time.perf_counter() - t
    t = time.perf_counter()
    sampled_clustering_coefficient(g, simple_edges=simple)
    out["sampled_clustering_s"] = time.perf_counter() - t
    t = time.perf_counter()
    feats = vertex_features(g, lbl, include_clustering=False)
    torch.cuda.synchronize()
    out["other_features_s"] = time.perf_counter() - t
    rng = np.random.default_rng(13)
    refs = feats[torch.from_numpy(rng.choice(v, window, replace=False)).to(g.device)]
    queries = feats[torch.from_numpy(rng.integers(0, v, n_scored)).to(g.device)]
    mask = torch.ones(window, dtype=torch.bool, device=g.device)
    model = fit_lof(refs, mask, k=k)
    out["cross_knn_score_ms"] = cuda_ms(
        lambda: cross_knn(queries, model.refs, k=k, ref_mask=mask), reps=3)
    out["fit_lof_window_ms"] = cuda_ms(lambda: fit_lof(refs, mask, k=k), reps=3)
    centers = kmeans(refs, default_n_clusters(window), seed=0)
    out["ivf_refit_ms"] = cuda_ms(lambda: ivf_knn(refs, k=k, centers=centers), reps=3)
    out["shapes"] = {"vertices": v, "messages": g.num_messages, "scored": n_scored,
                     "window": window, "k": k}
    del g, lbl, cc, feats
    t = time.perf_counter()
    QueryEngine(snap, device=device)
    out["query_engine_build_s"] = time.perf_counter() - t
    return out


def run_serving(work: Path) -> dict:
    """Phase 7: 7a (phase 4's store, card against CPU) and 7b (phase 5's
    store on the card), each with the launch counts set to 0 just before
    and read just after; prints the ``serve`` line and returns the
    launches."""
    import torch

    reset_launches()
    small = serve_compare(work / "store_cuda", work)
    torch.cuda.synchronize()
    small["launches"] = read_launches()
    publishes = len(small["deltas"])
    require(small["launches"]["knn_topk"] >= publishes,
            f"7a: knn_topk launched {small['launches']} for {publishes} publishes")
    log(f"7a served card == CPU: {small}")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    full = serve_full(work / "store")
    torch.cuda.synchronize()
    full["launches"] = read_launches()
    full["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    full["stage_times"] = serving_stage_times(SnapshotStore(str(work / "store")).load())
    log(f"7b stages alone: {full['stage_times']}")
    publishes = len(full["deltas"])
    require(full["launches"]["knn_topk"] >= publishes,
            f"7b: knn_topk launched {full['launches']} for {publishes} publishes")
    print(json.dumps({"serve": {**full, "small": small}}), flush=True)
    return {k: small["launches"][k] + full["launches"][k] for k in full["launches"]}



# ---- 7c/7d. the replicated serving plane ------------------------------------

SERVE_BANNER = "serving snapshot v"
FLEET_BANNER = "fleet: "
REPLICA_SMALL_DELTA = 64  # rows of 7d's second and third deltas
# The fleet's knobs, sized for phase 5's store (7d's larger case): a reload
# there loads 204 MB and builds the query index (seconds), so the data-plane
# timeout and the reader's deadline cover it; a SIGKILLed writer refuses
# connections at once, so the prober still sees it DOWN within a few probe
# intervals.
FLEET_ENV = {
    "GRAPHMINE_FLEET_READ_TIMEOUT_S": "20",
    "GRAPHMINE_FLEET_DEFAULT_DEADLINE_MS": "60000",
    "GRAPHMINE_FLEET_PROBE_TIMEOUT_S": "30",
    "GRAPHMINE_FLEET_DOWN_AFTER_PROBES": "3",
    "GRAPHMINE_FLEET_RELOAD_TIMEOUT_S": "300",
    "GRAPHMINE_FLEET_REJOIN_TIMEOUT_S": "300",
    "GRAPHMINE_FLEET_PROMOTE_TIMEOUT_S": "300",
    "GRAPHMINE_FLEET_WRITE_TIMEOUT_S": "600",
}
# The fleet line's keys (tests/test_torch_chip_smoke.py holds them).
FLEET_KEYS = ("vertices", "edges", "replicas", "startup_seconds", "vertex", "query",
              "deltas", "ack_ms", "visible_seconds", "promote_seconds", "promote",
              "acked_lost", "roll", "reader", "committed_versions", "cc_checked",
              "device_peak_bytes", "smi_used_mib", "smi_processes", "replica_nvidia_fds",
              "router_nvidia_fds", "router_holds_cuda_context", "canary_launches")


class Processes:
    """The subprocesses one phase starts. Leaving the ``with`` block stops
    every one of them, pass or fail: SIGTERM (to the whole process group
    for a group leader, whose children die with it), then SIGKILL after
    ``grace_s``."""

    def __init__(self, grace_s: float = 15.0):
        self.grace_s = grace_s
        self.procs = []  # (proc, is a process-group leader)

    def spawn(self, cmd: list, log: Path, group: bool = False, env=None):
        proc = subprocess.Popen(cmd, stdout=subprocess.DEVNULL, stderr=open(log, "w"),
                                cwd=ROOT, env=env, start_new_session=group)
        self.procs.append((proc, group))
        return proc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop_all()
        return False

    def _signal(self, proc, group: bool, sig) -> None:
        import signal

        try:
            if group:
                os.killpg(proc.pid, sig)
            elif sig == signal.SIGKILL:
                proc.kill()
            else:
                proc.terminate()
        except (ProcessLookupError, PermissionError):
            pass

    def stop_all(self) -> None:
        import signal

        for proc, group in self.procs:
            if group or proc.poll() is None:
                self._signal(proc, group, signal.SIGTERM)
        deadline = time.monotonic() + self.grace_s
        for proc, group in self.procs:
            try:
                proc.wait(timeout=max(0.01, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self._signal(proc, group, signal.SIGKILL)
                proc.wait(timeout=self.grace_s)
            if group:  # the leader's children, had they outlived it
                self._signal(proc, group, signal.SIGKILL)
        self.procs = []


def wait_for(pred, what: str, timeout: float, every: float = 0.05):
    """Poll ``pred()`` until it returns a truthy value (returned) or
    ``timeout`` seconds pass (fails the phase)."""
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        require(time.monotonic() < deadline, f"timed out after {timeout:g} s waiting for {what}")
        time.sleep(every)


def banner(log: Path, marker: str, proc, timeout: float) -> str:
    """The first line of ``log`` holding ``marker``; fails when ``proc``
    exits first or ``timeout`` passes."""
    def find():
        require(proc.poll() is None, f"process exited ({proc.returncode}) before its "
                f"banner: {log.read_text()[-2000:]}")
        for line in log.read_text().splitlines():
            if marker in line:
                return line
        return None
    return wait_for(find, f"'{marker}' in {log.name}", timeout, every=0.1)


def banner_port(line: str) -> int:
    """The port of a ``serving snapshot vN on http://HOST:PORT`` banner."""
    return int(line.split(" on http://")[1].split()[0].rsplit(":", 1)[1])


def fleet_banner(line: str) -> tuple:
    """``(router port, replica pids)`` of ``fleet_cli up``'s banner."""
    port = int(line.split(" behind http://")[1].split()[0].rsplit(":", 1)[1])
    pids = json.loads(line.split("replica pids ")[1].rstrip(")"))
    return port, pids


def canary_launches(paths) -> int:
    """``knn_topk`` launches of replica processes, counted from their
    records: each ``canary_score`` record is one re-score of the quality
    pass's probe, one launch of the kernel's fast instance."""
    n = 0
    for path in paths:
        for line in Path(path).read_text().splitlines():
            if line.strip() and json.loads(line).get("phase") == "canary_score":
                n += 1
    return n


def free_ports(n: int) -> list:
    """``n`` ports free on this host right now (bound, then released)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def check_fleet_line(line: dict) -> dict:
    """The ``fleet`` line carries every key of :data:`FLEET_KEYS`."""
    missing = [k for k in FLEET_KEYS if k not in line]
    require(not missing, f"fleet line lacks {missing}")
    return line


def smi_apps() -> dict:
    """pid -> MiB the card holds for it (``nvidia-smi``'s per-process
    view); {} where nvidia-smi cannot say."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid,used_memory",
             "--format=csv,noheader,nounits"], capture_output=True, text=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    apps = {}
    for line in out.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            apps[int(parts[0])] = int(parts[1])
    return apps


def serve_cmd(store: Path, device: str, *extra) -> list:
    return [sys.executable, "-m", "graphmine_tpu_torch.serve", "serve", "--store", str(store),
            "--port", "0", "--device", device, *map(str, extra)]


def healthz(port: int) -> dict:
    return http(port, "GET", "/healthz", timeout=60)[2]


def settled(port: int, version: int):
    """The server's /healthz once it serves ``version`` (or later) with no
    log entry pending, else None."""
    try:
        h = healthz(port)
    except OSError:
        return None
    wal = h.get("wal") or {}
    return h if h["version"] >= version and wal.get("pending_entries", 0) == 0 else None


def small_deltas(snap, seed: int = 5, skip_ids: int = 0) -> list:
    """7c's deltas on ``snap`` (drawn as 7a draws them): insert-only with
    two new vertices, delete-only, mixed. ``skip_ids`` first draws the ids
    7a reads with (257 there): with ``seed=5`` these are then 7a's own
    deltas."""
    v, src, dst = len(snap["labels"]), snap["src"], snap["dst"]
    rng = np.random.default_rng(seed)
    if skip_ids:
        rng.integers(0, v, skip_ids)
    pick = rng.integers(0, len(src), 24)
    edges = [[int(src[i]), int(dst[i])] for i in pick]
    new = rng.integers(0, v, (24, 2)).tolist()
    return [{"insert": new[:12] + [[v, 0], [v, 1]]}, {"delete": edges[:12]},
            {"insert": new[12:], "delete": edges[12:]}]


def cpu_reference(store: Path, deltas: list, copy: Path) -> tuple:
    """The same deltas through an in-process server on the CPU over a copy
    of ``store`` at ``copy``, applied one at a time without a kill:
    ``(snapshot, delta_apply records)``."""
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink
    from graphmine_tpu_torch.serve.server import SnapshotServer
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    shutil.copytree(store, copy)
    sink = MetricsSink()
    srv = SnapshotServer(SnapshotStore(str(copy)), sink=sink, device="cpu")
    try:
        for body in deltas:
            out = srv.apply_delta(dict(body))
            require("version" in out, f"CPU reference delta: {out}")
        return srv.engine.snapshot, sink.of_phase("delta_apply")
    finally:
        srv.stop()


def repairs(recs) -> list:
    return [(r["method"], r["iterations"], r["version"]) for r in recs]


def jsonl_phase(paths, phase: str) -> list:
    out = []
    for path in paths:
        if Path(path).is_file():
            out += [json.loads(x) for x in Path(path).read_text().splitlines()
                    if x.strip() and json.loads(x).get("phase") == phase]
    return out


def same_publish(got, want, what: str, lof: bool = True) -> None:
    """Labels, CC labels and edges equal, versions equal, and with
    ``lof`` the LOF column within phase 4's tolerances. A restarted or
    promoted writer rebuilds its streaming LOF window from the snapshot,
    so its later scores are not an uninterrupted writer's (in the JAX
    package too): those comparisons pass ``lof=False``."""
    require(got.version == want.version, f"{what}: version {got.version} != {want.version}")
    for name in ("src", "dst", "labels", "cc_labels"):
        require(np.array_equal(got[name], want[name]), f"{what}: {name} differ")
    if lof:
        _lof_close(np.asarray(got["lof"]), np.asarray(want["lof"]), what)


def wal_replay_compare(store: Path, work: Path, device: str = "cuda") -> dict:
    """7c, the log: a ``serve --wal`` process takes two deltas acknowledged
    at the log (each published before the next), a duplicate id, and a
    third, and is SIGKILLed right after the third 202; a restart on the
    same store and log replays what was not published. Equal to the CPU
    server fed the same deltas without the kill, nothing applied twice."""
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    root = work / "c7_wal"
    shutil.copytree(store, root)
    base = SnapshotStore(str(root)).load()
    deltas = small_deltas(base)
    logs = [work / "c7_wal_a.log", work / "c7_wal_b.log"]
    metrics = [work / "c7_wal_a.jsonl", work / "c7_wal_b.jsonl"]
    out = {}
    with Processes() as procs:
        proc = procs.spawn(serve_cmd(root, device, "--wal", root / "wal",
                                     "--metrics-out", metrics[0]), logs[0])
        port = banner_port(banner(logs[0], SERVE_BANNER, proc, 300))
        for i in (0, 1):
            status, _, body = http(port, "POST", "/delta", deltas[i],
                                   headers={"X-Delta-Id": f"d{i}", "X-Delta-Ack": "wal"})
            require(status == 202 and body["seq"] == i + 1, f"7c wal d{i}: {status} {body}")
            wait_for(lambda v=base.version + 1 + i: settled(port, v), f"7c wal v{i + 2}", 300)
        status, _, dup = http(port, "POST", "/delta", deltas[1],
                              headers={"X-Delta-Id": "d1", "X-Delta-Ack": "wal"})
        require(status == 200 and dup["verdict"] == "duplicate" and dup["applied"],
                f"7c wal duplicate: {status} {dup}")
        t = time.perf_counter()
        status, _, body = http(port, "POST", "/delta", deltas[2],
                               headers={"X-Delta-Id": "d2", "X-Delta-Ack": "wal"})
        ack_ms = (time.perf_counter() - t) * 1e3
        require(status == 202 and body["durable"], f"7c wal d2: {status} {body}")
        os.kill(proc.pid, 9)
        proc.wait(timeout=60)
        killed_at = SnapshotStore(str(root)).peek_version()
        proc = procs.spawn(serve_cmd(root, device, "--wal", root / "wal",
                                     "--metrics-out", metrics[1]), logs[1])
        port = banner_port(banner(logs[1], SERVE_BANNER, proc, 300))
        h = wait_for(lambda: settled(port, base.version + 3), "7c wal replay", 300)
        require(h["wal"]["last_seq"] == h["wal"]["applied_seq"] == 3, f"7c wal: {h['wal']}")
        replays = jsonl_phase(metrics[1:], "wal_replay")
        out.update(ack_ms=ack_ms, version_at_kill=killed_at,
                   replayed=sum(r["entries"] for r in replays))
    got = SnapshotStore(str(root)).load()
    want, want_recs = cpu_reference(store, deltas, work / "c7_wal_cpu")
    same_publish(got, want, "7c wal replay", lof=False)
    got_recs = repairs(jsonl_phase(metrics, "delta_apply"))
    require(got_recs == repairs(want_recs), f"7c wal: repairs {got_recs} != {repairs(want_recs)}")
    out.update(repairs=got_recs, version=got.version,
               canary_launches=canary_launches([m for m in metrics if m.is_file()]))
    return out


def standby_promote_compare(store: Path, work: Path, device: str = "cuda") -> dict:
    """7c, the standby: a writer and its log-shipped standby over one
    store, two deltas acknowledged at the writer's log, the writer
    SIGKILLed right after the second 202, the standby promoted: a new
    epoch, zero acknowledged loss (equal to the CPU server fed the same
    deltas), a write on the promoted writer, and the deposed writer's
    publish refused at the store."""
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink
    from graphmine_tpu_torch.serve.server import SnapshotServer
    from graphmine_tpu_torch.serve.snapshot import PublishFencedError, SnapshotStore

    root = work / "c7_standby"
    shutil.copytree(store, root)
    base = SnapshotStore(str(root)).load()
    deltas = small_deltas(base, seed=6)
    logs = [work / "c7_primary.log", work / "c7_standby.log"]
    metrics = [work / "c7_primary.jsonl", work / "c7_standby.jsonl"]
    out = {}
    with Processes() as procs:
        primary = procs.spawn(serve_cmd(root, device, "--wal", root / "wal-0",
                                        "--metrics-out", metrics[0]), logs[0])
        pport = banner_port(banner(logs[0], SERVE_BANNER, primary, 300))
        standby = procs.spawn(serve_cmd(root, device, "--wal", root / "wal-1", "--standby-of",
                                        f"http://127.0.0.1:{pport}", "--primary-wal",
                                        root / "wal-0", "--metrics-out", metrics[1]), logs[1])
        sport = banner_port(banner(logs[1], SERVE_BANNER, standby, 300))
        old_epoch = healthz(pport)["writer_epoch"]
        refused = http(sport, "POST", "/delta", deltas[0])
        require(refused[0] == 503 and "standby" in refused[2]["reason"], f"7c standby: {refused}")
        status, _, body = http(pport, "POST", "/delta", deltas[0],
                               headers={"X-Delta-Id": "p0", "X-Delta-Ack": "wal"})
        require(status == 202, f"7c primary p0: {status} {body}")
        wait_for(lambda: settled(pport, base.version + 1), "7c primary v2", 300)
        status, _, body = http(pport, "POST", "/delta", deltas[1],
                               headers={"X-Delta-Id": "p1", "X-Delta-Ack": "wal"})
        require(status == 202, f"7c primary p1: {status} {body}")
        os.kill(primary.pid, 9)
        primary.wait(timeout=60)
        t = time.perf_counter()
        status, _, promo = http(sport, "POST", "/promote", {})
        require(status == 200 and promo["promoted"] and promo["epoch"] == old_epoch + 1,
                f"7c promote: {status} {promo}")
        wait_for(lambda: settled(sport, base.version + 2), "7c promoted replay", 300)
        out.update(promote_seconds=time.perf_counter() - t, epoch=promo["epoch"],
                   replayed=promo["replayed"], copied_tail=promo["copied_tail"])
        status, _, body = http(sport, "POST", "/delta", deltas[2], headers={"X-Delta-Id": "s2"})
        require(status == 200 and body["version"] == base.version + 3, f"7c new write: {body}")
        require(healthz(sport).get("standby") is None, "7c: the promoted server is a standby")
    got = SnapshotStore(str(root)).load()
    want, want_recs = cpu_reference(store, deltas, work / "c7_standby_cpu")
    same_publish(got, want, "7c promote", lof=False)
    got_recs = repairs(jsonl_phase(metrics, "delta_apply"))
    require(got_recs == repairs(want_recs), f"7c promote: repairs {got_recs}")
    # the deposed writer: its epoch is the old one, its publish must refuse
    sink = MetricsSink()
    zombie = SnapshotServer(SnapshotStore(str(root)), sink=sink, writer_epoch=old_epoch,
                            device=device)
    try:
        zombie.apply_delta({"insert": [[0, 1]]})
        fenced = False
    except PublishFencedError:
        fenced = True
    finally:
        zombie.stop()
    require(fenced and sink.of_phase("publish_fenced"), "7c: the deposed writer published")
    require(SnapshotStore(str(root)).peek_version() == got.version,
            "7c: the deposed writer moved the store")
    out.update(repairs=got_recs, version=got.version, deposed_fenced=True,
               canary_launches=canary_launches([m for m in metrics if m.is_file()]))
    return out


def sharded_compare(store: Path, work: Path, devices=("cuda", "cpu")) -> dict:
    """7c, the sharded write plane: a ``writer_shards = 2`` server on
    ``devices[0]`` and a ``writer_shards = 1`` server on ``devices[1]``
    take the same deltas; their publishes are equal, and the sharded one
    wrote ``shard_publish`` and ``epoch_commit`` records."""
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink
    from graphmine_tpu_torch.serve.server import SnapshotServer
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    sinks, snaps, recs, health = [], [], [], []
    deltas = small_deltas(SnapshotStore(str(store)).load(), seed=7)
    for shards, device in zip((2, 1), devices):
        copy = work / f"c7_shards{shards}_{device}"
        shutil.copytree(store, copy)
        sink = MetricsSink()
        srv = SnapshotServer(SnapshotStore(str(copy)), sink=sink, writer_shards=shards,
                             device=device)
        try:
            for i, body in enumerate(deltas):
                res = srv.apply_delta(dict(body), delta_id=f"s{i}")
                require("version" in res, f"7c shards={shards}: {res}")
            health.append(srv.healthz())
        finally:
            srv.stop()
        sinks.append(sink)
        snaps.append(SnapshotStore(str(copy)).load())
        recs.append(repairs(sink.of_phase("delta_apply")))
    same_publish(snaps[0], snaps[1], "7c writer_shards 2 vs 1")
    require(recs[0] == recs[1], f"7c shards: repairs {recs}")
    commits, stages = sinks[0].of_phase("epoch_commit"), sinks[0].of_phase("shard_publish")
    require(len(commits) == len(deltas) and len(stages) == 2 * len(deltas),
            f"7c shards: {len(commits)} epoch_commit, {len(stages)} shard_publish")
    require(health[0]["epoch"] == len(deltas), f"7c shards: epoch {health[0].get('epoch')}")
    return {"repairs": recs[0], "version": snaps[0].version, "epoch": health[0]["epoch"],
            "shard_versions": health[0]["shard_versions"],
            "epoch_commits": len(commits), "shard_publishes": len(stages)}


def run_replicated_small(store: Path, work: Path) -> dict:
    """Phase 7c on phase 4's store: the card against the CPU."""
    import torch

    reset_launches()
    out = {"wal": wal_replay_compare(store, work), "standby": standby_promote_compare(store, work),
           "shards": sharded_compare(store, work)}
    torch.cuda.synchronize()
    out["launches"] = read_launches()
    out["replica_canary_launches"] = (out["wal"]["canary_launches"]
                                      + out["standby"]["canary_launches"])
    require(out["launches"]["knn_topk"] >= out["shards"]["version"] - 1,
            f"7c: the sharded server's publishes launched {out['launches']}")
    require(out["replica_canary_launches"] >= 6, f"7c: replica canaries {out}")
    return out


def router_committed(port: int) -> int:
    """The router's committed version (0 while it has none or does not
    answer)."""
    try:
        return http(port, "GET", "/healthz", timeout=30)[2].get("committed_version") or 0
    except OSError:
        return 0


def nvidia_fds(pid: int) -> list:
    """The ``/dev/nvidia*`` device files process ``pid`` holds open (a
    process opens them when it initialises CUDA)."""
    out = set()
    try:
        fds = os.listdir(f"/proc/{pid}/fd")
    except OSError:
        return []
    for fd in fds:
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.add(target)
    return sorted(out)


def libcuda_mapped(pid: int) -> bool:
    """Whether process ``pid`` has the CUDA driver library mapped (loaded
    on the first CUDA call of a process, never by importing torch)."""
    try:
        return "libcuda.so" in Path(f"/proc/{pid}/maps").read_text()
    except OSError:
        return False


def router_query(port: int, body: dict, deadline_ms: int = 60000) -> tuple:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/query", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", "X-Deadline-Ms": str(deadline_ms)})
    try:
        with urllib.request.urlopen(req, timeout=deadline_ms / 1e3 + 10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def edge_keys(src, dst) -> np.ndarray:
    """The sorted multiset of directed edges, one int64 key each."""
    return np.sort(np.asarray(src, np.int64) * (1 << 32) + np.asarray(dst, np.int64))


def fleet_phase(store: Path, work: Path, device: str = "cuda", vertex_gets: int = 256,
                query_reps: int = 32, query_ids: int = SERVE_QUERY_IDS) -> dict:
    """Phase 7d: ``fleet_cli up --replicas 3 --standby`` over ``store``
    (writer, its standby, one read replica) behind the router, a
    reader posting ``/query`` through the router throughout. Reads through
    the router; phase 7b's 0.05% delta acknowledged at the writer's log;
    a second delta acknowledged and the writer SIGKILLed at once; the
    router's auto-promotion of the standby and a third delta on it; a
    ``roll``. Gates: no reader error, every answer equal to the published
    snapshot of its version, the committed version never going back, no
    acknowledged delta lost, every CC equal to a cold recompute. Returns
    the ``fleet`` line."""
    import threading

    from graphmine_tpu_torch.serve.delta import EdgeDelta, splice_edges, validate_delta
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    snapstore = SnapshotStore(str(store))
    base = snapstore.load()
    v, e = len(base["labels"]), len(base["src"])
    obs = work / "d7_obs"
    obs.mkdir()
    log = work / "d7_fleet.log"
    rport, bport = free_ports(2)
    env = {**os.environ, **FLEET_ENV}
    captured = {base.version: {k: np.asarray(base[k]) for k in ("labels", "cc_labels", "src",
                                                                "dst")}}
    committed, seen, errors = [], [], []
    stop = threading.Event()
    line = {"vertices": v, "edges": e, "replicas": 3}

    def reader_ids(n: int) -> np.ndarray:
        return np.random.default_rng(2000 + n).integers(0, v, query_ids)

    def digest(labels, comps) -> str:
        return hashlib.sha1(np.asarray(labels, np.int32).tobytes()
                            + np.asarray(comps, np.int32).tobytes()).hexdigest()

    retried = [0]

    def reader():
        """A client of the router: the port's ``request_with_retries``,
        which obeys the 503 + Retry-After the router answers while no
        replica holds the committed version (unavailable, never mixed)."""
        from graphmine_tpu_torch.serve.__main__ import request_with_retries

        n = 0
        while not stop.is_set():
            n += 1
            try:
                out = request_with_retries(
                    f"http://127.0.0.1:{rport}/query", {"vertices": reader_ids(n).tolist()},
                    deadline_ms=120_000, max_retries=60)
                retried[0] += out["attempts"] - 1
                ans = out["body"]
                if out["status"] != 200:
                    errors.append((out["status"], ans.get("reason")))
                else:
                    seen.append((ans["version"], n, digest(ans["label"], ans["component"])))
            except Exception as exc:  # noqa: BLE001 -- counted, then held to zero
                errors.append(repr(exc))
            time.sleep(0.02)

    def capture():
        """Every published version of the store, loaded while it is the
        newest, and the router's committed version."""
        while not stop.is_set():
            try:
                ver = snapstore.peek_version()
                if ver is not None and ver not in captured:
                    snap = snapstore.load()
                    captured.setdefault(snap.version, {k: np.asarray(snap[k]) for k in
                                                       ("labels", "cc_labels", "src", "dst")})
                fz = http(rport, "GET", "/fleetz", timeout=30)[2]
                if fz.get("committed_version") is not None:
                    committed.append(fz["committed_version"])
            except Exception:  # noqa: BLE001 -- a load racing a publish retries
                pass
            time.sleep(0.2)

    with Processes() as procs:
        t0 = time.perf_counter()
        fleet = procs.spawn(
            [sys.executable, "-m", "graphmine_tpu_torch.serve.fleet_cli", "up", "--store",
             str(store), "--replicas", "3", "--standby", "--port", str(rport),
             "--replica-base-port", str(bport), "--obs-dir", str(obs), "--device", device,
             "--startup-timeout-s", "600"], log, group=True, env=env)
        _, pids = fleet_banner(banner(log, FLEET_BANNER, fleet, 900))
        wait_for(lambda: router_committed(rport) == base.version, "7d committed base version",
                 300)
        line["startup_seconds"] = time.perf_counter() - t0
        threads = [threading.Thread(target=f, daemon=True) for f in (reader, capture)]
        for th in threads:
            th.start()
        try:
            rng = np.random.default_rng(7)
            lat = []
            for vtx in rng.integers(0, v, vertex_gets):
                t = time.perf_counter()
                status, hdrs, row = http(rport, "GET", f"/vertex?v={int(vtx)}")
                lat.append(time.perf_counter() - t)
                pinned = int(hdrs.get("X-Pinned-Version", -1))
                require(status == 200 and pinned in captured and row["label"]
                        == int(captured[pinned]["labels"][vtx]), f"7d vertex {hdrs} {row}")
            line["vertex"] = _quantiles_us(lat)
            ids = rng.integers(0, v, query_ids)
            lat = []
            t_all = time.perf_counter()
            for _ in range(query_reps):
                t = time.perf_counter()
                status, out = router_query(rport, {"vertices": ids.tolist()})
                lat.append(time.perf_counter() - t)
                require(status == 200 and np.array_equal(
                    out["label"], captured[out["version"]]["labels"][ids]), "7d query")
            line["query"] = {**_quantiles_us(lat), "ids": len(ids), "reps": query_reps,
                             "lookups_per_s": query_reps * len(ids)
                             / (time.perf_counter() - t_all)}
            peaks = {}

            def statusz(i: int) -> dict:
                return http(bport + i, "GET", "/statusz", timeout=120)[2]

            # 7b's 0.05% delta, acknowledged at the writer's log
            n_d = max(8, int(e * 0.0005))
            ins = np.stack([rng.integers(0, v, n_d), rng.integers(0, v, n_d)], 1)
            idx = rng.integers(0, e, n_d // 2)
            d1 = {"insert": ins.tolist(),
                  "delete": np.stack([base["src"][idx], base["dst"][idx]], 1).tolist()}
            small = lambda seed: {"insert": np.random.default_rng(seed).integers(
                0, v, (REPLICA_SMALL_DELTA, 2)).tolist()}
            acked = [d1]
            t = time.perf_counter()
            status, _, body = http(rport, "POST", "/delta", d1,
                                   headers={"X-Delta-Id": "d7-1", "X-Delta-Ack": "wal"})
            t_ack = time.perf_counter()
            require(status == 202 and body["verdict"] == "accepted", f"7d d1: {status} {body}")
            line["ack_ms"] = (t_ack - t) * 1e3
            wait_for(lambda: router_committed(rport) >= base.version + 1, "7d d1 visible",
                     600, every=0.02)
            line["visible_seconds"] = time.perf_counter() - t_ack
            line["deltas"] = [{"delta": "0.0005_of_E",
                               "rows": len(d1["insert"]) + len(d1["delete"]),
                               "ack_ms": line["ack_ms"],
                               "visible_seconds": line["visible_seconds"]}]
            peaks["replica-0"] = statusz(0)["memory"].get("device_peak_bytes")
            smi_before = smi_apps()
            # the second delta, acknowledged, and the writer killed at once
            d2 = small(71)
            status, _, body = http(rport, "POST", "/delta", d2,
                                   headers={"X-Delta-Id": "d7-2", "X-Delta-Ack": "wal"})
            require(status == 202, f"7d d2: {status} {body}")
            os.kill(pids[0], 9)
            t_kill, wall_kill = time.perf_counter(), time.time()
            acked.append(d2)

            def promoted():
                fz = http(rport, "GET", "/fleetz", timeout=30)[2]
                return fz if fz.get("writer") == "replica-1" and not fz.get("read_only") else None
            fz = wait_for(promoted, "7d auto-promotion", 600)
            d3 = small(72)
            status, _, body = wait_for(
                lambda: (lambda r: r if r[0] == 202 else None)(
                    http(rport, "POST", "/delta", d3,
                         headers={"X-Delta-Id": "d7-3", "X-Delta-Ack": "wal"})),
                "7d a write on the promoted writer", 120, every=0.1)
            line["promote_seconds"] = time.perf_counter() - t_kill
            acked.append(d3)
            line["promote"] = {"writer": fz["writer"], "writer_epoch": fz.get("writer_epoch"),
                               "seconds_to_accept": line["promote_seconds"]}
            line["deltas"] += [{"delta": "kill_window", "rows": REPLICA_SMALL_DELTA},
                               {"delta": "after_promotion", "rows": REPLICA_SMALL_DELTA}]
            # d3's 202 came after the replay was queued: no entry pending
            # means both published (one group or two)
            h = wait_for(lambda: settled(bport + 1, base.version + 2), "7d replay and d3", 900)
            final_version = h["version"]
            wait_for(lambda: router_committed(rport) >= final_version,
                     "7d final version committed", 600)
            t = time.perf_counter()
            status, _, roll = http(rport, "POST", "/roll", {}, timeout=900)
            require(status == 200 and roll["ok"], f"7d roll: {status} {roll}")
            line["roll"] = {"seconds": time.perf_counter() - t,
                            "rolled": [(r["id"], r.get("version", r.get("skipped")))
                                       for r in roll["rolled"]],
                            "committed_version": roll.get("committed_version")}
            time.sleep(1.0)  # a few more reader answers at the final version
            for i in (1, 2):
                peaks[f"replica-{i}"] = statusz(i)["memory"].get("device_peak_bytes")
            smi_after = smi_apps()
        finally:
            stop.set()
            for th in threads:
                th.join(timeout=120)
        line["device_peak_bytes"] = peaks
        # nvidia-smi's per-process list, as it gives it (its pids may be
        # another pid namespace's): with the writer alive, after its kill
        line["smi_used_mib"] = {"writer_alive": sorted(smi_before.values()),
                                "after_kill": sorted(smi_after.values())}
        line["smi_processes"] = [len(smi_before), len(smi_after)]
        # a CUDA context holds the driver's device files open: the read
        # replica's show the probe sees them, the router must hold none
        line["replica_nvidia_fds"] = nvidia_fds(pids[2])
        line["router_nvidia_fds"] = nvidia_fds(fleet.pid)
        line["router_holds_cuda_context"] = bool(line["router_nvidia_fds"])
        line["router_libcuda_mapped"] = libcuda_mapped(fleet.pid)
        # whether importing torch alone maps the driver library here
        probe = subprocess.run(
            [sys.executable, "-c", "import torch; print('libcuda.so' in "
             "open('/proc/self/maps').read())"], capture_output=True, text=True, timeout=120)
        line["import_torch_maps_libcuda"] = probe.stdout.strip() == "True"
    # ---- the gates, on what the phase recorded
    require(not errors, f"7d: the reader saw errors: {errors[:5]}")
    require(seen, "7d: the reader saw no answer")
    versions = [s[0] for s in seen]
    require(versions == sorted(versions), "7d: a reader saw the version go back")
    require(committed == sorted(committed), "7d: the router's committed version went back")
    for version, n, got in seen:
        snap = captured.get(version)
        require(snap is not None, f"7d: reader saw version {version}, never captured")
        q = reader_ids(n)
        require(got == digest(snap["labels"][q], snap["cc_labels"][q]),
                f"7d: torn answer at version {version}")
    final = snapstore.load()
    require(final.version == final_version, f"7d: store at v{final.version}")
    # zero acknowledged loss: the final edge multiset is the base's with
    # every acknowledged delta spliced in, in order
    src, dst, nv = np.asarray(base["src"]), np.asarray(base["dst"]), v
    for body in acked:
        clean, _ = validate_delta(EdgeDelta.from_pairs(insert=body.get("insert", ()),
                                                       delete=body.get("delete", ())), nv)
        src, dst, nv, _ = splice_edges(src, dst, nv, clean)
    line["acked_lost"] = int(not np.array_equal(edge_keys(src, dst),
                                                edge_keys(final["src"], final["dst"])))
    require(line["acked_lost"] == 0, "7d: an acknowledged delta is missing from the store")
    line["cc_checked"] = cold_cc_check(captured, device)
    line["reader"] = {"answers": len(seen), "errors": len(errors),
                      "retried_503": retried[0], "versions": sorted(set(versions))}
    line["committed_versions"] = sorted(set(committed))
    line["canary_launches"] = canary_launches(sorted(obs.glob("*.jsonl")))
    line["promote"]["timeline"] = failover_timeline(sorted(obs.glob("*.jsonl")), wall_kill)
    require(not line["router_holds_cuda_context"],
            f"7d: the router process holds CUDA devices open: {line['router_nvidia_fds']}")
    return check_fleet_line(line)


def failover_timeline(paths, wall_kill: float) -> dict:
    """Seconds from the writer's kill to each step of the failover, from
    the processes' own records: the router's ``replica_health`` verdict
    (the writer down), its ``fleet_degraded`` flips (read-only, then
    writable again), its ``writer_promote``, and the standby's
    ``writer_promote`` (with its own seconds, replayed and copied
    entries) and ``wal_replay``."""
    recs = [r for r in jsonl_phase(paths, "replica_health")
            + jsonl_phase(paths, "fleet_degraded") + jsonl_phase(paths, "writer_promote")
            + jsonl_phase(paths, "wal_replay") if r.get("t", 0) >= wall_kill]
    out = {}
    for r in sorted(recs, key=lambda r: r["t"]):
        after = round(r["t"] - wall_kill, 3)
        if r["phase"] == "replica_health" and r.get("to_state") == "down":
            out.setdefault(f"{r['replica']}_down_s", after)
        elif r["phase"] == "fleet_degraded":
            out.setdefault("read_only_s" if r["read_only"] else "writable_s", after)
        elif r["phase"] == "writer_promote":
            key = "server_promote" if "replayed" in r else "router_promote"
            out.setdefault(key, {"after_kill_s": after, **{
                k: r[k] for k in ("seconds", "replayed", "copied_tail", "epoch") if k in r}})
        elif r["phase"] == "wal_replay":
            out.setdefault("replay", {"after_kill_s": after, "entries": r["entries"]})
    return out


def cold_cc_check(captured: dict, device: str) -> list:
    """Every captured version's CC labels equal a cold
    ``connected_components`` of its graph on ``device``; returns the
    versions checked."""
    import torch

    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.cc import connected_components

    for version, arrays in sorted(captured.items()):
        g = build_graph(arrays["src"], arrays["dst"], num_vertices=len(arrays["labels"]),
                        device=device)
        cold = connected_components(g).cpu().numpy()
        require(np.array_equal(cold, arrays["cc_labels"]),
                f"v{version}: CC labels differ from a cold recompute")
        del g
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return sorted(captured)


def run_replicated(work: Path) -> dict:
    """Phases 7c (phase 4's store, card against CPU) and 7d (a copy of
    phase 4's store, the fleet on the card); prints the ``replicated`` and ``fleet``
    lines and returns the launches to add to the serving launches: the
    smoke's own count in 7c and the replicas' canaries of both."""
    t0 = time.perf_counter()
    small = run_replicated_small(work / "store_cuda", work)
    small["seconds"] = time.perf_counter() - t0
    print(json.dumps({"replicated": small}), flush=True)
    t0 = time.perf_counter()
    # phase 4's store (a copy: phase 12 reads the original), not phase 5's:
    # cut for the smoke's time limit
    shutil.copytree(work / "store_cuda", work / "store_7d")
    fleet = fleet_phase(work / "store_7d", work)
    fleet["seconds"] = time.perf_counter() - t0
    print(json.dumps({"fleet": fleet}), flush=True)
    replica = small["replica_canary_launches"] + fleet["canary_launches"]
    out = dict(small["launches"])
    out["knn_topk"] += replica
    out["knn_topk_fast"] += replica
    return out


# ---- 8. community methods and the graph-ops surface -------------------------

COMMUNITY_Q_TOL = 1e-6  # Q of card and CPU labels, float32 sums in other orders
# Float outputs of the ops, card against CPU: sums of floats (aggregate
# means, out-weights) reduce in another order on each device.
OPS_RTOL, OPS_ATOL = 1e-5, 1e-6
OPS_LANDMARKS = 16
PREGEL_STEPS = 5
MOTIF = "(a)-[]->(b); !(b)-[]->(a)"  # edges with no reverse edge
BFS_TARGETS = 8
COMMUNITY_KEYS = ("method", "graph", "vertices", "edges", "wall_seconds", "phase_seconds",
                  "q", "communities", "largest", "peak_device_bytes", "launches", "lof_impl",
                  "louvain_seconds", "louvain_q", "louvain_communities", "louvain_largest",
                  "louvain_level0")
OPS = ("degrees", "in_degrees", "out_degrees", "out_weights", "bfs_distances", "bfs_parents",
       "bfs", "shortest_paths", "weighted_shortest_paths", "strongly_connected_components",
       "core_numbers", "aggregate_messages", "pregel", "find_motifs", "degree_assortativity",
       "reciprocity", "density", "diameter", "adjusted_rand_index", "normalized_mutual_info")


def _host(value):
    """An op's output on the host: tensors as arrays, tuples and lists
    item by item, motif results as their columns."""
    import torch

    if torch.is_tensor(value):
        return value.cpu().numpy()
    if isinstance(value, (tuple, list)):
        return [_host(v) for v in value]
    if hasattr(value, "num_matches"):
        return {"num_matches": value.num_matches, **value.vertices, **value.edges}
    return value


def graph_ops(graph, digraph, weights, labels_a, labels_b) -> tuple:
    """Each op of the graph-ops surface once: ``(outputs on the host,
    seconds per op)``. ``graph`` is symmetric, ``digraph`` the same edges
    directed (for the ops that read direction), ``weights`` one float per
    edge, ``labels_a`` and ``labels_b`` two partitions to compare."""
    import torch

    import graphmine_tpu_torch as gm

    dev, v = graph.device, graph.num_vertices
    ids = torch.arange(v, dtype=torch.int32, device=dev)
    landmarks = np.arange(OPS_LANDMARKS) * max(v // OPS_LANDMARKS, 1) % v
    out_deg = gm.out_degrees(digraph).to(torch.float32)
    calls = {
        "degrees": lambda: gm.degrees(digraph),
        "in_degrees": lambda: gm.in_degrees(digraph),
        "out_degrees": lambda: gm.out_degrees(digraph),
        "out_weights": lambda: gm.out_weights(digraph),
        "bfs_distances": lambda: gm.bfs_distances(digraph, [0]),
        "bfs_parents": lambda: gm.bfs_parents(digraph, [0]),
        "bfs": lambda: gm.bfs(digraph, [0], np.arange(1, BFS_TARGETS + 1)),
        "shortest_paths": lambda: gm.shortest_paths(digraph, landmarks,
                                                    landmark_batch=OPS_LANDMARKS),
        "weighted_shortest_paths": lambda: gm.weighted_shortest_paths(digraph, [0], weights),
        "strongly_connected_components": lambda: gm.strongly_connected_components(digraph),
        "core_numbers": lambda: gm.core_numbers(graph),
        "aggregate_messages": lambda: gm.aggregate_messages(
            digraph, out_deg, to_dst=lambda s, d, e: s, reduce="mean"),
        "pregel": lambda: gm.pregel(
            digraph, ids, to_dst=lambda s, d, e: s, to_src=lambda s, d, e: d, reduce="min",
            update=torch.minimum, max_iter=PREGEL_STEPS),
        "find_motifs": lambda: gm.find_motifs(digraph, MOTIF),
        "degree_assortativity": lambda: gm.degree_assortativity(graph),
        "reciprocity": lambda: gm.reciprocity(digraph),
        "density": lambda: gm.density(graph),
        "diameter": lambda: gm.diameter(graph, seed=0),
        "adjusted_rand_index": lambda: gm.adjusted_rand_index(labels_a, labels_b),
        "normalized_mutual_info": lambda: gm.normalized_mutual_info(labels_a, labels_b),
    }
    assert tuple(calls) == OPS
    outputs, seconds = {}, {}
    for name, call in calls.items():
        _sync_device(dev)
        t0 = time.perf_counter()
        value = call()
        _sync_device(dev)
        seconds[name] = time.perf_counter() - t0
        outputs[name] = _host(value)
        log(f"op {name}: {seconds[name]:.3f} s")
    return outputs, seconds


def _sync_device(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _same_value(got, want, what: str) -> None:
    """Integers (and integer arrays) equal; floats within OPS_RTOL /
    OPS_ATOL, inf and NaN where the other has them."""
    if isinstance(want, dict):
        require(isinstance(got, dict) and sorted(got) == sorted(want), f"{what}: keys differ")
        for key in want:
            _same_value(got[key], want[key], f"{what}.{key}")
        return
    if isinstance(want, list):
        require(isinstance(got, list) and len(got) == len(want), f"{what}: lengths differ")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_value(g, w, f"{what}[{i}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    require(g.shape == w.shape, f"{what}: shape {g.shape} against {w.shape}")
    if np.issubdtype(w.dtype, np.floating):
        close = np.isclose(g, w, rtol=OPS_RTOL, atol=OPS_ATOL, equal_nan=True)
        require(bool(close.all()), f"{what}: floats differ beyond rtol {OPS_RTOL}")
    else:
        require(g.dtype == w.dtype and np.array_equal(g, w), f"{what}: values differ")


def check_ops(got: dict, want: dict, what: str) -> None:
    """Every op's output present on both sides and equal (integers) or
    within tolerance (floats)."""
    for name in OPS:
        require(name in got and name in want, f"{what}: op {name} missing")
        _same_value(got[name], want[name], f"{what}: {name}")


def community_q(res) -> float:
    """The float32 modularity of a run's labels on its graph, as Louvain
    and Leiden score a level."""
    import torch

    from graphmine_tpu_torch.ops.modularity import message_weights, modularity_weighted

    g = res.graph
    w, self_w = message_weights(g)
    labels = torch.from_numpy(np.asarray(res.labels, np.int32)).to(g.device)
    return float(modularity_weighted(labels, g.msg_recv, g.msg_send, w, self_w,
                                     g.num_vertices))


def check_community(gpu, cpu, what: str) -> dict:
    """A Louvain or Leiden pipeline on the card against the CPU: labels,
    community count and recursive-LPA flags equal, Q within
    COMMUNITY_Q_TOL, LOF within phase 4's tolerances. Returns |dQ| and
    LOF's largest relative difference."""
    require(np.array_equal(gpu.labels, cpu.labels), f"{what}: labels differ from the CPU's")
    require(gpu.num_communities == cpu.num_communities, f"{what}: community counts differ")
    require(np.array_equal(gpu.outliers.outlier_vertices, cpu.outliers.outlier_vertices),
            f"{what}: recursive-LPA flags differ from the CPU's")
    dq = abs(community_q(gpu) - community_q(cpu))
    require(dq <= COMMUNITY_Q_TOL, f"{what}: Q differs by {dq:.3g}")
    _lof_close(gpu.lof, cpu.lof, what)
    lof_rel = float((np.abs(gpu.lof - cpu.lof) / np.abs(cpu.lof)).max())
    return {"q_abs_diff": dq, "lof_max_rel_diff": lof_rel}


def _op_graphs(table, device, weighted: bool):
    """The symmetric graph and the directed one of an edge table on
    ``device``, with the table's weights or the quarter weights of phase 4
    for the weighted shortest paths."""
    from graphmine_tpu_torch.graph.container import build_graph

    w = table.weights if weighted else None
    graph = build_graph(table.src, table.dst, num_vertices=table.num_vertices,
                        edge_weights=w, device=device)
    digraph = build_graph(table.src, table.dst, num_vertices=table.num_vertices,
                          symmetric=False, edge_weights=w, device=device)
    sp_w = (table.weights if weighted
            else np.random.default_rng(7).integers(1, 16, table.num_edges) / 4)
    return graph, digraph, np.asarray(sp_w, np.float32)


def community_small(work: Path, devices=("cuda", "cpu")) -> dict:
    """Phase 8a: Louvain and Leiden through ``run_pipeline`` on phase 4's
    4,096-vertex graph, unweighted and in quarter weights, card against
    CPU (:func:`check_community`); a Louvain run's store published and
    loaded back under the fingerprint; then every op of the graph-ops
    surface on the same graph, card against CPU (:func:`check_ops`)."""
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    small = work / "small.txt"
    summary, results = {}, {}
    reset_launches()  # the CPU runs launch nothing
    for method in ("louvain", "leiden"):
        for weighted in (False, True):
            case = f"{method}{'_weighted' if weighted else ''}"
            runs, walls = {}, {}
            for d in devices:
                cfg = dict(data_path=str(small), data_format="edgelist",
                           community_method=method, outlier_method="both",
                           lof_k=SMALL_LOF_K, lof_impl="exact", device=d)
                if weighted:
                    cfg["edge_weight_col"] = 2
                if case == "louvain":
                    cfg["snapshot_out"] = str(work / f"community_store_{d}")
                t0 = time.perf_counter()
                runs[d] = run_pipeline(PipelineConfig(**cfg))
                walls[d] = time.perf_counter() - t0
            gpu, cpu = (runs[d] for d in devices)
            diffs = check_community(gpu, cpu, case)
            summary[case] = {"communities": gpu.num_communities, "q": community_q(gpu),
                             **diffs, "seconds_card": walls[devices[0]],
                             "seconds_cpu": walls[devices[1]],
                             "phase_seconds": gpu.metrics.phase_seconds()[method]}
            results[case] = runs
            log(f"community 8a, {case}: card == CPU, {summary[case]}")
    gpu = results["louvain"][devices[0]]
    fp = graph_fingerprint(gpu.edge_table.src, gpu.edge_table.dst)
    for d in devices:
        snap = SnapshotStore(str(work / f"community_store_{d}")).load(fingerprint=fp)
        require(snap is not None and np.array_equal(snap["labels"], gpu.labels),
                f"community store ({d}): labels")
    summary["launches"] = read_launches()
    summary["store_version"] = snap.version
    outs = []
    for d in devices:
        res = results["louvain"][d]
        graph, digraph, sp_w = _op_graphs(res.edge_table, d, weighted=False)
        out, secs = graph_ops(graph, digraph, sp_w, res.labels, results["leiden"][d].labels)
        outs.append(out)
        summary.setdefault("ops_seconds_card", secs)
    check_ops(outs[0], outs[1], "8a ops")
    return summary


def check_community_line(line: dict) -> dict:
    """The ``community`` line carries every key of COMMUNITY_KEYS."""
    missing = [k for k in COMMUNITY_KEYS if k not in line]
    require(not missing, f"community line lacks {missing}")
    return line


def ops_line(outputs: dict, seconds: dict) -> dict:
    """The ``ops`` line: each op's seconds and a summary of its output."""
    missing = [k for k in OPS if k not in seconds or k not in outputs]
    require(not missing, f"ops line lacks {missing}")
    scc = np.asarray(outputs["strongly_connected_components"])
    dist = np.asarray(outputs["bfs_distances"])
    from graphmine_tpu_torch.ops.paths import UNREACHABLE

    return {
        "seconds": {k: seconds[k] for k in OPS},
        "scc_count": int(len(np.unique(scc))),
        "scc_largest": int(np.bincount(np.unique(scc, return_inverse=True)[1]).max()),
        "bfs_reached": int((dist < UNREACHABLE).sum()),
        "bfs_depth": int(dist[dist < UNREACHABLE].max(initial=0)),
        "bfs_paths": len(outputs["bfs"]),
        "max_core": int(np.asarray(outputs["core_numbers"]).max(initial=0)),
        "motif_matches": int(outputs["find_motifs"]["num_matches"]),
        "degree_assortativity": float(outputs["degree_assortativity"]),
        "reciprocity": float(outputs["reciprocity"]),
        "density": float(outputs["density"]),
        "diameter": int(outputs["diameter"]),
        "adjusted_rand_index": float(outputs["adjusted_rand_index"]),
        "normalized_mutual_info": float(outputs["normalized_mutual_info"]),
    }


def check_full_ops(outputs: dict, v: int) -> None:
    """What phase 8b can hold the full-size ops to without a reference:
    shapes, ranges and the ops' own invariants."""
    from graphmine_tpu_torch.ops.paths import UNREACHABLE

    dist, (d2, parent) = outputs["bfs_distances"], outputs["bfs_parents"]
    require(dist.shape == (v,) and dist[0] == 0 and np.array_equal(dist, d2), "8b: BFS")
    reached = (dist < UNREACHABLE) & (dist > 0)
    require(bool((dist[parent[reached]] == dist[reached] - 1).all()), "8b: BFS parents")
    sp = outputs["shortest_paths"]
    require(sp.shape == (v, OPS_LANDMARKS), "8b: shortest_paths shape")
    scc = outputs["strongly_connected_components"]
    require(scc.shape == (v,) and bool(((scc >= 0) & (scc < v)).all())
            and bool((scc[scc] == scc).all()), "8b: SCC ids are not member representatives")
    core = outputs["core_numbers"]
    require(bool((core >= 0).all()) and bool((core <= outputs["degrees"]).all()), "8b: cores")
    require(np.array_equal(outputs["degrees"], outputs["in_degrees"] + outputs["out_degrees"]),
            "8b: degrees")
    wsp = outputs["weighted_shortest_paths"]
    require(bool(np.isfinite(wsp[dist < UNREACHABLE]).all()), "8b: weighted distances")
    require(0.0 <= outputs["adjusted_rand_index"] <= 1.0
            and 0.0 <= outputs["normalized_mutual_info"] <= 1.0, "8b: ARI / NMI")


def level0_breakdown(graph) -> dict:
    """Louvain's first level taken apart on ``graph``'s device: the host
    level build, one sweep alone, the local moves to their stop rule and
    the host contraction, each ending in a synchronise."""
    from graphmine_tpu_torch.ops import louvain as lv

    def timed(fn):
        _sync_device(graph.device)
        t0 = time.perf_counter()
        out = fn()
        _sync_device(graph.device)
        return out, time.perf_counter() - t0

    level, build_s = timed(lambda: lv._level_from_graph(graph))
    moves = lambda sweeps: lv._local_moves(
        level.recv, level.send, level.weight, level.self_weight,
        num_vertices=len(level.self_weight), gamma=1.0, max_sweeps=sweeps, device=graph.device)
    _, one_sweep_s = timed(lambda: moves(1))
    comm, moves_s = timed(lambda: moves(32))
    comm = comm.cpu().numpy()
    (new_level, _), contract_s = timed(lambda: lv._contract(level, comm))
    return {"padded_messages": len(level.recv), "padded_vertices": len(level.self_weight),
            "level_build_seconds": build_s, "one_sweep_seconds": one_sweep_s,
            "local_moves_seconds": moves_s, "contract_seconds": contract_s,
            "communities_after": new_level.num_vertices}


def community_full(parquet: Path) -> None:
    """Phase 8b: Leiden through ``run_pipeline`` on phase 5's parquet file
    (``batch_rows`` of phase 5, ``lof_impl="exact"``: the fast instance
    at its full shape), then Louvain on that run's graph, then every op of
    the graph-ops surface on the first 1/``FULL_OPS_EDGE_SHARE`` of its
    edges; prints the ``community`` and ``ops`` lines."""
    import torch

    from graphmine_tpu_torch.ops.louvain import louvain
    from graphmine_tpu_torch.pipeline import PipelineConfig

    res, wall, launches, peak = drive(
        PipelineConfig(data_path=str(parquet), batch_rows=BATCH_ROWS, community_method="leiden",
                       outlier_method="both", lof_k=LOF_K, lof_impl="exact", device="cuda"),
        "leiden path")
    require(launches["knn_topk"] >= 1, "the Leiden path never launched knn_topk")
    v = res.graph.num_vertices
    require(res.labels.shape == (v,) and 1 < res.num_communities < v, "8b: Leiden labels")
    require(bool(np.isfinite(res.lof).all()), "8b: LOF scores not finite")
    m = res.metrics
    (comm,) = m.of_phase("communities")
    q = community_q(res)
    require(abs(q - comm["modularity"]) <= 1e-6 and q > 0, f"8b: Q {q} against {comm}")
    sizes = np.bincount(res.labels)
    t0 = time.perf_counter()
    lv_labels, lv_q = louvain(res.graph)
    torch.cuda.synchronize()
    lv_s = time.perf_counter() - t0
    lv_sizes = np.bincount(lv_labels.cpu().numpy())
    (lof_sel,) = [r for r in m.of_phase("impl_selected") if r["op"] == "lof_knn"]
    line = check_community_line({
        "method": "leiden",
        "graph": f"planted_anomaly_graph({V_MAIN}, {E_MAIN}, seed={SEED_MAIN})",
        "vertices": v, "edges": res.graph.num_edges, "wall_seconds": wall,
        "phase_seconds": m.phase_seconds(), "q": q, "communities": res.num_communities,
        "largest": int(sizes.max()), "peak_device_bytes": peak, "launches": launches,
        "lof_impl": lof_sel["impl"], "louvain_seconds": lv_s, "louvain_q": lv_q,
        "louvain_communities": int((lv_sizes > 0).sum()), "louvain_largest": int(lv_sizes.max()),
        "louvain_level0": level0_breakdown(res.graph),
    })
    print(json.dumps({"community": line}), flush=True)
    table = res.edge_table
    keep = table.num_edges // FULL_OPS_EDGE_SHARE
    graph, digraph, sp_w = _op_graphs(
        dataclasses.replace(table, src=table.src[:keep], dst=table.dst[:keep], weights=None),
        "cuda", weighted=False)
    outputs, seconds = graph_ops(graph, digraph, sp_w, res.labels, lv_labels)
    check_full_ops(outputs, v)
    print(json.dumps({"ops": ops_line(outputs, seconds)}), flush=True)


# ---- 9. the GraphFrames entry point -----------------------------------------

EMBED_DIM, EMBED_MIN_COS = 8, 0.9999
FRAMES_LOF_K = 20
PPR_SOURCES = {"small": 8, "full": 16}
LINK_PAIRS = {"small": 4096, "full": 250_000}  # cut from 1,000,000 for the time limit
# 8b's ops and 9b run on the first quarter of phase 5's edges (not all of
# them), to keep the smoke inside its time limit
FULL_OPS_EDGE_SHARE = 4
LINK_SAMPLE = 256  # pairs held to each formula at full size
TRUSS_K, TRUSS_SAMPLE = 4, 4096
BETWEENNESS_SOURCES, BETWEENNESS_BATCH = 64, 8  # full size; 9a runs them all
SVDPP_RANK, SVDPP_EPOCHS = 10, 20
FIXED_ITERS = {"hits": 30, "eigenvector": 100, "katz": 100}  # 9a, at tol=0
PAGERANK_FULL = {"alpha": 0.85, "max_iter": 20}
PAGERANK_CPU_RTOL = 1e-4
FRAMES_OP_LIMIT_S = 60.0
SHIM_V, SHIM_ROWS, SHIM_NULLS = 1 << 16, 500_000, 64  # cut from 1,000,000 rows
LINK_METHODS = ("common_neighbors", "jaccard", "adamic_adar", "resource_allocation",
                "preferential_attachment")
FRAMES_OPS = ("pagerank", "pagerank_weighted", "pagerank_reset", "ppr", "hits",
              "eigenvector", "katz", "closeness", "betweenness", "mis", "greedy_color",
              "k_truss", *(f"link_{m}" for m in LINK_METHODS), "spectral_embedding",
              "svd_plus_plus", "lof_scores")
FRAMES_KEYS = ("graph", "vertices", "edges", "batch_rows", "load_seconds", "seconds",
               "peak_device_bytes", "launches", "pagerank_cpu_seconds",
               "pagerank_cpu_max_rel_diff", "mis_size", "colors", "k_truss_edges",
               "svdpp_rmse", "reduced")
FRAMES_SMALL_KEYS = ("vertices", "edges", "seconds_card", "seconds_cpu", "max_abs_diff",
                     "embedding_min_cos", "lof_max_rel_diff", "launches", "shim_seconds",
                     "shim_stdout_lines")
COMPAT_KEYS = ("graph", "rows", "null_rows", "vertices", "communities", "stage_seconds",
               "wall_seconds", "api_seconds", "device", "reduced")
# A pyspark + GraphFrames script with the reference's idioms: the parquet
# read, the four renames, the SQL null filter, the RDD vertex dictionary, a
# per-row UDF for the endpoint ids, GraphFrame(v, e), labelPropagation,
# pageRank, and the driver-side census loop. Stage markers go to stderr;
# the labels are written to labels.parquet.
SHIM_SCRIPT = r'''
import hashlib
import sys
import time

from graphframes import GraphFrame
from pyspark import SparkContext
from pyspark.sql import SparkSession, SQLContext
from pyspark.sql.functions import desc, udf

T0 = time.perf_counter()


def stage(name):
    print("stage %s %.6f" % (name, time.perf_counter() - T0), file=sys.stderr, flush=True)


sc = SparkContext("local[*]")
spark = SparkSession.builder.appName("CommunityDetection").getOrCreate()
sqlContext = SQLContext(sc)
df = spark.read.parquet("data/outlinks_pq")
print(df.count())
df = (df.withColumnRenamed("_c0", "ParentURL").withColumnRenamed("_c1", "ParentDomain")
      .withColumnRenamed("_c2", "ChildDomain").withColumnRenamed("_c3", "ChildURL"))
df = df.filter("ParentDomain is not null and ChildDomain is not null")
print(df.count())
stage("read")
domains = df.select("ParentDomain", "ChildDomain").rdd.flatMap(lambda x: x).distinct()
print(domains.count())


def NodeHash(name):
    return hashlib.sha1(name.encode("utf-8")).hexdigest()[:16]


vertices = domains.map(lambda x: (NodeHash(x), x)).toDF(["id", "name"])
node_hash = udf(NodeHash)
edges = (df.select("ParentDomain", "ChildDomain")
         .withColumn("src", node_hash("ParentDomain"))
         .withColumn("dst", node_hash("ChildDomain")).select("src", "dst"))
stage("vertices_edges")
graph = GraphFrame(vertices, edges)
stage("graphframe")
communities = graph.labelPropagation(maxIter=5).persist()
print(communities.select("label").distinct().count(), "Communities in the Dataset.")
stage("label_propagation")
communities.select("name", "label").write.mode("overwrite").parquet("labels.parquet")
stage("write")
ranks = graph.pageRank(resetProbability=0.15, maxIter=10).vertices.collect()
print("pagerank sum %.4f top %s" % (sum(r["pagerank"] for r in ranks),
                                    max(ranks, key=lambda r: r["pagerank"])["name"]))
stage("pagerank")
census = communities.groupBy("label").count().sort(desc("count")).collect()
for row in census[:10]:
    members = communities.filter(communities.label == row["label"]).collect()
    print("Vertices in", row["label"], ":", row["count"], sorted(r["name"] for r in members)[:3])
stage("census")
'''


def write_outlinks(path: Path, src: np.ndarray, dst: np.ndarray, num_vertices: int,
                   null_rows: int, seed: int = 3) -> None:
    """A CommonCrawl-shaped outlinks parquet file: ``_c0`` parent URL,
    ``_c1`` parent domain, ``_c2`` child domain, ``_c3`` child URL, one
    row per edge (``d<id:07d>.example`` domains), with ``null_rows``
    seeded rows whose parent or child domain is null."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    names = np.array([f"d{i:07d}.example" for i in range(num_vertices)], dtype=object)
    parent, child = names[src], names[dst]
    null = np.random.default_rng(seed).choice(len(src), null_rows, replace=False)
    parent[null[: null_rows // 2]] = None
    child[null[null_rows // 2:]] = None
    url = lambda doms: pa.array([None if d is None else f"http://{d}/page" for d in doms])
    path.parent.mkdir(parents=True, exist_ok=True)
    pq.write_table(pa.table({"_c0": url(parent), "_c1": pa.array(parent, pa.string()),
                             "_c2": pa.array(child, pa.string()), "_c3": url(child)}), path)


def run_shim(cwd: Path, device: str, timeout: float = 900.0) -> tuple:
    """:data:`SHIM_SCRIPT` through ``python -m graphmine_tpu_torch.compat
    --device DEVICE`` in ``cwd`` (which holds ``data/outlinks_pq``):
    ``(stdout, {stage: seconds}, wall seconds)``; fails on a non-zero
    exit."""
    script = cwd / "script.py"
    script.write_text(SHIM_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "graphmine_tpu_torch.compat", "--device", device,
                          "--cwd", str(cwd), str(script)], capture_output=True, text=True,
                         timeout=timeout, env=env)
    wall = time.perf_counter() - t0
    require(out.returncode == 0, f"the shim on {device} exited {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
    marks = [ln.split() for ln in out.stderr.splitlines() if ln.startswith("stage ")]
    stamps = {name: float(t) for _, name, t in marks}
    names = list(stamps)
    stages = {n: stamps[n] - (stamps[names[i - 1]] if i else 0.0) for i, n in enumerate(names)}
    return out.stdout, stages, wall


def _sample_pairs(v: int, n: int, seed: int) -> np.ndarray:
    """``n`` seeded vertex pairs ``[n, 2]`` with distinct ends."""
    rng = np.random.default_rng(seed)
    u = rng.integers(0, v, n)
    w = (u + rng.integers(1, v, n)) % v
    return np.stack([u, w], axis=1).astype(np.int64)


def frames_inputs(gf, size: str, weights=None) -> dict:
    """The seeded inputs of phase 9's ops on ``gf``'s graph: PPR sources,
    closeness landmarks, the betweenness sources (all at small size), the
    reset vector, link-prediction pairs, ratings, Katz's ``alpha`` (half
    the inverse of the largest message degree, below 1/λ_max) and SVD++'s
    starting model (host arrays)."""
    v, e = gf.num_vertices, gf.num_edges
    rng = np.random.default_rng(11)
    max_deg = int(gf.graph().degrees().max())
    scale = 0.1 / np.sqrt(SVDPP_RANK)
    return {
        "weights": weights,
        "reset": rng.random(v).astype(np.float32),
        "ppr_sources": rng.choice(v, PPR_SOURCES[size], replace=False),
        "landmarks": rng.choice(v, OPS_LANDMARKS, replace=False),
        "bc_sources": None if size == "small" else rng.choice(v, BETWEENNESS_SOURCES,
                                                              replace=False),
        "pairs": _sample_pairs(v, LINK_PAIRS[size], seed=12),
        "ratings": rng.integers(1, 6, e).astype(np.float32),
        "katz_alpha": 0.5 / max(max_deg, 1),
        "svdpp_init": [(rng.normal(size=(v, SVDPP_RANK)) * scale).astype(np.float32)
                       for _ in range(3)],
    }


def frames_ops(gf, inputs: dict, size: str) -> tuple:
    """Each op of phase 9 once through ``gf``: ``(outputs on the host,
    seconds per op)``. At small size the power iterations run a fixed
    count at ``tol=0``; at full size with their defaults."""
    import torch

    from graphmine_tpu_torch.ops.svdpp import SVDPlusPlusModel

    dev = gf.device
    small = size == "small"
    fixed = lambda name: {"tol": 0.0, "max_iter": FIXED_ITERS[name]} if small else {}
    pr_kw = {} if small else dict(PAGERANK_FULL)
    init = inputs["svdpp_init"]

    def svdpp():
        mu = float(np.float32(inputs["ratings"].mean()))
        start = SVDPlusPlusModel.from_numpy(*init, np.zeros(gf.num_vertices),
                                            np.zeros(gf.num_vertices), mu, device=dev)
        model, rmse = gf.svd_plus_plus(inputs["ratings"], rank=SVDPP_RANK,
                                       max_iter=SVDPP_EPOCHS, init=start)
        return [rmse, model.p, model.q, model.y, model.bu, model.bi]

    calls = {
        "pagerank": lambda: gf.pagerank(**pr_kw),
        "pagerank_weighted": lambda: gf.pagerank(weights=inputs["weights"], **pr_kw),
        "pagerank_reset": lambda: gf.pagerank(reset=inputs["reset"], **pr_kw),
        "ppr": lambda: gf.parallel_personalized_pagerank(inputs["ppr_sources"]),
        "hits": lambda: list(gf.hits(**fixed("hits"))),
        "eigenvector": lambda: gf.eigenvector_centrality(**fixed("eigenvector")),
        "katz": lambda: gf.katz_centrality(alpha=inputs["katz_alpha"], **fixed("katz")),
        "closeness": lambda: gf.closeness_centrality(vertices=inputs["landmarks"]),
        "betweenness": lambda: gf.betweenness_centrality(
            sources=inputs["bc_sources"], source_batch=BETWEENNESS_BATCH),
        "mis": lambda: gf.maximal_independent_set(seed=0),
        "greedy_color": lambda: gf.greedy_color(seed=0),
        "k_truss": lambda: list(gf.k_truss(TRUSS_K)),
        **{f"link_{m}": (lambda m=m: gf.link_prediction(inputs["pairs"], method=m))
           for m in LINK_METHODS},
        "spectral_embedding": lambda: gf.spectral_embedding(dim=EMBED_DIM),
        "svd_plus_plus": svdpp,
        "lof_scores": lambda: gf.lof_scores(k=FRAMES_LOF_K, lof_impl="exact"),
    }
    assert tuple(calls) == FRAMES_OPS
    if inputs["weights"] is None:
        del calls["pagerank_weighted"]
    outputs, seconds = {}, {}
    for name, call in calls.items():
        _sync_device(dev)
        t0 = time.perf_counter()
        value = call()
        _sync_device(dev)
        seconds[name] = time.perf_counter() - t0
        outputs[name] = _host(value)
        log(f"frames op {name} on {dev}: {seconds[name]:.3f} s")
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return outputs, seconds


def _aligned_cos(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Per-column |cos| between two embeddings (the sign of a column is
    arbitrary)."""
    num = np.abs((got * want).sum(axis=0))
    return num / np.maximum(np.linalg.norm(got, axis=0) * np.linalg.norm(want, axis=0), 1e-30)


def check_frames_small(got: dict, want: dict) -> dict:
    """9a: every op present on both devices; integers equal, floats within
    OPS_RTOL / OPS_ATOL, the embedding's columns |cos| >= EMBED_MIN_COS,
    LOF within phase 4's tolerances. Returns the largest differences."""
    diffs = {}
    for name in FRAMES_OPS:
        if name == "pagerank_weighted" and name not in want:
            continue
        require(name in got and name in want, f"9a: op {name} missing")
        if name == "spectral_embedding":
            cos = _aligned_cos(got[name], want[name])
            require(got[name].shape == want[name].shape and bool((cos >= EMBED_MIN_COS).all()),
                    f"9a: embedding columns |cos| {cos.min():.6f} < {EMBED_MIN_COS}")
            diffs[name] = float(cos.min())
        elif name == "lof_scores":
            _lof_close(got[name], want[name], "9a: lof_scores")
            diffs[name] = float((np.abs(got[name] - want[name]) / np.abs(want[name])).max())
        else:
            _same_value(got[name], want[name], f"9a: {name}")
            flat = lambda x: np.concatenate([np.ravel(np.asarray(a, np.float64)) for a in
                                             (x if isinstance(x, list) else [x])])
            diffs[name] = float(np.abs(flat(got[name]) - flat(want[name])).max(initial=0.0))
    return diffs


def frames_small(work: Path, devices=("cuda", "cpu")) -> dict:
    """Phase 9a: the ops through ``GraphFrame`` on phase 4's graph on the
    card and on the CPU (:func:`check_frames_small`), then the shim on
    both devices with identical stdout."""
    from graphmine_tpu_torch.frames import GraphFrame
    from graphmine_tpu_torch.io.edges import load_edge_list

    table = load_edge_list(str(work / "small.txt"), weight_col=2)
    outs, secs = {}, {}
    reset_launches()
    for d in devices:
        gf = GraphFrame.from_edge_table(table, device=d)
        inputs = frames_inputs(gf, "small", weights=table.weights)
        outs[d], secs[d] = frames_ops(gf, inputs, "small")
        if d == devices[0]:
            launches = read_launches()
    diffs = check_frames_small(outs[devices[0]], outs[devices[1]])
    from graphmine_tpu_torch import datasets

    src, dst, _, _ = datasets.planted_anomaly_graph(4096, 60_000, seed=SEED_MAIN)
    stdout, shim_s = {}, {}
    for d in devices:
        cwd = work / f"shim_small_{d}"
        write_outlinks(cwd / "data" / "outlinks_pq" / "part-00000.parquet", src, dst, 4096,
                       null_rows=SHIM_NULLS)
        stdout[d], _, shim_s[d] = run_shim(cwd, d)
    require(stdout[devices[0]] == stdout[devices[1]], "9a: the shim's stdout differs between "
            f"the devices:\n{stdout[devices[0]][:2000]}\n---\n{stdout[devices[1]][:2000]}")
    return check_keys({
        "vertices": table.num_vertices, "edges": table.num_edges,
        "seconds_card": secs[devices[0]], "seconds_cpu": secs[devices[1]],
        "max_abs_diff": {k: v for k, v in diffs.items()
                         if k not in ("spectral_embedding", "lof_scores")},
        "embedding_min_cos": diffs["spectral_embedding"],
        "lof_max_rel_diff": diffs["lof_scores"], "launches": launches,
        "shim_seconds": shim_s, "shim_stdout_lines": len(stdout[devices[0]].splitlines()),
    }, FRAMES_SMALL_KEYS, "frames_small")


def check_keys(line: dict, keys: tuple, what: str) -> dict:
    """A printed line carries every key of ``keys``."""
    missing = [k for k in keys if k not in line]
    require(not missing, f"{what} line lacks {missing}")
    return line


def _simple_adjacency(graph) -> tuple:
    """Host CSR of the simple undirected graph: ``(indptr, neighbours)``."""
    from graphmine_tpu_torch.graph.container import simple_undirected_edges

    a, b = simple_undirected_edges(graph)
    s, t = np.concatenate([a, b]), np.concatenate([b, a])
    order = np.lexsort((t, s))
    indptr = np.zeros(graph.num_vertices + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=graph.num_vertices), out=indptr[1:])
    return indptr, t[order]


def check_frames_full(outputs: dict, graph, inputs: dict) -> dict:
    """9b: what the full-size ops can be held to without a reference.
    ``graph`` is the frame's symmetric graph. Returns the line's facts."""
    v = graph.num_vertices
    f64 = lambda x: np.asarray(x, np.float64)  # sums of 262,144 terms, checked exactly
    for name in ("pagerank", "pagerank_reset"):
        pr = outputs[name]
        total = float(f64(pr).sum())
        require(pr.shape == (v,) and bool((pr >= 0).all()) and abs(total - 1) <= 1e-5,
                f"9b: {name} sums to {total!r} (least rank {pr.min()!r})")
    ppr = outputs["ppr"]
    sums = f64(ppr).sum(axis=0)
    require(ppr.shape == (v, PPR_SOURCES["full"]) and bool((ppr >= 0).all())
            and bool((np.abs(sums - 1) <= 1e-5).all()),
            f"9b: PPR shape {ppr.shape}, column sums {sums.min()!r}..{sums.max()!r}, "
            f"least value {ppr.min()!r}")
    hubs, auths = outputs["hits"]
    for name, x, norm in (("hits hubs", hubs, f64(hubs).sum()),
                          ("hits authorities", auths, f64(auths).sum()),
                          ("eigenvector", outputs["eigenvector"],
                           np.linalg.norm(f64(outputs["eigenvector"]))),
                          ("katz", outputs["katz"], np.linalg.norm(f64(outputs["katz"])))):
        require(x.shape == (v,) and bool((x >= 0).all()) and abs(float(norm) - 1) <= 1e-5,
                f"9b: {name}: norm {float(norm)!r}, least value {x.min()!r}")
    close = outputs["closeness"]
    require(close.shape == (OPS_LANDMARKS,) and bool(((close >= 0) & (close <= 1)).all()),
            "9b: closeness")
    bc = outputs["betweenness"]
    require(bc.shape == (v,) and bool(np.isfinite(bc).all()) and bool((bc >= 0).all()),
            "9b: betweenness")
    send = graph.msg_send.cpu().numpy()
    recv = graph.msg_recv.cpu().numpy()
    real = send != recv
    mis = outputs["mis"]
    require(not bool((mis[send] & mis[recv] & real).any()), "9b: MIS not independent")
    covered = np.zeros(v, bool)
    covered[recv[real & mis[send]]] = True
    require(bool((mis | covered).all()), "9b: MIS not maximal")
    colors = outputs["greedy_color"]
    require(bool((colors >= 0).all()), "9b: a vertex left uncoloured")
    require(not bool(((colors[send] == colors[recv]) & real).any()), "9b: colouring not proper")
    del send, recv, real
    ka, kb = outputs["k_truss"]
    facts = {"mis_size": int(mis.sum()), "colors": int(colors.max()) + 1,
             "k_truss_edges": int(len(ka))}
    check_truss(ka, kb, v)
    check_link_prediction(outputs, graph, inputs["pairs"])
    emb = outputs["spectral_embedding"]
    gram = emb.astype(np.float64).T @ emb.astype(np.float64)
    require(emb.shape == (v, EMBED_DIM) and np.abs(gram - np.eye(EMBED_DIM)).max() <= 1e-3,
            "9b: embedding columns not orthonormal within 1e-3")
    rmse = np.asarray(outputs["svd_plus_plus"][0])
    require(rmse.shape == (SVDPP_EPOCHS,) and bool(np.isfinite(rmse).all())
            and rmse[-1] < rmse[0], "9b: SVD++ RMSE did not fall")
    facts["svdpp_rmse"] = [float(rmse[0]), float(rmse[-1])]
    lof = outputs["lof_scores"]
    require(lof.shape == (v,) and bool(np.isfinite(lof).all()), "9b: LOF scores")
    return facts


def check_truss(a: np.ndarray, b: np.ndarray, v: int, sample: int = TRUSS_SAMPLE) -> None:
    """Each of ``sample`` seeded kept edges closes at least ``TRUSS_K - 2``
    triangles of kept edges."""
    require(bool((a < b).all()), "9b: k-truss edges not as (a < b)")
    if len(a) == 0:
        return
    s, t = np.concatenate([a, b]), np.concatenate([b, a])
    order = np.lexsort((t, s))
    indptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=v), out=indptr[1:])
    nbr = t[order]
    pick = np.random.default_rng(13).choice(len(a), min(sample, len(a)), replace=False)
    for i in pick:
        x, y = a[i], b[i]
        common = np.intersect1d(nbr[indptr[x]:indptr[x + 1]], nbr[indptr[y]:indptr[y + 1]],
                                assume_unique=True)
        require(len(common) >= TRUSS_K - 2, f"9b: k-truss edge ({x}, {y}) closes "
                                            f"{len(common)} kept triangles")


def check_link_prediction(outputs: dict, graph, pairs: np.ndarray,
                          sample: int = LINK_SAMPLE) -> None:
    """Each method's score of ``sample`` seeded pairs against its formula
    on the simple undirected graph."""
    indptr, nbr = _simple_adjacency(graph)
    deg = np.diff(indptr)
    for i in np.random.default_rng(14).choice(len(pairs), sample, replace=False):
        u, w = pairs[i]
        nu, nw = nbr[indptr[u]:indptr[u + 1]], nbr[indptr[w]:indptr[w + 1]]
        common = np.intersect1d(nu, nw, assume_unique=True)
        union = len(nu) + len(nw) - len(common)
        want = {
            "common_neighbors": float(len(common)),
            "jaccard": len(common) / union if union else 0.0,
            "adamic_adar": float(np.sum(1.0 / np.log(deg[common]))),
            "resource_allocation": float(np.sum(1.0 / deg[common])),
            "preferential_attachment": float(deg[u] * deg[w]),
        }
        for m, value in want.items():
            got = float(outputs[f"link_{m}"][i])
            require(abs(got - value) <= 1e-9 * max(1.0, abs(value)),
                    f"9b: link_{m} of ({u}, {w}) is {got}, the formula gives {value}")


def frames_full(parquet: Path, device: str = "cuda", table=None) -> dict:
    """Phase 9b: ``GraphFrame.from_edge_table`` of the first
    1/``FULL_OPS_EDGE_SHARE`` of phase 5's edges (all of its 262,144
    vertices) on ``device`` (the card), each op once (:func:`frames_ops`), held to
    :func:`check_frames_full`; PageRank against a CPU run of the port on
    the same graph. ``table`` is the file's edge table when the caller has
    it loaded (phase 5's), else it is loaded here; ``load_seconds`` counts
    the load only then. Returns the ``frames`` line, launches included."""
    import torch

    from graphmine_tpu_torch.frames import GraphFrame
    from graphmine_tpu_torch.io.edges import load_parquet_edges

    t0 = time.perf_counter()
    if table is None:
        table = load_parquet_edges(str(parquet), batch_rows=BATCH_ROWS)
    e_all = table.num_edges
    keep = e_all // FULL_OPS_EDGE_SHARE
    table = dataclasses.replace(table, src=table.src[:keep], dst=table.dst[:keep],
                                weights=None if table.weights is None else table.weights[:keep])
    gf = GraphFrame.from_edge_table(table, device=device)
    gf.graph()
    gf.graph(symmetric=False)
    _sync_device(gf.device)
    load_s = time.perf_counter() - t0
    inputs = frames_inputs(gf, "full")
    on_card = gf.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    outputs, seconds = frames_ops(gf, inputs, "full")
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() if on_card else None
    require(launches["knn_topk_fast"] >= 1 or not on_card,
            "9b: lof_scores never launched knn_topk's fast instance")
    slow = {k: s for k, s in seconds.items() if s > FRAMES_OP_LIMIT_S}
    require(not slow, f"9b: ops over {FRAMES_OP_LIMIT_S} s at full size: {slow}")
    facts = check_frames_full(outputs, gf.graph(), inputs)
    cpu = GraphFrame.from_edge_table(table, device="cpu")
    t0 = time.perf_counter()
    pr_cpu = cpu.pagerank(**PAGERANK_FULL).numpy()
    cpu_s = time.perf_counter() - t0
    del cpu
    rel = np.abs(outputs["pagerank"] - pr_cpu) / np.maximum(np.abs(pr_cpu), 1e-30)
    require(bool((rel <= PAGERANK_CPU_RTOL).all()),
            f"9b: PageRank differs from the CPU's by {rel.max():.3g} relative")
    return check_keys({
        "graph": f"planted_anomaly_graph({V_MAIN}, {E_MAIN}, seed={SEED_MAIN})",
        "vertices": gf.num_vertices, "edges": gf.num_edges, "batch_rows": BATCH_ROWS,
        "load_seconds": load_s, "seconds": seconds, "peak_device_bytes": peak,
        "launches": launches, "pagerank_cpu_seconds": cpu_s,
        "pagerank_cpu_max_rel_diff": float(rel.max()), **facts,
        "reduced": {"edges": f"the first {keep:,} of the file's {e_all:,} edges (1/"
                             f"{FULL_OPS_EDGE_SHARE}), for the smoke's time limit"},
    }, FRAMES_KEYS, "frames")


def api_partition(cwd: Path, device: str) -> tuple:
    """The partition the ``GraphFrame`` API gives on the shim's input:
    ``Table.read_parquet``, the null filter, vertices in the RDD idiom's
    order (first appearance over the rows' parent, child pairs),
    ``GraphFrame(v, e)`` and ``label_propagation(max_iter=5)``.
    ``({name: label}, seconds)``."""
    import torch

    from graphmine_tpu_torch.frames import GraphFrame
    from graphmine_tpu_torch.table import read_parquet

    t0 = time.perf_counter()
    t = read_parquet(str(cwd / "data" / "outlinks_pq"))
    t = t.filter("_c1 is not null and _c2 is not null")
    parent, child = t["_c1"], t["_c2"]
    both = np.stack([parent, child], axis=1).ravel()
    uniq, first = np.unique(both, return_index=True)
    names = uniq[np.argsort(first, kind="stable")]
    gf = GraphFrame({"id": names}, {"src": parent, "dst": child}, device=device)
    labels = gf.label_propagation(max_iter=5).cpu().numpy()
    if gf.device.type == "cuda":
        torch.cuda.synchronize()
    return dict(zip(names.tolist(), labels.tolist())), time.perf_counter() - t0


def same_partition(a: dict, b: dict) -> bool:
    """Two {name: label} maps group the same names together."""
    if a.keys() != b.keys():
        return False
    names = sorted(a)
    canon = lambda m: np.unique(np.array([m[n] for n in names]), return_inverse=True)[1]
    ga, gb = canon(a), canon(b)
    # the same grouping: each label of one side maps to one label of the other
    pairs = np.unique(np.stack([ga, gb], axis=1), axis=0)
    return len(pairs) == ga.max(initial=-1) + 1 == gb.max(initial=-1) + 1


def compat_full(work: Path, device: str = "cuda") -> dict:
    """Phase 9c: :data:`SHIM_SCRIPT` through the shim on ``device`` (the
    card) on
    ``planted_anomaly_graph(SHIM_V, SHIM_ROWS, seed=9)`` written
    CommonCrawl-shaped with SHIM_NULLS null-domain rows; its partition
    against :func:`api_partition`'s on the same file and card."""
    import pyarrow.parquet as pq

    from graphmine_tpu_torch import datasets

    src, dst, _, _ = datasets.planted_anomaly_graph(SHIM_V, SHIM_ROWS, seed=SEED_MAIN)
    cwd = work / "shim_full"
    write_outlinks(cwd / "data" / "outlinks_pq" / "part-00000.parquet", src, dst, SHIM_V,
                   null_rows=SHIM_NULLS)
    stdout, stages, wall = run_shim(cwd, device, timeout=1200.0)
    got = pq.read_table(cwd / "labels.parquet").to_pydict()
    shim = dict(zip(got["name"], got["label"]))
    api, api_s = api_partition(cwd, device)
    require(same_partition(shim, api), "9c: the shim's LPA partition differs from the "
                                       "GraphFrame API's")
    lines = stdout.splitlines()
    return check_keys({
        "graph": f"planted_anomaly_graph({SHIM_V}, {SHIM_ROWS}, seed={SEED_MAIN})",
        "rows": len(src), "null_rows": SHIM_NULLS, "vertices": len(shim),
        "communities": int(lines[3].split()[0]), "stage_seconds": stages,
        "wall_seconds": wall, "api_seconds": api_s, "device": device,
        "reduced": {"rows": f"{SHIM_ROWS:,} rows, not the e2e 25,000,000: the string Table "
                            "runs host NumPy over object arrays and the RDD idioms per row"},
    }, COMPAT_KEYS, "compat")


def run_frames(work: Path, parquet: Path, table=None) -> dict:
    """Phase 9: prints the ``frames_small``, ``frames`` and ``compat``
    lines; returns phase 9's launches per instance (9a's card run and
    9b). ``table``: the parquet file's edge table, when loaded."""
    small = frames_small(work)
    print(json.dumps({"frames_small": small}), flush=True)
    full = frames_full(parquet, table=table)
    print(json.dumps({"frames": full}), flush=True)
    print(json.dumps({"compat": compat_full(work)}), flush=True)
    return {k: small["launches"][k] + full["launches"][k] for k in full["launches"]}


def with_frames_launches(entries: list, frames_launches: dict) -> list:
    """The ``kernels`` entries, each with phase 9's launch count of its
    instance (``frames_launches``)."""
    return [{**e, "frames_launches": frames_launches[f"knn_topk_{e['instance']}"]}
            for e in entries]


# ---- 10. the blocked superstep family ----------------------------------------

# 10c's ladder: R-MAT graphs at the com-LiveJournal rung's edge factor,
# drawn on the card; at the rung's scale, the bin budgets swept
BLOCKED_SCALES = (20, 21, 22, 23, 24)
BLOCKED_EDGE_FACTOR = 8.3
BLOCKED_SWEEP_SCALE = 22
BLOCKED_TILE_SWEEP = (1 << 16, 1 << 18, 1 << 20)
BLOCKED_REPS = 5
BLOCKED_SMALL_TILE = 2048  # 10a's bin budget: ~60 bins on phase 4's graph
RUNG = "com-livejournal"
RUNG_LPA_STEPS = 5
RUNG_PR_ITERS = 20
# The ``blocked`` line's keys (tests/test_torch_chip_smoke.py holds them).
BLOCKED_KEYS = ("rung", "num_vertices", "num_edges", "num_messages", "load_seconds",
                "graph_build_seconds", "plan_build_seconds", "ms_per_superstep", "cc",
                "pagerank", "bins", "tile_slots", "tile_alloc_over_m",
                "padded_slots_per_edge", "peak_bytes", "predicted_bytes")
LADDER_KEYS = ("scale", "num_vertices", "num_messages", "bucketed_ms", "blocked_ms",
               "blocked_over_bucketed", "random_gather_slots_per_sec",
               "binned_pass_slots_per_sec", "binned_over_random", "bins", "tile_slots",
               "tile_alloc_over_m", "peak_bytes", "plan_build_seconds")


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def one_ms(fn, device) -> tuple:
    """``(ms, result)`` of one run of ``fn()``: CUDA events on the card,
    the host clock elsewhere."""
    import torch

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return 1e3 * (time.perf_counter() - t0), out
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def timed_ms(fn, device, reps: int = BLOCKED_REPS) -> tuple:
    """``(median ms, last result)`` of ``reps`` runs of ``fn()`` after one
    warm-up run."""
    fn()
    _sync(device)
    runs = [one_ms(fn, device) for _ in range(reps)]
    return float(np.median([ms for ms, _ in runs])), runs[-1][1]


def rmat_graph(scale: int, edge_factor: float, seed: int, device):
    """An R-MAT graph (``datasets.rmat``'s recipe: quadrants 0.57 / 0.19 /
    0.19, a random relabelling, duplicates kept) drawn on ``device`` from a
    ``torch.Generator``, with its message CSR built there: ``(graph, host
    row pointers)``."""
    import torch

    from graphmine_tpu_torch.graph.container import Graph, _message_csr

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    v, (a, b, c) = 1 << scale, (0.57, 0.19, 0.19)
    e = int(edge_factor * v)
    src = torch.zeros(e, dtype=torch.int64, device=device)
    dst = torch.zeros_like(src)
    for _ in range(scale):
        r = torch.rand(e, generator=gen, device=device)
        src = (src << 1) | (r >= a + b)
        dst = (dst << 1) | (((r >= a) & (r < a + b)) | (r >= a + b + c))
    perm = torch.randperm(v, generator=gen, device=device)
    src, dst = perm[src].to(torch.int32), perm[dst].to(torch.int32)
    del perm, r
    ptr, recv, send, _ = _message_csr(src, dst, v, True)
    graph = Graph(src=src, dst=dst, msg_recv=recv, msg_send=send, msg_ptr=ptr.to(torch.int32),
                  num_vertices=v)
    return graph, ptr.cpu().numpy()


def blocked_small(work: Path, devices=("cuda", "cpu")) -> dict:
    """Phase 10a on phase 4's graph, unweighted and in quarter weights: the
    blocked plan built on the card equal to the CPU's array for array;
    every LPA and CC superstep card == CPU == the bucketed superstep on the
    card; ``blocked_inflow`` and PageRank on a ``BlockedPlan`` card against
    CPU within rtol 1e-5; then ``run_pipeline`` with
    ``GRAPHMINE_SUPERSTEP_FAMILY=blocked`` against the default (bucketed)
    run on the card (labels, flags and census equal, LOF within phase 4's
    tolerances), and the blocked run with a real out-of-memory error at
    superstep 3, which must take the ``single_bucketed`` rung and end on
    the uninterrupted labels."""
    import torch

    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.blocking import (
        BlockedPlan,
        blocked_inflow,
        build_graph_and_blocked_plan,
        cc_superstep_blocked,
        lpa_superstep_blocked,
    )
    from graphmine_tpu_torch.ops.bucketed_mode import BucketedModePlan, lpa_superstep_bucketed
    from graphmine_tpu_torch.ops.cc import cc_superstep_bucketed
    from graphmine_tpu_torch.ops.pagerank import pagerank
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from graphmine_tpu_torch.testing import faults

    card, host = devices
    v = 4096
    src, dst, _, _ = datasets.planted_anomaly_graph(v, 60_000, seed=SEED_MAIN)
    quarters = np.random.default_rng(7).integers(1, 16, len(src)) / 4
    summary: dict = {}
    for weighted in (False, True):
        w = quarters.astype(np.float32) if weighted else None
        built = {d: build_graph_and_blocked_plan(src, dst, num_vertices=v, edge_weights=w,
                                                 tile_slots=BLOCKED_SMALL_TILE, device=d)
                 for d in devices}
        (g, p), (hg, hp) = built[card], built[host]
        for name in ("src_sorted", "scatter_pos", "row_idx", "row_vertex", "weight_mat"):
            a, b = getattr(p, name), getattr(hp, name)
            a, b = (a, b) if isinstance(a, tuple) or a is None else ((a,), (b,))
            require((a is None) == (b is None) and len(a or ()) == len(b or ()) and all(
                torch.equal(x.cpu(), y) for x, y in zip(a or (), b or ())),
                f"10a: the plan's {name} differs between the card and the CPU")
        require((p.num_bins, p.tile_slots, p.tile_alloc) == (hp.num_bins, hp.tile_slots,
                                                            hp.tile_alloc), "10a: plan sizes")
        bp = BucketedModePlan.from_ptr(g.msg_ptr.cpu().numpy(), v, g.msg_send,
                                       weights=g.msg_weight)
        lbl = torch.arange(v, dtype=torch.int32, device=card)
        for step in range(RUNG_LPA_STEPS):
            new = lpa_superstep_blocked(lbl, g, p)
            require(torch.equal(new, lpa_superstep_bucketed(lbl, g, bp)), f"10a: LPA superstep "
                    f"{step + 1} differs from the bucketed superstep")
            require(torch.equal(new.cpu(), lpa_superstep_blocked(lbl.to(host), hg, hp)),
                    f"10a: LPA superstep {step + 1} differs from the CPU's")
            lbl = new
        lbl, cc_steps = torch.arange(v, dtype=torch.int32, device=card), 0
        while True:
            new = cc_superstep_blocked(lbl, p)
            cc_steps += 1
            require(torch.equal(new, cc_superstep_bucketed(lbl, bp)) and torch.equal(
                new.cpu(), cc_superstep_blocked(lbl.to(host), hp)),
                f"10a: CC superstep {cc_steps} differs (bucketed or CPU)")
            if torch.equal(new, lbl):
                break
            lbl = new
        summary["weighted" if weighted else "unweighted"] = {
            "bins": p.num_bins, "tile_slots": p.tile_slots,
            "tile_alloc_over_m": p.tile_alloc / p.num_messages, "cc_supersteps": cc_steps}
    # PageRank's inflow on a directed graph's plan, card against CPU
    gd = {d: build_graph(src, dst, num_vertices=v, symmetric=False, device=d) for d in devices}
    pd = {d: BlockedPlan.from_graph(gd[d], tile_slots=BLOCKED_SMALL_TILE) for d in devices}
    contrib = np.random.default_rng(3).random(v).astype(np.float32)
    flows = [blocked_inflow(pd[d], torch.from_numpy(contrib).to(d)).cpu().numpy()
             for d in devices]
    np.testing.assert_allclose(flows[0], flows[1], rtol=1e-5)
    ranks = [pagerank(gd[d], tol=0.0, max_iter=RUNG_PR_ITERS, plan=pd[d]).cpu().numpy()
             for d in devices]
    np.testing.assert_allclose(ranks[0], ranks[1], rtol=1e-5)
    summary["pagerank_max_rel"] = float(np.max(np.abs(ranks[0] - ranks[1]) / ranks[1]))
    # the pipeline on the blocked family against the bucketed default
    small = work / "small.txt"
    if not small.exists():
        small_inputs(work)
    for weighted in (False, True):
        cfg = dict(data_path=str(small), data_format="edgelist", outlier_method="both",
                   lof_k=SMALL_LOF_K, lof_impl="exact", device=card)
        if weighted:
            cfg["edge_weight_col"] = 2
        base = run_pipeline(PipelineConfig(**cfg))
        with mock.patch.dict(os.environ, GRAPHMINE_SUPERSTEP_FAMILY="blocked"):
            got = run_pipeline(PipelineConfig(**cfg))
            inj = faults.FaultInjector().add("lpa_superstep",
                                             lambda: faults.device_oom(card), at=3)
            with inj.installed():
                oom = run_pipeline(PipelineConfig(**cfg))
        case = "weighted" if weighted else "unweighted"
        for res, what in ((got, "blocked"), (oom, "blocked under OOM")):
            require(np.array_equal(res.labels, base.labels), f"10a {case}: {what} labels "
                    "differ from the bucketed run's")
            require(np.array_equal(res.outliers.outlier_vertices,
                                   base.outliers.outlier_vertices), f"10a {case}: {what} flags")
            for x, y in zip(res.community_table, base.community_table):
                require(np.array_equal(x, y), f"10a {case}: {what} census")
            _lof_close(res.lof, base.lof, f"10a {case}: {what} against the bucketed run")
        (sel,) = [r for r in got.metrics.of_phase("impl_selected") if r["op"] == "lpa_superstep"]
        require(sel["impl"] == "blocked", f"10a {case}: the driver ran {sel['impl']}")
        (deg,) = oom.metrics.of_phase("degrade")
        fams = [r["family"] for r in oom.metrics.of_phase("plan_build")]
        require(deg["to"] == "single_bucketed" and fams == ["blocked", "bucketed"],
                f"10a {case}: the OOM took {deg['to']} with plans {fams}")
        summary[case]["pipeline"] = {"communities": got.num_communities,
                                     "degrade": deg["to"], "plans": fams}
        log(f"10a {case}: blocked == bucketed == CPU; OOM -> {deg['to']}")
    return summary


def blocked_rung(device="cuda", max_scale=None) -> dict:
    """Phase 10b: the com-LiveJournal rung at full size, loaded on the host
    (its R-MAT stand-in when no SNAP file is on disk), its graph and both
    plans on the card. LPA: 5 supersteps per family, labels bit-equal. CC:
    to the fixpoint per family, labels and superstep counts equal.
    PageRank: 20 iterations on the directed graph, blocked against the
    segment path, L1 <= 1e-5 and max relative <= 1e-4. Returns the
    ``blocked`` line: seconds of the load, the graph and each plan build,
    ms per superstep of each family (blocked with its tile pass and its
    reduce apart), bins, ``tile_slots``, ``tile_alloc / M``, padded slots
    per edge, peak device bytes beside ``memmodel``'s prediction.
    ``max_scale`` caps the stand-in's scale (the CPU tests' small run)."""
    import torch

    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.obs import memmodel
    from graphmine_tpu_torch.ops.blocking import (
        _SENTINEL,
        BlockedPlan,
        _blocked_tile,
        build_family_plan,
        plan_build_stats,
        timed_plan_build,
    )
    from graphmine_tpu_torch.ops.cc import connected_components
    from graphmine_tpu_torch.ops.lpa import label_propagation
    from graphmine_tpu_torch.ops.pagerank import pagerank

    t0 = time.perf_counter()
    table = datasets.load(RUNG, seed=0, max_scale=max_scale)
    load_s = time.perf_counter() - t0
    v, e = table.num_vertices, table.num_edges
    t0 = time.perf_counter()
    graph = build_graph(table.src, table.dst, num_vertices=v, device=device)
    _sync(device)
    build_s = time.perf_counter() - t0
    m = graph.num_messages
    out: dict = {"rung": RUNG, "num_vertices": v, "num_edges": e, "num_messages": m,
                 "load_seconds": load_s, "graph_build_seconds": build_s,
                 "plan_build_seconds": {}, "ms_per_superstep": {}, "cc": {},
                 "peak_bytes": {}, "predicted_bytes": {}}
    labels, cc = {}, {}
    for family in ("bucketed", "blocked"):
        plan, secs = timed_plan_build(lambda: build_family_plan(graph, family))
        out["plan_build_seconds"][family] = secs
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        ms, labels[family] = timed_ms(
            lambda: label_propagation(graph, RUNG_LPA_STEPS, plan=plan), device, reps=1)
        out["ms_per_superstep"][family] = ms / RUNG_LPA_STEPS
        if torch.device(device).type == "cuda":
            out["peak_bytes"][family] = torch.cuda.max_memory_allocated()
        out["predicted_bytes"][family] = memmodel.superstep_footprint(
            "lpa_superstep", "auto", v, m, num_edges=e, plan=plan).total_bytes
        t0 = time.perf_counter()
        cc[family] = connected_components(graph, plan=plan, return_iterations=True)
        _sync(device)
        out["cc"][f"{family}_seconds"] = time.perf_counter() - t0
        if family == "blocked":
            tile_ms, _ = timed_ms(lambda: _blocked_tile(plan, labels[family], _SENTINEL), device)
            out["ms_per_superstep"]["blocked_tile"] = tile_ms
            out["ms_per_superstep"]["blocked_reduce"] = out["ms_per_superstep"]["blocked"] - tile_ms
            stats = plan_build_stats(plan, e)
            out.update(bins=plan.num_bins, tile_slots=plan.tile_slots,
                       tile_alloc_over_m=plan.tile_alloc / m,
                       padded_slots_per_edge=stats["padded_slots_per_edge"])
        del plan
    require(torch.equal(labels["bucketed"], labels["blocked"]),
            "10b: the blocked LPA labels differ from the bucketed family's")
    require(torch.equal(cc["bucketed"][0], cc["blocked"][0]) and
            cc["bucketed"][1] == cc["blocked"][1],
            "10b: CC labels or superstep counts differ between the families")
    out["cc"]["iterations"] = cc["blocked"][1]
    out["cc"]["components"] = int(torch.unique(cc["blocked"][0]).numel())
    del graph, labels, cc
    # PageRank on the directed graph: the segment path against the blocked one
    gd = build_graph(table.src, table.dst, num_vertices=v, symmetric=False, device=device)
    pd = BlockedPlan.from_graph(gd)
    seg_ms, seg = timed_ms(lambda: pagerank(gd, tol=0.0, max_iter=RUNG_PR_ITERS, plan=None),
                           device, reps=1)
    blk_ms, blk = timed_ms(lambda: pagerank(gd, tol=0.0, max_iter=RUNG_PR_ITERS, plan=pd),
                           device, reps=1)
    l1 = float((seg - blk).abs().sum())
    max_rel = float(((seg - blk).abs() / seg.abs()).max())
    require(l1 <= 1e-5 and max_rel <= 1e-4,
            f"10b: blocked PageRank off the segment path (L1 {l1:.3g}, max rel {max_rel:.3g})")
    out["pagerank"] = {"iterations": RUNG_PR_ITERS, "segment_ms": seg_ms, "blocked_ms": blk_ms,
                       "l1": l1, "max_rel": max_rel}
    log(f"10b {RUNG}: {out['ms_per_superstep']} ms/superstep, CC {out['cc']}, "
        f"PageRank {out['pagerank']}")
    return out


def ladder_point(scale: int, device="cuda", tile_slots=None, with_rates: bool = True) -> dict:
    """One 10c point: an R-MAT graph of ``scale`` drawn on ``device``,
    both plans, the median of 5 timed supersteps of each family after a
    warm-up (labels checked equal each time), the binned pass's slots/s
    against a uniform random gather's on the same M slots, and each
    family's peak bytes."""
    import torch

    from graphmine_tpu_torch.ops.blocking import (
        _SENTINEL,
        BlockedPlan,
        _blocked_tile,
        build_family_plan,
        lpa_superstep_blocked,
        timed_plan_build,
    )
    from graphmine_tpu_torch.ops.bucketed_mode import lpa_superstep_bucketed

    graph, ptr = rmat_graph(scale, BLOCKED_EDGE_FACTOR, seed=scale, device=device)
    v, m = graph.num_vertices, graph.num_messages
    on_card = torch.device(device).type == "cuda"
    bucketed, b_s = timed_plan_build(lambda: build_family_plan(graph, "bucketed"))
    blocked, k_s = timed_plan_build(lambda: BlockedPlan.from_ptr(
        ptr, v, graph.msg_send, tile_slots=tile_slots))
    # a state one superstep in: the supersteps after the first are the
    # ones a run repeats
    lbl = lpa_superstep_bucketed(torch.arange(v, dtype=torch.int32, device=device), graph,
                                 bucketed)
    out = {"scale": scale, "num_vertices": v, "num_messages": m,
           "plan_build_seconds": {"bucketed": b_s, "blocked": k_s}, "peak_bytes": {}}
    steps = {"bucketed": lambda: lpa_superstep_bucketed(lbl, graph, bucketed),
             "blocked": lambda: lpa_superstep_blocked(lbl, graph, blocked)}
    times = {family: [] for family in steps}
    for rep in range(BLOCKED_REPS + 1):  # the first is the warm-up, with the peaks
        outs = {}
        for family, step in steps.items():
            if rep == 0 and on_card:
                torch.cuda.reset_peak_memory_stats()
            ms, outs[family] = one_ms(step, device)
            if rep == 0 and on_card:
                out["peak_bytes"][family] = torch.cuda.max_memory_allocated()
            elif rep:
                times[family].append(ms)
        require(torch.equal(outs["bucketed"], outs["blocked"]),
                f"10c scale {scale}: the families' labels differ")
    for family, ms in times.items():
        out[f"{family}_ms"] = float(np.median(ms))
    out["blocked_over_bucketed"] = out["blocked_ms"] / out["bucketed_ms"]
    if with_rates:
        gen = torch.Generator(device=device)
        gen.manual_seed(11)
        idx = torch.randint(0, v, (m,), generator=gen, device=device, dtype=torch.int64).to(
            torch.int32)
        gather_ms, _ = timed_ms(lambda: lbl[idx], device)
        binned_ms, _ = timed_ms(lambda: _blocked_tile(blocked, lbl, _SENTINEL), device)
        out["random_gather_slots_per_sec"] = m / (gather_ms / 1e3)
        out["binned_pass_slots_per_sec"] = m / (binned_ms / 1e3)
        out["binned_over_random"] = gather_ms / binned_ms
    out.update(bins=blocked.num_bins, tile_slots=blocked.tile_slots,
               tile_alloc_over_m=blocked.tile_alloc / m)
    return out


def blocked_ladder(device="cuda", scales=BLOCKED_SCALES, sweep_scale=BLOCKED_SWEEP_SCALE,
                   tiles=BLOCKED_TILE_SWEEP) -> dict:
    """Phase 10c: :func:`ladder_point` at each scale, then the bin budget
    swept at ``sweep_scale``; the crossover is the smallest scale from
    which the blocked superstep beats the bucketed one at it and at every
    larger scale (None when it never does)."""
    import torch

    points = []
    for scale in scales:
        points.append(ladder_point(scale, device))
        log(f"10c scale {scale}: {points[-1]}")
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    sweep = []
    for tile in tiles:
        p = ladder_point(sweep_scale, device, tile_slots=tile, with_rates=False)
        sweep.append({"tile_slots_budget": tile, **{k: p[k] for k in (
            "bins", "tile_slots", "tile_alloc_over_m", "blocked_ms", "bucketed_ms",
            "blocked_over_bucketed")}})
        log(f"10c scale {sweep_scale} tile {tile}: {sweep[-1]}")
    return {"edge_factor": BLOCKED_EDGE_FACTOR, "points": points, "tile_sweep": sweep,
            "crossover_scale": crossover_scale(points)}


def crossover_scale(points: list):
    """The smallest scale from which the blocked superstep beats the
    bucketed one at it and at every larger scale of ``points`` (ascending
    scales), or None."""
    crossover = None
    for p in reversed(points):
        if p["blocked_ms"] >= p["bucketed_ms"]:
            break
        crossover = p["scale"]
    return crossover


def run_blocked(work: Path) -> None:
    """Phase 10: 10a on phase 4's graph, 10b on the com-LiveJournal rung,
    10c on the ladder; prints the ``blocked_small``, ``blocked`` and
    ``blocked_ladder`` lines and the phase's seconds."""
    t0 = time.perf_counter()
    print(json.dumps({"blocked_small": blocked_small(work)}), flush=True)
    print(json.dumps({"blocked": blocked_rung()}), flush=True)
    print(json.dumps({"blocked_ladder": blocked_ladder()}), flush=True)
    print(json.dumps({"blocked_phase_seconds": time.perf_counter() - t0}), flush=True)


def run_blocked_only(work: Path) -> None:
    """``--blocked-only``: phase 10, with phase 4's inputs written here."""
    small_inputs(work)
    run_blocked(work)


def run_frames_only(work: Path) -> None:
    """``--frames-only``: phase 9 on phase 4's and phase 5's inputs,
    written here."""
    from graphmine_tpu_torch import datasets

    small_inputs(work)
    src, dst, _, _ = datasets.planted_anomaly_graph(V_MAIN, E_MAIN, seed=SEED_MAIN)
    edges_pq = work / "edges.parquet"
    write_parquet(edges_pq, src, dst, V_MAIN)
    del src, dst
    run_frames(work, edges_pq)


def run_community_only(work: Path) -> None:
    """``--community-only``: phase 8 on phase 4's and phase 5's inputs,
    written here."""
    from graphmine_tpu_torch import datasets

    small_inputs(work)
    src, dst, _, _ = datasets.planted_anomaly_graph(V_MAIN, E_MAIN, seed=SEED_MAIN)
    edges_pq = work / "edges.parquet"
    write_parquet(edges_pq, src, dst, V_MAIN)
    del src, dst
    print(json.dumps({"community_small": community_small(work)}), flush=True)
    community_full(edges_pq)


# ---- 11. the multi-device pipeline on a virtual mesh ---------------------

MESH_SHARDS = (1, 2, 4)
MESH_DEVICES = 4          # the virtual mesh of 11b and 11c: 4 shards on the card
MESH_KNN_K = 16           # 11a's sharded kNN and LOF
MESH_REPS = 5
MESH_PR_ITERS = 30
MESH_MAX_AUROC_DELTA = 0.005


def _virtual_devices(n: int):
    """``GRAPHMINE_VIRTUAL_DEVICES=n`` for the block (the only setting that
    makes a mesh repeat a device)."""
    return mock.patch.dict(os.environ, {"GRAPHMINE_VIRTUAL_DEVICES": str(n)})


def mesh_ops_small(device, shards=MESH_SHARDS, v: int = 4096, e: int = 60_000) -> dict:
    """11a's operator results on ``device``: phase 4's graph partitioned
    onto a virtual mesh of each shard count in ``shards`` (its partition
    arrays, sharded and ring LPA unweighted and in quarter weights, CC with
    its superstep count, sharded and ring PageRank on the directed graph),
    and on a tie-free normal cloud the sharded kNN and LOF, each beside the
    single-device op on the same device, and the recursive-LPA flags of
    the sharded pass beside the masked one."""
    import torch

    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.device import visible_devices
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.cc import connected_components
    from graphmine_tpu_torch.ops.degrees import out_degrees
    from graphmine_tpu_torch.ops.knn import knn
    from graphmine_tpu_torch.ops.lof import lof_scores
    from graphmine_tpu_torch.ops.lpa import label_propagation
    from graphmine_tpu_torch.ops.outliers import (
        recursive_lpa_outliers,
        recursive_lpa_outliers_sharded,
    )
    from graphmine_tpu_torch.ops.pagerank import pagerank
    from graphmine_tpu_torch.parallel import knn as pknn
    from graphmine_tpu_torch.parallel import ring, sharded
    from graphmine_tpu_torch.parallel.mesh import make_mesh

    src, dst, _, _ = datasets.planted_anomaly_graph(v, e, seed=SEED_MAIN)
    w = (np.random.default_rng(7).integers(1, 16, len(src)) / 4).astype(np.float32)
    g = build_graph(src, dst, num_vertices=v, device=device)
    gw = build_graph(src, dst, num_vertices=v, edge_weights=w, device=device)
    gd = build_graph(src, dst, num_vertices=v, symmetric=False, device=device)
    pts = torch.from_numpy(np.random.default_rng(3).normal(size=(v, 8)).astype(np.float32))
    pts = pts.to(device)
    single = {
        "lpa": label_propagation(g, max_iter=5).cpu().numpy(),
        "lpa_weighted": label_propagation(gw, max_iter=5).cpu().numpy(),
        "pagerank": pagerank(gd, max_iter=MESH_PR_ITERS).cpu().numpy(),
        "lof": lof_scores(pts, k=MESH_KNN_K, impl="exact").cpu().numpy(),
    }
    cc, cc_iters = connected_components(g, return_iterations=True)
    single["cc"], single["cc_iterations"] = cc.cpu().numpy(), int(cc_iters)
    d2, idx = knn(pts, MESH_KNN_K)
    single["knn_d2"], single["knn_idx"] = d2.cpu().numpy(), idx.cpu().numpy()
    single["flags"] = recursive_lpa_outliers(
        g, torch.from_numpy(single["lpa"]).to(device)).outlier_vertices
    out = {"single": single, "mesh": {}}
    with _virtual_devices(max(shards)):
        for d in shards:
            mesh = make_mesh(d, devices=visible_devices(device)[:d])
            part = sharded.partition_graph(g, mesh=mesh, build_bucket_plan=True)
            part_w = sharded.partition_graph(gw, mesh=mesh, build_bucket_plan=True)
            sg = sharded.shard_graph_arrays(part, mesh)
            sgw = sharded.shard_graph_arrays(part_w, mesh)
            sort_w = sharded.shard_graph_arrays(sharded.partition_graph(gw, mesh=mesh), mesh)
            sgd = sharded.shard_graph_arrays(sharded.partition_graph(gd, mesh=mesh), mesh)
            od = out_degrees(gd)
            cc_d, tele = sharded.sharded_connected_components(sg, mesh, telemetry=True)
            sd2, sidx = pknn.sharded_knn(pts, mesh, MESH_KNN_K)
            r = {
                "partition": {f: np.asarray(getattr(part, f)) for f in
                              ("msg_recv_local", "msg_send", "degrees")}
                | {f"bucket_send_{i}": b for i, b in enumerate(part.bucket_send)}
                | {f"weight_{i}": b for i, b in enumerate(part_w.bucket_weight)},
                "lpa": sharded.sharded_label_propagation(sg, mesh, max_iter=5).cpu().numpy(),
                "lpa_weighted": sharded.sharded_label_propagation(
                    sgw, mesh, max_iter=5).cpu().numpy(),
                "ring_lpa": ring.ring_label_propagation(sg, mesh, max_iter=5).cpu().numpy(),
                "ring_lpa_weighted": ring.ring_label_propagation(
                    sort_w, mesh, max_iter=5).cpu().numpy(),
                "cc": cc_d.cpu().numpy(), "cc_iterations": tele.iterations,
                "ring_cc": ring.ring_connected_components(sg, mesh).cpu().numpy(),
                "pagerank": sharded.sharded_pagerank(
                    sgd, mesh, od, max_iter=MESH_PR_ITERS).cpu().numpy(),
                "ring_pagerank": ring.ring_pagerank(
                    sgd, mesh, od, max_iter=MESH_PR_ITERS).cpu().numpy(),
                "knn_d2": sd2.cpu().numpy(), "knn_idx": sidx.cpu().numpy(),
                "lof": pknn.sharded_lof(pts, mesh, k=MESH_KNN_K, impl="exact").cpu().numpy(),
                "flags": recursive_lpa_outliers_sharded(
                    g, single["lpa"], mesh).outlier_vertices,
            }
            out["mesh"][d] = r
    return out


def _ranks_close(got, want, what: str) -> dict:
    """PageRank within L1 1e-5 and max relative 1e-4."""
    l1 = float(np.abs(got - want).sum())
    rel = float((np.abs(got - want) / np.abs(want)).max())
    require(l1 <= 1e-5 and rel <= 1e-4, f"{what}: PageRank L1 {l1:.3g}, max relative {rel:.3g}")
    return {"l1": l1, "max_rel": rel}


def check_mesh_ops(card: dict, cpu: dict) -> dict:
    """11a's gates on :func:`mesh_ops_small` results of the card and of
    the CPU: partitions equal; every LPA, CC and recursive-LPA result
    equal to the single-device op and to the CPU; PageRank within L1 1e-5
    and max relative 1e-4 of the single-device op; kNN distances within
    rtol 1e-5 of the single-device kNN (on the card ``knn_topk``) with 0
    index mismatches; LOF within phase 4's tolerance."""
    out = {}
    for d, r in card["mesh"].items():
        c = cpu["mesh"][d]
        for f, a in r["partition"].items():
            require(np.array_equal(a, c["partition"][f]), f"D={d}: partition {f} card != CPU")
        for key, ref in (("lpa", "lpa"), ("ring_lpa", "lpa"), ("lpa_weighted", "lpa_weighted"),
                         ("ring_lpa_weighted", "lpa_weighted"), ("cc", "cc"), ("ring_cc", "cc"),
                         ("flags", "flags")):
            require(np.array_equal(r[key], card["single"][ref]),
                    f"D={d}: {key} != the single-device op on the card")
            require(np.array_equal(r[key], c[key]), f"D={d}: {key} card != CPU")
        require(r["cc_iterations"] == c["cc_iterations"] == card["single"]["cc_iterations"],
                f"D={d}: CC superstep counts {r['cc_iterations']}, {c['cc_iterations']}, "
                f"{card['single']['cc_iterations']}")
        rank = {k: _ranks_close(r[k], card["single"]["pagerank"], f"D={d} {k}")
                for k in ("pagerank", "ring_pagerank")}
        np.testing.assert_allclose(r["knn_d2"], card["single"]["knn_d2"], rtol=1e-5, atol=0)
        mismatch = int((r["knn_idx"] != card["single"]["knn_idx"]).sum())
        require(mismatch == 0, f"D={d}: {mismatch} kNN index mismatches on a tie-free cloud")
        _lof_close(r["lof"], card["single"]["lof"], f"D={d} sharded LOF")
        out[d] = {"pagerank": rank, "cc_iterations": r["cc_iterations"],
                  "knn_max_abs_err": float(np.abs(r["knn_d2"] - card["single"]["knn_d2"]).max()),
                  "communities": int(len(np.unique(r["lpa"])))}
    return out


def mesh_pipelines_small(work: Path, device) -> dict:
    """11a's pipeline cases on phase 4's parquet on ``device`` (outliers
    off): an uninterrupted run at D = 4; a checkpoint saved at D = 4 after
    3 supersteps and resumed at D = 2; a device loss injected at superstep
    3 of a D = 4 run, walking 4 -> 2 with one ``mesh_degrade`` record.
    Returns the labels and the records the gates read."""
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from graphmine_tpu_torch.testing import faults

    def cfg(**kw):
        return PipelineConfig(**{"data_path": str(work / "small.parquet"),
                                 "outlier_method": "none", "max_iter": 5,
                                 "device": str(device), **kw})

    with _virtual_devices(MESH_DEVICES):
        full = run_pipeline(cfg(num_devices=4))
        ck = work / f"mesh_ck_{str(device).replace(':', '_')}"
        shutil.rmtree(ck, ignore_errors=True)
        run_pipeline(cfg(num_devices=4, max_iter=3, checkpoint_dir=str(ck)))
        resumed = run_pipeline(cfg(num_devices=2, checkpoint_dir=str(ck), resume=True))
        inj = faults.FaultInjector()
        inj.add("lpa_superstep", faults.device_loss, at=3)
        with inj.installed():
            lost = run_pipeline(cfg(num_devices=4))
    return {
        "labels": full.labels, "resumed": resumed.labels, "lost": lost.labels,
        "resume_iteration": resumed.metrics.of_phase("resume")[0]["iteration"],
        "checkpoint_format": [r["format"] for r in full.metrics.of_phase("checkpoint_save")]
        + ["sharded" if (ck / "lpa_sharded").is_dir() else "none"],
        "mesh_degrade": records(lost.metrics, "mesh_degrade"),
        "virtual": [r.get("virtual") for r in full.metrics.of_phase("partition")],
    }


def check_mesh_pipelines(card: dict, cpu: dict) -> dict:
    """The pipeline cases' gates: every label vector equal to the
    uninterrupted card run's and to the CPU's; the resume starts at
    superstep 3 from the sharded checkpoint; one ``mesh_degrade`` record
    from 4 to 2 devices, marked virtual."""
    for key in ("labels", "resumed", "lost"):
        require(np.array_equal(card[key], card["labels"]), f"11a pipeline {key} != uninterrupted")
        require(np.array_equal(card[key], cpu[key]), f"11a pipeline {key} card != CPU")
    require(card["resume_iteration"] == 3, f"resumed at {card['resume_iteration']}")
    require(card["checkpoint_format"][-1] == "sharded", "no sharded checkpoint at D = 4")
    md = card["mesh_degrade"]
    require(len(md) == 1 and (md[0]["from_devices"], md[0]["to_devices"]) == (4, 2)
            and md[0]["virtual"] is True, f"mesh_degrade records {md}")
    require(all(card["virtual"]), "a virtual mesh's partition record lacks virtual: true")
    return {"mesh_degrade": md[0], "resume_iteration": card["resume_iteration"]}


def mesh_small(work: Path, devices=("cuda", "cpu"), size=(4096, 60_000)) -> dict:
    """11a: card against CPU at 4,096 vertices, D in (1, 2, 4); ``size`` is
    the operators' planted graph (vertices, edges), the pipelines read
    phase 4's parquet."""
    t0 = time.perf_counter()
    ops = {dev: mesh_ops_small(dev, v=size[0], e=size[1]) for dev in devices}
    pipes = {dev: mesh_pipelines_small(work, dev) for dev in devices}
    out = {"ops": check_mesh_ops(ops[devices[0]], ops[devices[1]]),
           "pipelines": check_mesh_pipelines(pipes[devices[0]], pipes[devices[1]]),
           "seconds": time.perf_counter() - t0}
    log(f"11a: card == CPU on D = {MESH_SHARDS} in {out['seconds']:.1f} s")
    return out


def superstep_point(graph, labels, schedule: str, d: int, device="cuda") -> dict:
    """One operating point of 11b: the partition's seconds, then the median
    of ``MESH_REPS`` supersteps after a warm-up (each superstep's labels
    equal to the first's), and on the card the peak bytes beside the
    model's (``sharded_superstep_footprint`` per shard, times the shards
    that share the card) and the bytes resident before the timed
    supersteps. ``labels`` are returned under ``"labels"``."""
    import torch

    from graphmine_tpu_torch.device import visible_devices
    from graphmine_tpu_torch.obs.memmodel import sharded_superstep_footprint
    from graphmine_tpu_torch.parallel import ring, sharded
    from graphmine_tpu_torch.parallel.mesh import make_mesh

    cuda = torch.device(device).type == "cuda"
    mesh = make_mesh(d, devices=visible_devices(device)[:d])
    _sync(device)
    t0 = time.perf_counter()
    sg = sharded.shard_graph_arrays(
        sharded.partition_graph(graph, mesh=mesh, build_bucket_plan=schedule == "replicated"),
        mesh, lpa_only=schedule == "replicated")
    _sync(device)
    part_s = time.perf_counter() - t0
    run = ring.ring_label_propagation if schedule == "ring" else sharded.sharded_label_propagation
    first = run(sg, mesh, max_iter=1, init_labels=labels)
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    resident = int(torch.cuda.memory_allocated()) if cuda else None
    ms, last = timed_ms(lambda: run(sg, mesh, max_iter=1, init_labels=labels), device,
                        reps=MESH_REPS)
    require(torch.equal(first, last), f"{schedule} D={d}: supersteps disagree")
    est = sharded_superstep_footprint("lpa_superstep", sg, schedule=schedule)
    return {"schedule": schedule, "devices": d, "virtual": d > 1, "ms": ms,
            "partition_seconds": part_s, "family": est.family,
            "peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else None,
            # the graph, the partition and the labels, resident before the
            # timed supersteps: peak minus resident is what the model counts
            "resident_bytes": resident,
            "predicted_bytes_per_shard": est.total_bytes,
            "predicted_bytes": est.total_bytes * d, "labels": first}


def ring_knn_point(feats, k: int = LOF_K) -> dict:
    """The ring kNN at D = 1 (one hop: a plain PyTorch cross kNN) beside
    ``knn_topk`` at the same shape, on the card; distances within rtol
    1e-5, indices equal (the fast instance's ties and the plain version's
    ties both go to the smaller index)."""
    import torch

    from graphmine_tpu_torch.device import visible_devices
    from graphmine_tpu_torch.kernels.knn_cuda import knn_topk
    from graphmine_tpu_torch.parallel.knn import sharded_knn
    from graphmine_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(1, devices=visible_devices("cuda")[:1])
    ring_ms, (rd, ri) = one_ms(lambda: sharded_knn(feats, mesh, k), "cuda")
    kernel_ms, (kd, ki) = one_ms(lambda: knn_topk(feats, k), "cuda")
    torch.testing.assert_close(rd, kd, rtol=1e-5, atol=0)
    mismatch = int((ri != ki).sum())
    n, f = feats.shape
    return {"shape": [int(n), int(f), k], "ring_ms": ring_ms, "knn_topk_ms": kernel_ms,
            "index_mismatches": mismatch}


def mesh_full(work: Path, parquet: Path, is_anomaly, phase5: dict | None = None) -> dict:
    """11b: each schedule's superstep at D = 1 and 4 on phase 5's graph
    (built from its store; the D = 1 pipeline run is phase 5's, run here
    when ``phase5`` is None), and the ring kNN at D = 1 beside
    ``knn_topk``. The 4-shard pipeline at this size is 11c's (11a runs
    both schedules' pipelines at 4,096 vertices, card == CPU). Returns the
    line and phase 5's reference."""
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.lof import auroc
    from graphmine_tpu_torch.pipeline import PipelineConfig

    if phase5 is None:
        store = work / "store"
        res, wall, _, peak = drive(PipelineConfig(
            data_path=str(parquet), batch_rows=BATCH_ROWS, max_iter=5, outlier_method="both",
            lof_k=LOF_K, device="cuda", snapshot_out=str(store)), "11b D=1")
        orig = generator_ids(res.edge_table.names)
        phase5 = {"labels": res.labels, "wall": wall, "store_arrays": store_arrays(store),
                  "auroc": auroc(res.lof, is_anomaly[orig]), "features": res.features}
        del res
    out = {"d1": {"wall_seconds": phase5.get("wall"), "lof_auroc": phase5["auroc"]}}
    ref = phase5["store_arrays"]
    graph = build_graph(ref["src"], ref["dst"], num_vertices=len(ref["labels"]), device="cuda")
    with _virtual_devices(MESH_DEVICES):
        labels = torch_labels(phase5["labels"])
        points = []
        for sched in ("replicated", "ring"):
            for d in (1, MESH_DEVICES):
                p = superstep_point(graph, labels, sched, d)
                points.append(p)
        first = points[0].pop("labels")
        for p in points[1:]:
            require(bool((p.pop("labels") == first).all()),
                    "11b supersteps disagree across points")
    del graph
    out["supersteps"] = points
    out["ring_knn"] = ring_knn_point(phase5["features"])
    log(f"11b: {[(p['schedule'], p['devices'], round(p['ms'], 2)) for p in points]}")
    return out, phase5


def store_arrays(store: Path) -> dict:
    """The edges, LPA and CC labels of a store's newest snapshot (read at
    once: the serving phases publish later versions into phase 5's)."""
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    snap = SnapshotStore(str(store)).load()
    return {"version": snap.version,
            **{k: snap.arrays[k] for k in ("src", "dst", "labels", "cc_labels")}}


def torch_labels(labels):
    import torch

    return torch.from_numpy(np.asarray(labels, np.int32)).cuda()


def mesh_scale_out(work: Path, parquet: Path, phase5: dict, is_anomaly) -> dict:
    """11c: the same run with ``GRAPHMINE_HBM_BYTES`` between the planner's
    replicated per-device estimate and its single-device one (both read
    from ``plan_run``): the ``scale_out`` record, the ``host-8-sampled``
    features, the sharded recursive outliers, and a published snapshot
    whose LPA and CC labels equal phase 5's store; LOF through the
    sharded scorer (IVF, its search on the mesh), equal to one device's
    IVF LOF on the same features within phase 4's tolerances, its AUROC
    reported beside phase 5's. The launch counts are set to 0 just before
    the run and read just after (the publish's canary launches
    ``knn_topk``)."""
    from graphmine_tpu_torch.ops.lof import auroc, lof_scores
    from graphmine_tpu_torch.pipeline import PipelineConfig, planner
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    ref = phase5["store_arrays"]
    v, e = len(ref["labels"]), len(ref["src"])
    est = planner.plan_run(v, e, MESH_DEVICES, hbm=1 << 50).estimates
    hbm = int((est["replicated"] + est["single"]) / 2 / 0.9)
    store = work / "store_scale_out"
    with _virtual_devices(MESH_DEVICES), mock.patch.dict(os.environ,
                                                         {"GRAPHMINE_HBM_BYTES": str(hbm)}):
        res, wall, launches, peak = drive(PipelineConfig(
            data_path=str(parquet), batch_rows=BATCH_ROWS, max_iter=5, outlier_method="both",
            lof_k=LOF_K, device="cuda", num_devices=MESH_DEVICES, snapshot_out=str(store)),
            "11c scale-out")
    m = res.metrics
    require(bool(m.of_phase("scale_out")) and res.scale_out, "11c: no scale_out record")
    require(res.feature_mode == "host-8-sampled", f"11c features {res.feature_mode}")
    rec = m.of_phase("outliers_recursive_lpa")[0]
    require(rec.get("devices") == MESH_DEVICES, "11c: the recursive outliers did not shard")
    require(launches["knn_topk"] >= 1, "11c: the publish's canary never launched knn_topk")
    snap = SnapshotStore(str(store)).load()
    for name in ("labels", "cc_labels"):
        require(np.array_equal(snap.arrays[name], ref[name]),
                f"11c: the scale-out store's {name} != phase 5's")
    sel = [r for r in m.of_phase("impl_selected") if r["op"] == "lof_knn"][0]
    require((sel["impl"], sel["devices"]) == ("ivf", MESH_DEVICES),
            f"11c: LOF ran {sel['impl']} on {sel['devices']} devices")
    # the sharded scorer against the single-device one on the same (host)
    # features; the AUROC is reported beside phase 5's, whose features were
    # computed on the card
    single = lof_scores(res.features, k=LOF_K, impl="ivf").cpu().numpy()
    _lof_close(np.asarray(res.lof), single, "11c: the sharded LOF vs one device's")
    lof_auroc = auroc(res.lof, is_anomaly[generator_ids(res.edge_table.names)])
    return {"hbm_budget": hbm, "lof_auroc": lof_auroc, "phase5_lof_auroc": phase5["auroc"], "estimates": est, "wall_seconds": wall,
            "phase_seconds": m.phase_seconds(), "feature_mode": res.feature_mode,
            "partition": records(m, "partition"), "cc_summary": records(m, "cc_summary"),
            "peak_device_bytes": peak, "launches": launches,
            "flagged_vertices": int(res.outliers.outlier_vertices.sum())}


def run_mesh(work: Path, parquet: Path, is_anomaly, phase5: dict | None = None) -> dict:
    """Phase 11: 11a, 11b, 11c; prints the ``mesh_small``, ``mesh`` and
    ``mesh_scale_out`` lines and the phase's seconds; returns 11c's launch
    counts (the phase's path)."""
    t0 = time.perf_counter()
    print(json.dumps({"mesh_small": mesh_small(work)}), flush=True)
    full, phase5 = mesh_full(work, parquet, is_anomaly, phase5)
    print(json.dumps({"mesh": full}, default=str), flush=True)
    scale = mesh_scale_out(work, parquet, phase5, is_anomaly)
    print(json.dumps({"mesh_scale_out": scale}, default=str), flush=True)
    print(json.dumps({"mesh_phase_seconds": time.perf_counter() - t0}), flush=True)
    return scale["launches"]


def run_mesh_only(work: Path) -> None:
    """``--mesh-only``: phase 11, with phase 4's and phase 5's inputs
    written here (11b then runs phase 5's pipeline itself, as its D = 1
    run)."""
    from graphmine_tpu_torch import datasets

    small_inputs(work)
    src, dst, is_anomaly, _ = datasets.planted_anomaly_graph(V_MAIN, E_MAIN, seed=SEED_MAIN)
    edges_pq = work / "edges.parquet"
    write_parquet(edges_pq, src, dst, V_MAIN)
    del src, dst
    run_mesh(work, edges_pq, is_anomaly)


def with_mesh_launches(entries: list, mesh_launches: dict) -> list:
    """The ``kernels`` entries, each with phase 11's launch count of its
    instance on its path, 11c (``mesh_launches``)."""
    return [{**e, "mesh_launches": mesh_launches[f"knn_topk_{e['instance']}"]} for e in entries]


# ---- 12. the serving plane's sharded repair on a virtual mesh --------------

SERVE_MESH_SHARDS = 4       # 12a's and 12b's virtual mesh: 4 shards on the card
SERVE_MESH_HTTP_SHARDS = 2  # 12a's server
SERVE_MESH_REPS = 5
SERVE_MESH_PPR_SOURCES = 8
SERVE_MESH_BC_SOURCES = 64
SERVE_MESH_RTOL, SERVE_MESH_ATOL = 1e-5, 1e-7  # the JAX package's betweenness tolerance
SERVE_MESH_TINY_HBM = "512"  # 12a's pre-degrade: no 2-D table fits
# The sharded repair's two families, forced as the JAX package's tests force
# them: the 2-D crossover moved below every graph, or above every graph.
SERVE_MESH_FAMILY_ENV = {"sort": {"GRAPHMINE_SHARDED2D_MIN_MESSAGES": str(1 << 62)},
                         "sharded_2d": {"GRAPHMINE_SHARDED2D_MIN_MESSAGES": "1"}}
# The 12b superstep families: a partition's keyword each.
SERVE_MESH_PARTITIONS = (("replicated", {"build_bucket_plan": True}),
                         ("blocked", {"build_blocked_plan": True}),
                         ("sharded_2d", {"build_plan2d": True}))
# The lines' keys (tests/test_torch_chip_smoke.py holds them).
SERVE_MESH_SMALL_KEYS = ("shards", "deltas", "families", "exchange", "predegrade", "http",
                         "ppr", "betweenness", "launches")
SERVE_MESH_KEYS = ("shards", "virtual", "num_vertices", "num_messages", "graph_build_seconds",
                   "supersteps", "repair")
EXCHANGE_KEYS = ("family", "devices", "peers", "exchange_bytes", "frontier_bytes",
                 "ladder_bytes", "frontier_frac", "boundary_slots", "padded_boundary")


def _serve_mesh_env(shards: int, family: str | None = None, **extra):
    """The virtual mesh of ``shards`` with ``family`` forced on the sharded
    repair (``None``: the planner's own choice), and ``extra`` variables."""
    env = {"GRAPHMINE_VIRTUAL_DEVICES": str(shards),
           **(SERVE_MESH_FAMILY_ENV[family] if family else {}), **extra}
    return mock.patch.dict(os.environ, env)


def ingest_chain(store: Path, copy: Path, deltas: list, device, shards: int,
                 family: str | None = None, **env) -> dict:
    """``deltas`` through a ``DeltaIngestor(num_shards=shards)`` on
    ``device`` over a copy of ``store`` at ``copy`` (on a virtual mesh of
    ``shards`` with ``family`` forced): each apply's snapshot, version,
    method, iterations and family, the ``shard_exchange`` and ``degrade``
    records."""
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink
    from graphmine_tpu_torch.serve.delta import DeltaIngestor, EdgeDelta
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    shutil.copytree(store, copy)
    sink = MetricsSink()
    applies, snaps = [], []
    with _serve_mesh_env(shards, family, **env):
        ing = DeltaIngestor(SnapshotStore(str(copy)), sink=sink, num_shards=shards,
                            device=device)
        for body in deltas:
            snaps.append(ing.apply(EdgeDelta.from_pairs(body.get("insert", ()),
                                                        body.get("delete", ()))))
            rec = sink.of_phase("delta_apply")[-1]
            applies.append({"version": snaps[-1].version, "method": rec["method"],
                            "iterations": rec["iterations"], "family": ing.last_shard_family})
    _sync(device)
    return {"snaps": snaps, "applies": applies,
            "exchange": [{k: r[k] for k in EXCHANGE_KEYS} for r in sink.of_phase("shard_exchange")],
            "degrade": sink.of_phase("degrade")}


PUBLISH_ARRAYS = ("src", "dst", "labels", "cc_labels", "lof")


def serve_mesh_cpu_chains(store: str, out: str, shards: int = SERVE_MESH_SHARDS) -> None:
    """12a's CPU side, run in a process of its own (whose environment the
    card's side does not share): 7a's deltas through the single-shard
    ingestor on the CPU and through the sharded one for each family, each
    sharded publish equal to the single-shard one (:func:`hold_to_one`);
    each run's last publish written to ``out/<run>.npz`` and its applies,
    exchange records and seconds to ``out/<run>.json`` (runs ``one`` and
    the families)."""
    import torch

    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    # a quarter of the host's cores: the parent's host work runs beside this
    torch.set_num_threads(max(1, (os.cpu_count() or 4) // 4))
    out = Path(out)
    deltas = small_deltas(SnapshotStore(store).load(), seed=5, skip_ids=257)
    one = None
    for name in ("one", *SERVE_MESH_FAMILY_ENV):
        t0 = time.perf_counter()
        run = (ingest_chain(Path(store), out / "copy_one", deltas, "cpu", 1) if name == "one"
               else ingest_chain(Path(store), out / f"copy_{name}", deltas, "cpu", shards, name))
        if name == "one":
            one = run
        else:
            hold_to_one(run, one, name)
        snap = run["snaps"][-1]
        np.savez(out / f"{name}.npz", **{k: np.asarray(snap[k]) for k in PUBLISH_ARRAYS})
        (out / f"{name}.json").write_text(json.dumps(
            {"applies": run["applies"], "exchange": run["exchange"],
             "seconds": time.perf_counter() - t0}))


def hold_to_one(run: dict, one: dict, family: str) -> None:
    """A sharded run of ``family`` against the single-shard one on the same
    device, publish by publish: labels, CC labels, edges, versions and
    methods equal, LOF within phase 4's tolerances, and iterations for
    ``sort`` (the 2-D CC's chunk-local pointer jump may take other
    supersteps); every apply ran ``family`` and recorded its exchange."""
    what = f"12a {family}"
    require(all(a["family"] == family for a in run["applies"]),
            f"{what}: families {[a['family'] for a in run['applies']]}")
    require(run["exchange"] and all(x["family"] == family for x in run["exchange"]),
            f"{what}: shard_exchange records {run['exchange']}")
    _same_applies(run["applies"], one["applies"], f"{what} vs one shard",
                  iterations=family == "sort")
    for got, want in zip(run["snaps"], one["snaps"]):
        same_publish(got, want, f"{what} vs one shard")


def start_cpu_chains(procs, work: Path, shards: int = SERVE_MESH_SHARDS) -> tuple:
    """Start :func:`serve_mesh_cpu_chains` in a child process of ``procs``
    over phase 4's store: ``(process, output directory, log)``."""
    out, log = work / "s12a_cpu", work / "s12a_cpu.log"
    out.mkdir()
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            f"chip_smoke.serve_mesh_cpu_chains({str(work / 'store_cuda')!r}, {str(out)!r}, "
            f"{shards})")
    return procs.spawn([sys.executable, "-c", code], log), out, log


def check_cpu_chains(job: tuple, runs: dict, timeout: float = 600.0) -> dict:
    """Wait for the CPU side (whose sharded runs equal its single-shard
    run) and hold the card's sharded runs ``runs`` (family ->
    :func:`ingest_chain`'s result) to the CPU's: applies (versions,
    methods, iterations, families) and exchange records equal, the last
    publish's edges and labels equal, LOF within phase 4's tolerances.
    Returns the CPU's single-shard applies and each run's seconds there."""
    proc, out, log = job
    rc = proc.wait(timeout=timeout)
    require(rc == 0, f"12a CPU side exited {rc}: {log.read_text()[-3000:]}")
    seconds = {}
    for fam, run in runs.items():
        want = json.loads((out / f"{fam}.json").read_text())
        seconds[fam] = want["seconds"]
        require(run["applies"] == want["applies"],
                f"12a {fam}: {run['applies']} != {want['applies']} on the CPU")
        require(run["exchange"] == want["exchange"], f"12a {fam}: exchange records differ")
        arrays = np.load(out / f"{fam}.npz")
        snap = run["snaps"][-1]
        for name in PUBLISH_ARRAYS[:-1]:
            require(np.array_equal(snap[name], arrays[name]), f"12a {fam}: {name} != CPU's")
        _lof_close(np.asarray(snap["lof"]), arrays["lof"], f"12a {fam} card vs CPU")
    one = json.loads((out / "one.json").read_text())
    return {"one_shard": one["applies"], "seconds": {"one": one["seconds"], **seconds}}


def _same_applies(got: list, want: list, what: str, iterations: bool = True) -> None:
    keys = ("version", "method") + (("iterations",) if iterations else ())
    for a, b in zip(got, want):
        require(all(a[k] == b[k] for k in keys), f"{what}: {a} != {b}")
    require(len(got) == len(want), f"{what}: {len(got)} applies, {len(want)} expected")


def serve_mesh_ops(snap, device, shards: int = SERVE_MESH_SHARDS) -> dict:
    """The source-sharded PPR and betweenness at ``shards`` shards on the
    store's graph, against the single-device ops on ``device``: the
    largest absolute and relative differences (held to rtol 1e-5 / atol
    1e-7)."""
    import torch

    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.centrality import betweenness_centrality
    from graphmine_tpu_torch.ops.pagerank import parallel_personalized_pagerank
    from graphmine_tpu_torch.parallel import sharded_personalized_pagerank
    from graphmine_tpu_torch.parallel.mesh import device_mesh

    v = len(snap["labels"])
    g = build_graph(snap["src"], snap["dst"], num_vertices=v, device=device)
    rng = np.random.default_rng(12)
    sources = rng.choice(v, SERVE_MESH_PPR_SOURCES, replace=False)
    bc_sources = rng.choice(v, SERVE_MESH_BC_SOURCES, replace=False)
    out = {}
    with _serve_mesh_env(shards):
        mesh = device_mesh(shards, device)
        pairs = {
            "ppr": (lambda: sharded_personalized_pagerank(g, sources, mesh),
                    lambda: parallel_personalized_pagerank(g, sources)),
            "betweenness": (lambda: betweenness_centrality(g, sources=bc_sources, mesh=mesh),
                            lambda: betweenness_centrality(g, sources=bc_sources)),
        }
        for name, (sharded, single) in pairs.items():
            sharded_ms, got = one_ms(sharded, device)
            single_ms, want = one_ms(single, device)
            torch.testing.assert_close(got, want, rtol=SERVE_MESH_RTOL, atol=SERVE_MESH_ATOL,
                                       msg=lambda m, n=name: f"12a {n}: {m}")
            diff = (got - want).abs()
            out[name] = {"shape": list(got.shape), "max_abs_err": float(diff.max()),
                         "sharded_ms": sharded_ms, "single_ms": single_ms, "virtual": True}
    return out


def serve_mesh_http(store: Path, work: Path, body: dict, want, device) -> dict:
    """One delta over HTTP through ``SnapshotServer(num_shards=2)`` on
    ``device`` over a copy of ``store``: answered 200, the publish equal to
    ``want`` (the ``sort`` run's first publish)."""
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink
    from graphmine_tpu_torch.serve.server import SnapshotServer
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    copy = work / "s12a_http"
    shutil.copytree(store, copy)
    sink = MetricsSink()
    with _serve_mesh_env(SERVE_MESH_HTTP_SHARDS):
        srv = SnapshotServer(SnapshotStore(str(copy)), sink=sink,
                             num_shards=SERVE_MESH_HTTP_SHARDS, device=device)
        port = srv.start()[1]
        try:
            status, _, res = http(port, "POST", "/delta", body)
            require(status == 200, f"12a server: {status} {res}")
            same_publish(srv.engine.snapshot, want, "12a server num_shards=2")
        finally:
            srv.stop()
    (ex,) = sink.of_phase("shard_exchange")
    rec = sink.of_phase("delta_apply")[-1]
    return {"status": status, "version": res.get("version"), "method": rec["method"],
            "iterations": rec["iterations"], "family": ex["family"], "devices": ex["devices"]}


def serve_mesh_small(work: Path, device="cuda", shards: int = SERVE_MESH_SHARDS) -> tuple:
    """12a on phase 4's store, ``device``'s side: 7a's three deltas through
    the sharded ingestor at ``shards`` shards, once with the ``sort``
    family forced and once ``sharded_2d``, the two families' publishes
    equal (labels, CC labels, edges, versions, methods; LOF within phase
    4's tolerances); a pre-degrade under a tiny memory budget, equal to
    the ``sort`` run's first publish; one delta over HTTP through
    ``SnapshotServer(num_shards=2)``, the same; the sharded PPR and
    betweenness. The launch counts are set to 0 just before the sharded
    ingestors and read just after (their LOF refresh launches
    ``knn_topk``). Returns the line and the sharded runs, which
    :func:`check_cpu_chains` holds to the CPU's (and through them to the
    single-shard ingestor's)."""
    import torch

    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    store = work / "store_cuda"
    base = SnapshotStore(str(store)).load()
    deltas = small_deltas(base, seed=5, skip_ids=257)
    t0 = time.perf_counter()
    reset_launches()
    runs = {fam: ingest_chain(store, work / f"s12a_{fam}", deltas, device, shards, fam)
            for fam in SERVE_MESH_FAMILY_ENV}
    _sync(device)
    launches = read_launches()
    if torch.device(device).type == "cuda":
        require(launches["knn_topk"] >= 1,
                f"12a: the sharded ingestors' LOF refresh never launched knn_topk: {launches}")
    chains_s = time.perf_counter() - t0
    first = runs["sort"]["snaps"][0]
    _same_applies(runs["sharded_2d"]["applies"], runs["sort"]["applies"], "12a 2-D vs sort",
                  iterations=False)
    for got, want in zip(runs["sharded_2d"]["snaps"], runs["sort"]["snaps"]):
        same_publish(got, want, "12a 2-D vs sort")
    pre = ingest_chain(store, work / "s12a_predegrade", deltas[:1], device, shards,
                       "sharded_2d", GRAPHMINE_HBM_BYTES=SERVE_MESH_TINY_HBM)
    deg = [r for r in pre["degrade"] if r.get("kind") == "mem_plan"]
    require(deg and deg[0]["stage"] == "delta_repair_plan" and deg[0]["to"] == "sort"
            and deg[0]["mem"]["family"] == "sharded_2d"
            and "exchange_send_tab" in deg[0]["mem"]["inventory"],
            f"12a pre-degrade: degrade records {pre['degrade']}")
    require(pre["applies"][0]["family"] == "sort" and pre["exchange"][0]["family"] == "sort",
            f"12a pre-degrade: {pre['applies']} {pre['exchange']}")
    same_publish(pre["snaps"][0], first, "12a pre-degrade vs sort")
    line = {
        "shards": shards,
        "families": {fam: run["applies"] for fam, run in runs.items()},
        "exchange": {fam: run["exchange"] for fam, run in runs.items()},
        "predegrade": {"mem": {k: deg[0]["mem"][k] for k in ("family", "total_bytes")},
                       "budget_bytes": int(SERVE_MESH_TINY_HBM),
                       "family": pre["applies"][0]["family"]},
        "http": serve_mesh_http(store, work, deltas[0], first, device),
        **serve_mesh_ops(base, device, shards), "launches": launches,
        "chains_seconds": chains_s,
    }
    return line, runs


def serve_mesh_point(graph, mesh, family: str, kw: dict, ref: dict, device="cuda") -> dict:
    """One 12b family on ``mesh``: the partition's seconds, 5 LPA
    supersteps from the identity (equal to phase 5's labels), CC to its
    fixpoint (equal to phase 5's CC) with its superstep count, then the
    median of ``SERVE_MESH_REPS`` single LPA and CC supersteps after a
    warm-up, the peak bytes beside the memory model's, and the
    ``shard_exchange`` record's modeled bytes per superstep."""
    import torch

    from graphmine_tpu_torch.obs.costmodel import emit_shard_exchange
    from graphmine_tpu_torch.obs.memmodel import sharded_superstep_footprint
    from graphmine_tpu_torch.parallel import sharded
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink

    cuda = torch.device(device).type == "cuda"
    _sync(device)
    t0 = time.perf_counter()
    sg = sharded.shard_graph_arrays(sharded.partition_graph(graph, mesh=mesh, **kw), mesh)
    _sync(device)
    part_s = time.perf_counter() - t0
    labels = sharded.sharded_label_propagation(sg, mesh, max_iter=5)
    require(np.array_equal(labels.cpu().numpy(), ref["labels"]),
            f"12b {family}: 5 LPA supersteps != phase 5's labels")
    cc, tele = sharded.sharded_connected_components(sg, mesh, telemetry=True)
    require(np.array_equal(cc.cpu().numpy(), ref["cc_labels"]),
            f"12b {family}: CC != phase 5's")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    resident = int(torch.cuda.memory_allocated()) if cuda else None
    lpa_ms, last = timed_ms(lambda: sharded.sharded_label_propagation(
        sg, mesh, max_iter=1, init_labels=labels), device, reps=SERVE_MESH_REPS)
    cc_ms, _ = timed_ms(lambda: sharded.sharded_connected_components(sg, mesh, max_iter=1),
                        device, reps=SERVE_MESH_REPS)
    est = sharded_superstep_footprint("lpa_superstep", sg)
    rec = emit_shard_exchange(MetricsSink(), "serve_mesh", sg, virtual=True)
    return {"family": family, "model_family": est.family, "devices": mesh.size,
            "virtual": True, "partition_seconds": part_s, "lpa_ms": lpa_ms, "cc_ms": cc_ms,
            "cc_supersteps": int(tele.iterations),
            "peak_bytes": int(torch.cuda.max_memory_allocated()) if cuda else None,
            "resident_bytes": resident,
            "predicted_bytes_per_shard": est.total_bytes,
            "predicted_bytes": est.total_bytes * mesh.size,
            "exchange": {k: rec[k] for k in EXCHANGE_KEYS}, "next_labels": last}


def serve_mesh_repair(phase5: dict, store: Path, device="cuda",
                      shards: int = SERVE_MESH_SHARDS) -> dict:
    """12b's repair: a delta of 0.05% of E drawn as 7b draws it on phase
    5's publish (``phase5["store_arrays"]``, kept in memory), repaired by
    the single-device ``repair_labels`` and by the sharded ingestor's
    ``_repair`` (its sharded propagation and sampled check, no LOF pass)
    for the ``sort`` and ``sharded_2d`` families: labels, CC, method
    equal, and iterations for ``sort``; each one's seconds and its
    ``shard_exchange`` record."""
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.pipeline.metrics import MetricsSink
    from graphmine_tpu_torch.serve import delta as sd
    from graphmine_tpu_torch.serve.snapshot import Snapshot, SnapshotStore

    t0 = time.perf_counter()
    ref = phase5["store_arrays"]
    snap = Snapshot(arrays={k: ref[k] for k in ("src", "dst", "labels", "cc_labels")},
                    meta={"version": ref["version"]})
    v, e = len(snap["labels"]), len(snap["src"])
    rng = np.random.default_rng(7)
    n_d = max(8, int(e * SERVE_DELTA_FRACS[0]))
    ins = np.stack([rng.integers(0, v, n_d), rng.integers(0, v, n_d)], 1)
    idx = rng.integers(0, e, n_d // 2)
    dele = np.stack([snap["src"][idx], snap["dst"][idx]], 1)
    clean, _ = sd.validate_delta(sd.EdgeDelta.from_pairs(ins.tolist(), dele.tolist()), v)
    src2, dst2, v2, _ = sd.splice_edges(snap["src"], snap["dst"], v, clean)
    graph = build_graph(src2, dst2, num_vertices=v2, device=device)
    _sync(device)
    prep_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = sd.repair_labels(graph, snap["labels"], snap["cc_labels"], clean,
                              check_samples=64, seed=snap.version)
    _sync(device)
    out = {"delta_rows": int(len(ins) + len(dele)), "version": snap.version,
           "prep_seconds": prep_s,
           "single": {"method": single.method, "iterations": single.iterations,
                      "seconds": time.perf_counter() - t0}}
    for fam in SERVE_MESH_FAMILY_ENV:
        sink = MetricsSink()
        with _serve_mesh_env(shards, fam):
            ing = sd.DeltaIngestor(SnapshotStore(str(store)), sink=sink, num_shards=shards,
                                   snapshot=snap, quality=False, device=device)
            t0 = time.perf_counter()
            res = ing._repair(graph, clean)
            _sync(device)
            secs = time.perf_counter() - t0
        what = f"12b repair {fam}"
        require(ing.last_shard_family == fam, f"{what}: ran {ing.last_shard_family}")
        require(np.array_equal(res.labels, single.labels), f"{what}: labels != single's")
        require(np.array_equal(res.cc_labels, single.cc_labels), f"{what}: CC != single's")
        require(res.method == single.method, f"{what}: {res.method} != {single.method}")
        if fam == "sort":
            require(res.iterations == single.iterations,
                    f"{what}: {res.iterations} iterations != {single.iterations}")
        (ex,) = sink.of_phase("shard_exchange")
        out[fam] = {"method": res.method, "iterations": res.iterations, "seconds": secs,
                    "virtual": True, "exchange": {k: ex[k] for k in EXCHANGE_KEYS}}
    return out


def serve_mesh_full(phase5: dict, device="cuda", shards: int = SERVE_MESH_SHARDS) -> dict:
    """12b's supersteps on phase 5's graph (nothing cut) at ``shards``
    shards: each family (:func:`serve_mesh_point`), their labels equal.
    Every time is a virtual mesh's (``virtual: true``): the shards share
    the card."""
    import torch

    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.parallel.mesh import device_mesh

    ref = phase5["store_arrays"]
    v = len(ref["labels"])
    t0 = time.perf_counter()
    graph = build_graph(ref["src"], ref["dst"], num_vertices=v, device=device)
    _sync(device)
    build_s = time.perf_counter() - t0
    points = []
    with _serve_mesh_env(shards):
        mesh = device_mesh(shards, device)
        for family, kw in SERVE_MESH_PARTITIONS:
            t1 = time.perf_counter()
            points.append(serve_mesh_point(graph, mesh, family, kw, ref, device))
            log(f"12b {family}: {time.perf_counter() - t1:.1f} s")
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
    nxt = points[0].pop("next_labels")
    for p in points[1:]:
        require(torch.equal(p.pop("next_labels"), nxt), f"12b {p['family']}: labels differ")
    log(f"12b: {[(p['family'], round(p['lpa_ms'], 2), round(p['cc_ms'], 2)) for p in points]}")
    return {"shards": shards, "virtual": True, "num_vertices": v,
            "num_messages": graph.num_messages, "graph_build_seconds": build_s,
            "supersteps": points}


def run_serve_mesh(work: Path, phase5: dict) -> dict:
    """Phase 12: 12a's CPU side in a child process while the card runs 12a
    and 12b's repair, then 12b's supersteps once the child is done (their
    times then share the host with nothing); prints the
    ``serve_mesh_small`` and ``serve_mesh`` lines and the phase's
    seconds; returns 12a's launch counts (the card's sharded ingestors)."""
    t0 = time.perf_counter()
    with Processes() as procs:
        job = start_cpu_chains(procs, work)
        small, runs = serve_mesh_small(work)
        log(f"12a on the card: {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        repair = serve_mesh_repair(phase5, work / "store")
        log(f"12b repair: {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        cpu = check_cpu_chains(job, runs)
        small.update(deltas=cpu["one_shard"], cpu_seconds=cpu["seconds"],
                     cpu_wait_seconds=time.perf_counter() - t1)
    full = check_keys({**serve_mesh_full(phase5), "repair": repair}, SERVE_MESH_KEYS,
                      "serve_mesh")
    print(json.dumps({"serve_mesh_small": check_keys(small, SERVE_MESH_SMALL_KEYS,
                                                     "serve_mesh_small")}), flush=True)
    print(json.dumps({"serve_mesh": full}), flush=True)
    print(json.dumps({"serve_mesh_phase_seconds": time.perf_counter() - t0}), flush=True)
    return small["launches"]


def run_serve_mesh_only(work: Path) -> None:
    """``--serve-mesh-only``: phase 12, after publishing phase 4's store
    (the small graph's pipeline with a snapshot, on the card) and phase
    5's (the main path's pipeline)."""
    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.pipeline import PipelineConfig

    small, _ = small_inputs(work)
    drive(PipelineConfig(data_path=str(small), data_format="edgelist", lof_impl="exact",
                         outlier_method="both", lof_k=SMALL_LOF_K, device="cuda",
                         snapshot_out=str(work / "store_cuda")), "phase 4's store")
    src, dst, _, _ = datasets.planted_anomaly_graph(V_MAIN, E_MAIN, seed=SEED_MAIN)
    edges_pq = work / "edges.parquet"
    write_parquet(edges_pq, src, dst, V_MAIN)
    del src, dst
    store = work / "store"
    drive(PipelineConfig(data_path=str(edges_pq), batch_rows=BATCH_ROWS, max_iter=5,
                         outlier_method="both", lof_k=LOF_K, snapshot_out=str(store),
                         device="cuda"), "phase 5's store")
    launches = run_serve_mesh(work, {"store_arrays": store_arrays(store)})
    log(f"12a launches: {launches}")


def with_serve_mesh_launches(entries: list, serve_mesh_launches: dict) -> list:
    """The ``kernels`` entries, each with phase 12's launch count of its
    instance on its path, 12a's sharded ingestors (``serve_mesh_launches``)."""
    return [{**e, "serve_mesh_launches": serve_mesh_launches[f"knn_topk_{e['instance']}"]}
            for e in entries]


# ---- 13. the multi-process mesh ------------------------------------------------

# 13a's worlds, by ranks. A world with no more ranks than the host has
# cards takes a card a rank, over NCCL; a larger one shares a card, a
# virtual world over gloo (NCCL refuses two ranks on one card). On one
# H100: one NCCL rank, then two and four virtual ranks.
DIST_WORLDS = (1, 2, 4)
DIST_FLOW = (4096, 60_000)  # 13a's graph: phase 11's (vertices, edges)
DIST_SCALE_RANKS = 2      # 13b's virtual world on phase 5's graph
DIST_REPS = 5
DIST_KEYS = ("worlds", "scale", "seconds")
DIST_SCALE_KEYS = ("ranks", "virtual", "backend", "num_vertices", "num_messages",
                   "build_seconds", "partition_seconds", "lpa_ms", "exchange_ms",
                   "cc_supersteps", "peak_bytes")


def _cards(device) -> int:
    """The distinct cards a world or mesh on ``device`` may take (0 on the
    CPU)."""
    import torch

    return torch.cuda.device_count() if str(device).startswith("cuda") else 0


def _world_kind(size: int, device) -> tuple:
    """``(backend, virtual)`` of a ``size``-rank world on ``device``."""
    if _cards(device) == 0:
        return "gloo", False
    return ("nccl", False) if size <= _cards(device) else ("gloo", True)


def _dist_env(rank: int, size: int, port: int, shared: bool, **extra) -> dict:
    """A rank's environment, as ``torchrun`` sets it on one host; ranks
    that share a device ask for a virtual world."""
    env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(size), "LOCAL_RANK": str(rank),
           "LOCAL_WORLD_SIZE": str(size), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
           "OMP_NUM_THREADS": "1", **extra}
    if shared:
        env["GRAPHMINE_VIRTUAL_DEVICES"] = str(size)
    else:
        env.pop("GRAPHMINE_VIRTUAL_DEVICES", None)
    return env


def start_world(procs, cmd: list, size: int, out: Path, device: str = "cuda",
                **extra) -> list:
    """``size`` ranks of ``cmd`` (each in ``procs``, its log in ``out``),
    meeting on a free port; a virtual world when they outnumber the cards."""
    out.mkdir(parents=True, exist_ok=True)
    (port,) = free_ports(1)
    shared = size > max(1, _cards(device))
    return [procs.spawn(cmd, out / f"rank{r}.log", env=_dist_env(r, size, port, shared, **extra))
            for r in range(size)]


def wait_worlds(jobs: dict, timeout: float | None = None) -> dict:
    """Wait for every process of every job (``name -> (processes, log
    directory)``; rank ``r``'s log is ``rank<r>.log`` there, a lone
    process's ``<name>.log``) to exit 0, polling them all: a process that
    fails, or a job past ``timeout``, kills every process and fails the
    phase. ``timeout`` defaults to a minute past the worlds' own timeout.
    Returns each job's seconds from this call to its last exit."""
    if timeout is None:
        from graphmine_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT_S

        timeout = DEFAULT_TIMEOUT_S + 60
    t0 = time.perf_counter()
    done = {}
    while len(done) < len(jobs):
        for name, (ranks, out) in jobs.items():
            codes = [p.poll() for p in ranks]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.perf_counter() - t0 > timeout
            if bad or (late and name not in done):
                for other, _ in jobs.values():
                    for p in other:
                        if p.poll() is None:
                            p.kill()
                r = bad[0][0] if bad else 0
                logs = sorted(out.glob(f"rank{r}.log")) or sorted(out.glob(f"{name}.log"))
                tail = logs[0].read_text()[-3000:] if logs else ""
                require(False, f"{name}: " + (f"process {r} exited {bad[0][1]}" if bad else
                                              f"timed out after {timeout:.0f} s") + f"\n{tail}")
            if name not in done and all(c == 0 for c in codes):
                done[name] = time.perf_counter() - t0
        time.sleep(0.05)
    return done


def _rank_seconds(out: Path, size: int) -> dict:
    """The slowest rank's join and flow seconds (``rank<r>.json``)."""
    recs = [json.loads((out / f"rank{r}.json").read_text()) for r in range(size)]
    return {k: max(rec[k] for rec in recs) for k in recs[0]}


def flow_cmd(out: Path, device: str = "cuda") -> list:
    """One rank of the port's distributed flow on phase 11's graph."""
    return [sys.executable, "-m", "graphmine_tpu_torch.parallel.distributed_flow",
            "--out", str(out), "--vertices", str(DIST_FLOW[0]), "--edges", str(DIST_FLOW[1]),
            "--seed", str(SEED_MAIN), "--device", device]


def flow_in_process(device, sizes, work: Path) -> dict:
    """The same flow on in-process meshes of each size in ``sizes`` on
    ``device`` (a card a shard while the cards last, else a virtual mesh):
    ``{D: results}``."""
    from graphmine_tpu_torch.device import visible_devices
    from graphmine_tpu_torch.parallel import distributed_flow as flow
    from graphmine_tpu_torch.parallel.mesh import make_mesh

    src, dst, pts = flow.flow_inputs(*DIST_FLOW, SEED_MAIN)
    out = {}
    for d in sizes:
        with _virtual_devices(d) if d > max(1, _cards(device)) else contextlib.nullcontext():
            mesh = make_mesh(d, devices=visible_devices(device)[:d])
            ck = work / f"ck_{str(device).replace(':', '_')}_{d}"
            out[d] = flow.run_flow(mesh, src, dst, DIST_FLOW[0], pts, str(ck))
    return out


def _dist_same(got: dict, want: dict, what: str, keys=None) -> None:
    for key in keys or sorted(set(want) - {"resumed"}):
        require(key in got and np.array_equal(got[key], want[key]), f"{what}: {key} differs")


def check_world(size: int, backend: str, virtual: bool, out: Path, card: dict,
                cpu: dict) -> dict:
    """One 13a world: every rank's results equal (``resumed`` on the ranks
    of the smaller mesh only), the backend and ``virtual`` as asked, and
    equal to the in-process mesh of the same size on the card; the card's
    in-process results equal the CPU's (labels, CC, kNN indices), with
    PageRank and PPR within L1 1e-5, kNN distances within rtol 1e-5 and
    LOF within phase 4's tolerance."""
    what = f"13a {size}-rank world"
    res = [dict(np.load(out / f"rank{r}.npz")) for r in range(size)]
    for r, got in enumerate(res):
        require(str(got["backend"]) == backend and bool(got["virtual"]) == virtual,
                f"{what}: rank {r} ran {got['backend']}, virtual {got['virtual']}")
        _dist_same(got, res[0], f"{what} rank {r} vs rank 0")
        require(("resumed" in got) == (r < min(2, size)), f"{what}: rank {r}'s resume")
        _dist_same(got, card, f"{what} rank {r} vs the in-process mesh on the card",
                   sorted(set(card) - {"resumed"}) + (["resumed"] if "resumed" in got else []))
    for key in ("lpa_sort", "lpa_bucketed", "lpa_blocked", "lpa_2d", "cc", "cc_2d",
                "ring_lpa", "ring_cc", "knn_idx", "resumed", "restored"):
        require(np.array_equal(card[key], cpu[key]), f"{what}: in-process {key} card != CPU")
    for key in ("pagerank", "ring_pagerank", "ppr"):
        l1 = float(np.abs(card[key] - cpu[key]).sum())
        require(l1 <= 1e-5, f"{what}: {key} card vs CPU L1 {l1:.3g}")
    np.testing.assert_allclose(card["knn_d2"], cpu["knn_d2"], rtol=1e-5, atol=0)
    _lof_close(card["lof"], cpu["lof"], f"{what} in-process LOF card vs CPU")
    return {"ranks": size, "backend": backend, "virtual": virtual,
            "communities": int(len(np.unique(res[0]["lpa_bucketed"]))),
            "cc_supersteps": int(res[0]["cc_iterations"])}


def dist_scale_rank(edges: str, out: str, device: str = "cuda", reps: int = DIST_REPS) -> None:
    """One rank of 13b: join the world, build phase 5's graph on the card
    from ``edges/{src,dst}.npy``, partition it with the bucket plan (the
    partition's seconds), then, once ``edges/go`` exists (13a done), 5 LPA
    supersteps and CC to its fixpoint, the median of ``reps`` single LPA
    supersteps after a warm-up and of ``reps`` label all-gathers alone
    (each ending in a synchronise), and this process's peak bytes, written
    to ``out/rank<r>.npz``."""
    import torch.distributed as dist

    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.parallel import sharded
    from graphmine_tpu_torch.parallel.mesh import (
        DEFAULT_TIMEOUT_S,
        all_gather,
        initialize_distributed,
        make_mesh,
        world,
    )

    initialize_distributed(device=device)
    try:
        import torch

        edges, w = Path(edges), world()
        dev = w.device
        cuda = dev.type == "cuda"
        src, dst = np.load(edges / "src.npy"), np.load(edges / "dst.npy")
        v = int(np.load(edges / "num_vertices.npy"))
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        graph = build_graph(src, dst, num_vertices=v, device=dev)
        _sync(dev)
        build_s = time.perf_counter() - t0
        del src, dst
        mesh = make_mesh()
        t0 = time.perf_counter()
        sg = sharded.shard_graph_arrays(
            sharded.partition_graph(graph, mesh=mesh, build_bucket_plan=True), mesh)
        _sync(dev)
        part_s = time.perf_counter() - t0
        wait_for(lambda: (edges / "go").exists(), "13b's go", DEFAULT_TIMEOUT_S, every=0.02)
        labels = sharded.sharded_label_propagation(sg, mesh, max_iter=5)
        cc, tele = sharded.sharded_connected_components(sg, mesh, telemetry=True)

        def timed(fn):
            fn()
            _sync(dev)
            runs = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                _sync(dev)
                runs.append(1e3 * (time.perf_counter() - t0))
            return runs

        lpa_ms = timed(lambda: sharded.sharded_label_propagation(sg, mesh, max_iter=1,
                                                                 init_labels=labels))
        vc = sg.chunk_size
        chunk = mesh.each(lambda s: labels.new_zeros(vc))
        exchange_ms = timed(lambda: all_gather(mesh, chunk))
        np.savez(Path(out) / f"rank{w.rank}.npz", labels=labels.cpu().numpy(),
                 cc=cc.cpu().numpy(), cc_supersteps=np.asarray(tele.iterations),
                 lpa_ms=np.asarray(lpa_ms), exchange_ms=np.asarray(exchange_ms),
                 build_seconds=np.asarray(build_s), partition_seconds=np.asarray(part_s),
                 peak_bytes=np.asarray(torch.cuda.max_memory_allocated(dev) if cuda else -1),
                 num_messages=np.asarray(graph.num_messages), backend=np.asarray(w.backend),
                 virtual=np.asarray(w.virtual))
    finally:
        dist.destroy_process_group()


def start_scale_world(procs, work: Path, src, dst, num_vertices: int,
                      device: str = "cuda") -> tuple:
    """13b's ranks, started beside 13a: they build and partition the graph,
    then wait for the go file. Returns ``(ranks, edges dir, out dir)``."""
    edges, out = work / "dist13b_edges", work / "dist13b"
    edges.mkdir()
    np.save(edges / "src.npy", np.asarray(src, np.int32))
    np.save(edges / "dst.npy", np.asarray(dst, np.int32))
    np.save(edges / "num_vertices.npy", np.asarray(num_vertices))
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); import chip_smoke; "
            f"chip_smoke.dist_scale_rank({str(edges)!r}, {str(out)!r}, {device!r})")
    return (start_world(procs, [sys.executable, "-c", code], DIST_SCALE_RANKS, out, device),
            edges, out)


def check_scale(out: Path, ref: dict, backend: str = "gloo", virtual: bool = True) -> dict:
    """13b: every rank's labels and CC equal phase 5's (``ref``) and each
    other's; the line's medians, seconds and peaks per rank."""
    res = [dict(np.load(out / f"rank{r}.npz")) for r in range(DIST_SCALE_RANKS)]
    for r, got in enumerate(res):
        require(np.array_equal(got["labels"], ref["labels"]),
                f"13b rank {r}: 5 LPA supersteps != phase 5's labels")
        require(np.array_equal(got["cc"], ref["cc_labels"]), f"13b rank {r}: CC != phase 5's")
        require(str(got["backend"]) == backend and bool(got["virtual"]) == virtual,
                f"13b rank {r}: {got['backend']}, virtual {got['virtual']}")
    per = lambda key, f=float: [f(np.median(g[key])) for g in res]  # noqa: E731
    return {"ranks": DIST_SCALE_RANKS, "virtual": virtual, "backend": backend,
            "num_vertices": int(len(ref["labels"])), "num_messages": int(res[0]["num_messages"]),
            "build_seconds": per("build_seconds"), "partition_seconds": per("partition_seconds"),
            "lpa_ms": per("lpa_ms"), "exchange_ms": per("exchange_ms"),
            "cc_supersteps": int(res[0]["cc_supersteps"]), "peak_bytes": per("peak_bytes", int)}


def run_dist(work: Path, ref: dict, device: str = "cuda") -> dict:
    """Phase 13: 13a's three worlds and 13b's world (preparing beside
    them) start at once; 13a's in-process references run here meanwhile,
    on the card, then on the CPU (two intra-op threads: the ranks share
    the host's cores); 13b's timed part runs once 13a's worlds are done. ``ref`` holds phase 5's ``src``,
    ``dst``, ``labels`` and ``cc_labels``. Prints the ``dist`` line and
    the phase's seconds. ``device="cpu"`` rehearses the phase on the host
    (every world gloo, none virtual)."""
    t0 = time.perf_counter()
    root = work / "dist"
    root.mkdir()
    with Processes() as procs:
        scale, edges, scale_out = start_scale_world(procs, work, ref["src"], ref["dst"],
                                                    len(ref["labels"]), device)
        worlds = {size: start_world(procs, flow_cmd(root / f"w{size}", device), size,
                                    root / f"w{size}", device) for size in DIST_WORLDS}
        card = flow_in_process(device, DIST_WORLDS, root)
        card_s = time.perf_counter() - t0
        import torch

        threads = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            cpu = flow_in_process("cpu", DIST_WORLDS, root)
        finally:
            torch.set_num_threads(threads)
        cpu_s = time.perf_counter() - t0
        ends = wait_worlds({f"13a {size}-rank world": (ranks, root / f"w{size}")
                            for size, ranks in worlds.items()})
        lines = []
        for size in DIST_WORLDS:
            lines.append({**check_world(size, *_world_kind(size, device), root / f"w{size}",
                                        card[size], cpu[size]),
                          "seconds": cpu_s + ends[f"13a {size}-rank world"],
                          **_rank_seconds(root / f"w{size}", size)})
        t13a = time.perf_counter() - t0
        log(f"13a: worlds {[w['ranks'] for w in lines]} held in {t13a:.1f} s")
        (edges / "go").touch()
        wait_worlds({"13b 2-rank world": (scale, scale_out)})
    line = check_keys({"worlds": lines,
                       "scale": check_keys(check_scale(scale_out, ref,
                                                       *_world_kind(DIST_SCALE_RANKS, device)),
                                           DIST_SCALE_KEYS, "dist scale"),
                       "seconds": {"13a": t13a, "card_in_process": card_s,
                                   "cpu_in_process": cpu_s - card_s,
                                   "total": time.perf_counter() - t0}},
                      DIST_KEYS, "dist")
    print(json.dumps({"dist": line}), flush=True)
    print(json.dumps({"dist_phase_seconds": time.perf_counter() - t0}), flush=True)
    return line


def run_dist_only(work: Path) -> None:
    """``--dist-only``: phase 13, its 13b reference computed here: phase
    5's graph (the generator's ids) with 5 LPA supersteps and CC on the
    card."""
    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.cc import connected_components
    from graphmine_tpu_torch.ops.lpa import label_propagation

    src, dst, _, _ = datasets.planted_anomaly_graph(V_MAIN, E_MAIN, seed=SEED_MAIN)
    graph = build_graph(src, dst, num_vertices=V_MAIN, device="cuda")
    ref = {"src": src, "dst": dst, "labels": label_propagation(graph, max_iter=5).cpu().numpy(),
           "cc_labels": connected_components(graph).cpu().numpy()}
    del graph
    run_dist(work, ref)


def run_main_path(work: Path) -> None:
    """Phases 4-7: small pipelines on the card against the CPU, the run
    harness on them, the main path, the main path under the harness,
    serving, the weighted exact path, the kernel at its shapes and the IVF
    kNN against the exact one."""
    import torch

    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.pipeline import PipelineConfig

    # ---- 4. the pipeline on the card against the CPU, small graphs ------
    pipeline_launches = small_pipelines(work)

    # ---- 4b. the run harness on the small graph, card and CPU -----------
    print(json.dumps({"harness_small": small_harness(work)}), flush=True)

    # ---- 5. the main path: the JAX package's default pipeline ----------
    t0 = time.perf_counter()
    src, dst, is_anomaly, _ = datasets.planted_anomaly_graph(V_MAIN, E_MAIN, seed=SEED_MAIN)
    edges_pq, weighted = work / "edges.parquet", work / "edges_weighted.txt"
    write_parquet(edges_pq, src, dst, V_MAIN)
    write_edge_list(weighted, src, dst, np.random.default_rng(7).integers(1, 16, len(src)) / 4)
    gen_s = time.perf_counter() - t0
    del src, dst
    log(f"main-path parquet file and weighted edge list written in {gen_s:.1f} s")
    store = work / "store"
    res, wall, launches, peak = drive(
        PipelineConfig(data_path=str(edges_pq), batch_rows=BATCH_ROWS, max_iter=5,
                       outlier_method="both", lof_k=LOF_K, snapshot_out=str(store),
                       device="cuda"), "main path")
    summary = path_summary(res, is_anomaly, wall, launches, peak)
    require(summary["lof_impl"] == "ivf", "lof_impl='auto' did not resolve to IVF at this size")
    require(launches["knn_topk"] >= 1, "the main path's canary never launched knn_topk")
    summary.update(publish_summary(res, store))
    print(json.dumps({"main_path": {**summary, "data_format": "parquet",
                                    "batch_rows": BATCH_ROWS, "input_write_seconds": gen_s}}),
          flush=True)
    main_launches = launches
    feats_main = res.features
    table_main = res.edge_table
    orig_main = generator_ids(res.edge_table.names)
    phase5 = {"labels": res.labels, "flags": res.outliers.outlier_vertices,
              "features": feats_main, "auroc": summary["lof_auroc"], "wall": wall,
              "store_arrays": store_arrays(store)}
    del res

    # ---- 5c. the main path under the run harness -------------------------
    run_harness_path(work, edges_pq, phase5)

    # ---- 7. serving: phase 4's store card against CPU, phase 5's on the card
    serve_launches = run_serving(work)

    # ---- 7c/7d. the replicated serving plane on the same two stores -----
    replicated = run_replicated(work)
    serve_launches = {k: serve_launches[k] + replicated[k] for k in serve_launches}

    # ---- 5b. the weighted exact path, on the edge list -------------------
    res, wall, launches, peak = drive(
        PipelineConfig(data_path=str(weighted), data_format="edgelist", max_iter=5,
                       outlier_method="both", lof_k=LOF_K, lof_impl="exact",
                       edge_weight_col=2, device="cuda"),
        "weighted path")
    require(launches["knn_topk"] > 0, "the weighted exact path never launched knn_topk")
    print(json.dumps({"weighted_path": path_summary(res, is_anomaly, wall, launches, peak)}),
          flush=True)
    feats = res.features
    del res

    # ---- 6. the kernel at its path's shape; IVF against exact ------------
    # launches: the fast instance's count on the main path (the canary),
    # the general instance's in phase 4's lof_k = 200 run, the wide one's in
    # its lof_k = 1500 run
    entry = kernel_entry(feats, LOF_K, "weighted_path_features", main_launches["knn_topk_fast"])
    entry["weighted_path_launches"] = launches["knn_topk_fast"]
    general = general_entries(pipeline_launches["wide_k"]["knn_topk_general"], features=feats)
    del feats
    entries = [entry] + general + [wide_entry(pipeline_launches["widest_k"]["knn_topk_wide"])]
    entries = with_serving_launches(entries, serve_launches)
    # The JAX package gates the index's recall at 0.999 on its LOF policy
    # tests' cloud (20,000 x 8, k = 32); at the main path's size, k = 128,
    # the index (its algorithm with its defaults) measured recall 0.998 on
    # the pipeline's features and 0.997 on the clustered cloud (PERF.md),
    # so there the gates are the LOF's AUROC and the TF32 check, and the
    # recall is reported.
    full, full_out = blob_cloud(V_MAIN)
    gate, gate_out = blob_cloud(20_000)
    print(json.dumps({"ivf": [
        ivf_entry(feats_main, is_anomaly[orig_main], "main_path_features"),
        ivf_entry(torch.from_numpy(full).cuda(), full_out, "blob"),
        ivf_entry(torch.from_numpy(gate).cuda(), gate_out, "blob_jax_gate", k=32,
                  min_recall=IVF_MIN_RECALL),
    ]}), flush=True)
    del feats_main, full, full_out, gate, gate_out

    # ---- 8. Louvain and Leiden, and the graph-ops surface ---------------
    print(json.dumps({"community_small": community_small(work)}), flush=True)
    community_full(edges_pq)

    # ---- 9. the GraphFrames entry point ---------------------------------
    entries = with_frames_launches(entries, run_frames(work, edges_pq, table_main))
    del table_main

    # ---- 10. the blocked superstep family --------------------------------
    run_blocked(work)

    # ---- 11. the multi-device pipeline on a virtual mesh ----------------
    mesh_launches = run_mesh(work, edges_pq, is_anomaly, phase5)

    # ---- 12. the serving plane's sharded repair --------------------------
    serve_mesh_launches = run_serve_mesh(work, phase5)

    # ---- 13. the multi-process mesh; then the kernels --------------------
    run_dist(work, phase5["store_arrays"])
    print_kernels(with_serve_mesh_launches(with_mesh_launches(entries, mesh_launches),
                                           serve_mesh_launches))


if __name__ == "__main__":
    sys.exit(main())
