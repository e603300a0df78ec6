#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``graphmine_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3, then the kernel alone

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
   version and one library call (``cdist`` + ``topk``) with CUDA events, and
   prints the ``kernels`` line, with the operations bound, then the
   unfused floors on a line of their own; then holds the IVF kNN of phase
   5's features and of clustered clouds with planted outliers (262,144 x 8
   at k = 128, and the JAX package's gate cloud, 20,000 x 8 at k = 32)
   against the kernel's exact kNN: |AUROC(IVF LOF) - AUROC(exact LOF)| <=
   0.005 and the same indices with TF32 allowed on all three, recall >=
   0.999 on the gate cloud (the recall at k = 128 is reported); prints the
   ``ivf`` line;
7. prints the smoke's total seconds, the card line again and the last
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
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time
from pathlib import Path

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
    ap.add_argument("--kernels-only", action="store_true",
                    help="phases 1-3, then the kernel alone at the main path's shape")
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
            run_main_path(work)
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


def small_pipelines(work: Path) -> dict:
    """Phase 4: the pipeline on the card against the CPU on 4,096-vertex
    planted graphs: exact kNN, quarter weights, the IVF index, parquet
    input, the exact kNN at lof_k = 200 and at lof_k = 1500, and a snapshot
    publish. Returns the launch counts of the lof_k = 200 (``"wide_k"``) and
    lof_k = 1500 (``"widest_k"``) runs on the card."""
    import torch

    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline
    from graphmine_tpu_torch.pipeline.checkpoint import graph_fingerprint
    from graphmine_tpu_torch.serve.snapshot import SnapshotStore

    v = 4096
    src, dst, _, _ = datasets.planted_anomaly_graph(v, 60_000, seed=SEED_MAIN)
    small, small_pq = work / "small.txt", work / "small.parquet"
    write_edge_list(small, src, dst, np.random.default_rng(7).integers(1, 16, len(src)) / 4)
    write_parquet(small_pq, src, dst, v)
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


def run_main_path(work: Path) -> None:
    """Phases 4-6: small pipelines on the card against the CPU, the run
    harness on them, the main path, the main path under the harness, the
    weighted exact path, the kernel at its shapes and the IVF kNN against
    the exact one."""
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
    orig_main = generator_ids(res.edge_table.names)
    phase5 = {"labels": res.labels, "flags": res.outliers.outlier_vertices,
              "features": feats_main}
    del res

    # ---- 5c. the main path under the run harness -------------------------
    run_harness_path(work, edges_pq, phase5)

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
    print_kernels([entry] + general + [wide_entry(pipeline_launches["widest_k"]["knn_topk_wide"])])
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


if __name__ == "__main__":
    sys.exit(main())
