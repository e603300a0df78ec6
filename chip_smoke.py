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
3. holds the kernel against its plain PyTorch version on the card, on
   tie-free normal clouds and on clouds of points on the integer grid
   [0, 4)^F, full of exact distance ties (one of 4,096 points and, in the
   full run, one at the main path's shape, 262,144 x 8): kNN indices
   equal, distances within rtol 1e-5 / atol 1e-5, rows ascending, self
   excluded;
4. runs the port's pipeline on the card and on the CPU on small planted
   graphs (4,096 vertices): unweighted with the exact kNN, with edge
   weights in quarters (sums exact in float32) and with the IVF kNN: labels
   and recursive-LPA flags equal, features within rtol 1e-5 / atol 1e-6,
   LOF within rtol 1e-4 on 99.9% of vertices and 1e-2 on all (the
   features' last bits differ between the card's and the CPU's math
   libraries, and LOF amplifies a near-tie that rounds apart), and the IVF
   run twice on the card bit-equal;
5. drives the main path, the JAX package's default pipeline:
   ``run_pipeline`` on an edge list of
   ``planted_anomaly_graph(1 << 18, 25_000_000, seed=9)`` (the JAX
   package's e2e bench size) with ``max_iter=5``, ``outlier_method="both"``,
   ``lof_k=128``, ``lof_impl="auto"`` (the IVF index at this size), native
   ingest with quarantine on, the launch counts set to 0 just before and
   read just after; prints the ``main_path`` line with the resolved LOF
   impl, any ``ivf_fallback`` and the ``quarantine`` record;
5b. drives the weighted exact path: the same graph with a third column of
   weights ``default_rng(7).integers(1, 16, E) / 4``, ``edge_weight_col=2``
   and ``lof_impl="exact"``, counts reset and read the same way; prints the
   ``weighted_path`` line (``launches.knn_topk`` >= 1);
6. holds the kernel against its plain version at the shape 5b gave it (the
   pipeline's own feature matrix, whose duplicate rows tie; indices equal
   there too), times the kernel, the plain version and one library call
   (``cdist`` + ``topk``) with CUDA events, and prints the ``kernels`` line,
   with the operations bound, then the unfused floor on a line of its own;
   then holds the IVF kNN of phase 5's features and of clustered clouds
   with planted outliers (262,144 x 8 at k = 128, and the JAX package's
   gate cloud, 20,000 x 8 at k = 32) against the kernel's exact kNN:
   |AUROC(IVF LOF) - AUROC(exact LOF)| <= 0.005 and the same indices with
   TF32 allowed on all three, recall >= 0.999 on the gate cloud (the
   recall at k = 128 is reported); prints the ``ivf`` line;
7. prints the last line, ``{"ok": true, "device": {...}}``.

``--kernels-only`` skips the pipelines: after phase 3 it holds and times
the kernel at the main path's shape (262,144 x 8, k = 128) on a normal
cloud (the ``kernels`` entry, with its plain and library times), on the
[0, 4)^8 grid cloud and on a constant cloud (every distance 0, so each
row inserts only its first k candidates: the kernel's time with next to no
top-k work), then prints the ``kernels`` line, the floor line and the last
line.

It exits non-zero, printing no result, where CUDA is absent or where the
port's package is not beside this file.
"""

from __future__ import annotations

import argparse
import json
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
RTOL = ATOL = 1e-5
# The IVF gates of the JAX package's LOF policy tests
IVF_MIN_RECALL = 0.999
IVF_MAX_DELTA_AUROC = 0.005

# One H100 SXM (the published dense peaks at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
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

    Distances must agree within RTOL/ATOL and every row must be ascending,
    in range and free of self. Indices must be equal, ties included: both
    compute bit-equal distances and send ties to the smaller index."""
    import torch

    n = pts.shape[0]
    require(d_k.shape == i_k.shape == (n, k), f"kernel output shape {tuple(d_k.shape)}")
    require(d_k.dtype == torch.float32 and i_k.dtype == torch.int32, "kernel output types")
    require(bool(torch.isfinite(d_k).all()), "kernel distances not finite")
    err = (d_k - d_p).abs()
    require(bool((err <= ATOL + RTOL * d_p.abs()).all()), f"distances differ by {float(err.max())}")
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
    :func:`check_knn`)."""
    import torch

    from graphmine_tpu_torch.kernels import knn_cuda
    from graphmine_tpu_torch.ops.knn import _tiled_knn

    d_k, i_k = knn_cuda.knn_topk(pts, k)
    d_p, i_p = _tiled_knn(pts, k)
    torch.cuda.synchronize()
    return check_knn(pts, k, d_k, i_k, d_p, i_p)


def kernel_ms(pts, k: int) -> float:
    """The kernel's mean milliseconds on ``pts`` over 5 launches."""
    from graphmine_tpu_torch.kernels import knn_cuda

    return cuda_ms(lambda: knn_cuda.knn_topk(pts, k), reps=5)


def kernel_entry(pts, k: int, cloud: str, launches) -> dict:
    """The ``kernels`` line's entry for ``knn_topk`` on ``pts``: parity, the
    kernel's, the plain version's and the library call's times, and the
    bound."""
    from graphmine_tpu_torch.ops.knn import _tiled_knn

    n, f = pts.shape
    parity, ms = hold(pts, k), kernel_ms(pts, k)
    log(f"knn_topk on the {cloud} cloud n={n} f={f} k={k}: {parity}, {ms:.3f} ms")
    plain_ms = cuda_ms(lambda: _tiled_knn(pts, k), reps=1)
    library_ms = cuda_ms(lambda: library_knn(pts, k), reps=1)
    bound_ms, bound_by = knn_bound_ms(n, f, k)
    return {
        "name": "knn_topk", "route": "cuda", "source": KNN_SOURCE, "replaces": KNN_REPLACES,
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


def print_kernels(entries: list) -> None:
    """The ``kernels`` line, then each kernel's unfused floor (computed from
    its shape, not measured) on a line of its own."""
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"unfused_floor_ms": {
        e["name"]: knn_unfused_floor_ms(e["shape"]["n"], e["shape"]["f"], e["shape"]["k"])
        for e in entries}}), flush=True)


def main(argv=None) -> int:
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
    rng = np.random.default_rng(0)
    clouds = [(rng.normal(size=(n, f)), k, "normal") for n, f, k in PARITY_CASES]
    n, f, k = TIED_CASE
    clouds.append((rng.integers(0, 4, size=(n, f)), k, "grid"))
    if not args.kernels_only:  # --kernels-only holds this one in its own phase
        n, f, k = FULL_SHAPE
        clouds.append((rng.integers(0, 4, size=(n, f)), k, "grid"))
    for cloud, k, kind in clouds:
        pts = torch.from_numpy(cloud.astype(np.float32)).to(dev)
        res = hold(pts, k)
        log(f"knn_topk parity {kind} n={cloud.shape[0]} f={cloud.shape[1]} k={k}: {res}")
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
        print_kernels([entry])
    else:
        work = ROOT / "build" / "chip_smoke"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        try:
            run_main_path(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)

    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def small_pipelines(work: Path) -> None:
    """Phase 4: the pipeline on the card against the CPU on 4,096-vertex
    planted graphs: exact kNN, quarter weights, and the IVF index."""
    import torch

    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline

    src, dst, _, _ = datasets.planted_anomaly_graph(4096, 60_000, seed=SEED_MAIN)
    small = work / "small.txt"
    write_edge_list(small, src, dst, np.random.default_rng(7).integers(1, 16, len(src)) / 4)
    cases = {"exact": dict(lof_impl="exact"),
             "weighted": dict(lof_impl="exact", edge_weight_col=2),
             "ivf": dict(lof_impl="ivf")}
    for case, kw in cases.items():
        runs = {d: run_pipeline(PipelineConfig(data_path=str(small), outlier_method="both",
                                               lof_k=32, device=d, **kw))
                for d in ("cuda", "cpu")}
        gpu, cpu = runs["cuda"], runs["cpu"]
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
        log(f"small pipeline, {case}: card == CPU ({gpu.num_communities} communities)")
    from graphmine_tpu_torch.ops.ann import ivf_knn

    feats = gpu.features
    first, again = ivf_knn(feats, 32), ivf_knn(feats, 32)
    torch.cuda.synchronize()
    require(torch.equal(first[0], again[0]) and torch.equal(first[1], again[1]),
            "two IVF runs on the card differ")


def drive(cfg, label: str) -> tuple:
    """One ``run_pipeline`` with the launch counts set to 0 just before and
    read just after: ``(result, wall seconds, launches, peak bytes)``."""
    import torch

    from graphmine_tpu_torch.kernels import knn_cuda
    from graphmine_tpu_torch.pipeline import run_pipeline

    torch.cuda.reset_peak_memory_stats()
    knn_cuda.launches = 0
    t0 = time.perf_counter()
    res = run_pipeline(cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"knn_topk": knn_cuda.launches}
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
    lof_auroc = auroc(res.lof, is_anomaly[res.edge_table.names.astype(np.int64)])
    require(lof_auroc > 0.5, f"LOF AUROC {lof_auroc} no better than chance")
    m = res.metrics
    (lof_sel,) = [r for r in m.of_phase("impl_selected") if r["op"] == "lof_knn"]
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


def run_main_path(work: Path) -> None:
    """Phases 4-6: small pipelines on the card against the CPU, the main
    path, the weighted exact path, the kernel at its shape and the IVF kNN
    against the exact one."""
    import torch

    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.pipeline import PipelineConfig

    # ---- 4. the pipeline on the card against the CPU, small graphs ------
    small_pipelines(work)

    # ---- 5. the main path: the JAX package's default pipeline ----------
    t0 = time.perf_counter()
    src, dst, is_anomaly, _ = datasets.planted_anomaly_graph(V_MAIN, E_MAIN, seed=SEED_MAIN)
    edges, weighted = work / "edges.txt", work / "edges_weighted.txt"
    write_edge_list(edges, src, dst)
    write_edge_list(weighted, src, dst, np.random.default_rng(7).integers(1, 16, len(src)) / 4)
    gen_s = time.perf_counter() - t0
    del src, dst
    log(f"main-path edge lists written in {gen_s:.1f} s")
    res, wall, launches, peak = drive(
        PipelineConfig(data_path=str(edges), max_iter=5, outlier_method="both",
                       lof_k=LOF_K, device="cuda"), "main path")
    summary = path_summary(res, is_anomaly, wall, launches, peak)
    require(summary["lof_impl"] == "ivf", "lof_impl='auto' did not resolve to IVF at this size")
    print(json.dumps({"main_path": {**summary, "edge_list_seconds": gen_s}}), flush=True)
    feats_main = res.features
    orig_main = res.edge_table.names.astype(np.int64)
    del res

    # ---- 5b. the weighted exact path ------------------------------------
    res, wall, launches, peak = drive(
        PipelineConfig(data_path=str(weighted), max_iter=5, outlier_method="both",
                       lof_k=LOF_K, lof_impl="exact", edge_weight_col=2, device="cuda"),
        "weighted path")
    for name, count in launches.items():
        require(count > 0, f"the weighted exact path never launched {name}")
    print(json.dumps({"weighted_path": path_summary(res, is_anomaly, wall, launches, peak)}),
          flush=True)
    feats = res.features
    del res

    # ---- 6. the kernel at its path's shape; IVF against exact ------------
    entry = kernel_entry(feats, LOF_K, "weighted_path_features", launches["knn_topk"])
    print_kernels([entry])
    del feats
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
