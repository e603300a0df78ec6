#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``graphmine_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

In order, and failing on the first phase that fails:

1. prints the card's name and power limit (``nvidia-smi``) and turns TF32
   off for matrix products and cuDNN;
2. builds the kernel of the main path from ``graphmine_tpu_torch/csrc``;
3. holds the kernel against its plain PyTorch version on the card, on
   tie-free normal clouds and on one cloud of points on a small integer
   grid, full of exact distance ties: kNN indices equal, distances within
   rtol 1e-5 / atol 1e-5, rows ascending, self excluded;
4. runs the port's pipeline on the card and on the CPU on a small planted
   graph (4,096 vertices): labels and recursive-LPA flags equal, LOF
   within rtol 1e-4;
5. drives the main path: ``run_pipeline`` on an edge list of
   ``planted_anomaly_graph(1 << 18, 25_000_000, seed=9)`` (the JAX
   package's e2e bench size) with ``max_iter=5``, ``outlier_method="both"``,
   ``lof_k=128``, ``lof_impl="exact"``, with every launch count set to 0
   just before and read just after; prints one ``main_path`` JSON line;
6. holds the kernel against its plain version at the shape the main path
   gave it (the pipeline's own feature matrix, whose duplicate rows tie;
   indices equal there too), times the kernel, the
   plain version and one library call (``cdist`` + ``topk``) with CUDA
   events, and prints the ``kernels`` JSON line;
7. prints the last line, ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result, where CUDA is absent or where the
port's package is not beside this file.
"""

from __future__ import annotations

import json
import shutil
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
RTOL = ATOL = 1e-5

# One H100 SXM (the published dense peaks at the 700 W limit).
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def write_edge_list(path: Path, src: np.ndarray, dst: np.ndarray) -> None:
    """Whitespace edge list ``src dst`` per line, formatted with NumPy in
    bulk (ids right-aligned in a fixed width, padded with spaces)."""
    width = len(str(int(max(src.max(initial=0), dst.max(initial=0)))))

    def digits(x: np.ndarray) -> np.ndarray:
        out = np.full((len(x), width), ord(" "), np.uint8)
        v = x.astype(np.int64)
        for c in range(width - 1, -1, -1):
            out[:, c] = np.where((v > 0) | (c == width - 1), v % 10 + ord("0"), ord(" "))
            v = v // 10
        return out

    sep = np.full((len(src), 1), ord(" "), np.uint8)
    nl = np.full((len(src), 1), ord("\n"), np.uint8)
    path.write_bytes(np.concatenate([digits(src), sep, digits(dst), nl], axis=1).tobytes())


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


def knn_bound_ms(n: int, f: int, k: int) -> tuple[float, str]:
    """Least time one H100 could take for the exact kNN of ``n`` points of
    ``f`` float32 features: every off-diagonal pair costs 2f+3 float32
    operations (f products and f-1 sums for the cross term, the doubling,
    the two norm terms and the clamp), and the points are read once and
    ``[n, k]`` distances and int32 indices written once."""
    ops = float(n) * (n - 1) * (2 * f + 3)
    moved = n * f * 4 + n * k * (4 + 4)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, moved / PEAK_HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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


def main() -> int:
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

    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.kernels import knn_cuda
    from graphmine_tpu_torch.ops.knn import _tiled_knn
    from graphmine_tpu_torch.ops.lof import auroc
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline

    # ---- 2. build -------------------------------------------------------
    build_s = knn_cuda.build(verbose=True)
    log(f"kernel built in {build_s:.2f} s")
    print(json.dumps({"build_seconds": build_s}), flush=True)

    # ---- 3. kernel against plain version: tie-free clouds, a tied grid --
    rng = np.random.default_rng(0)
    clouds = [(rng.normal(size=(n, f)), k, "normal") for n, f, k in PARITY_CASES]
    n, f, k = TIED_CASE
    clouds.append((rng.integers(0, 4, size=(n, f)), k, "grid"))
    for cloud, k, kind in clouds:
        pts = torch.from_numpy(cloud.astype(np.float32)).to(dev)
        d_k, i_k = knn_cuda.knn_topk(pts, k)
        d_p, i_p = _tiled_knn(pts, k)
        torch.cuda.synchronize()
        res = check_knn(pts, k, d_k, i_k, d_p, i_p)
        log(f"knn_topk parity {kind} n={cloud.shape[0]} f={cloud.shape[1]} k={k}: {res}")

    work = ROOT / "build" / "chip_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        # ---- 4. the pipeline on the card against the CPU, small graph ---
        src, dst, _, _ = datasets.planted_anomaly_graph(4096, 60_000, seed=SEED_MAIN)
        small = work / "small.txt"
        write_edge_list(small, src, dst)
        small_runs = {
            d: run_pipeline(PipelineConfig(data_path=str(small), outlier_method="both",
                                           lof_k=32, lof_impl="exact", device=d))
            for d in ("cuda", "cpu")
        }
        gpu, cpu = small_runs["cuda"], small_runs["cpu"]
        require(np.array_equal(gpu.labels, cpu.labels), "LPA labels differ from the CPU's")
        require(np.array_equal(gpu.outliers.outlier_vertices, cpu.outliers.outlier_vertices),
                "recursive-LPA flags differ from the CPU's")
        np.testing.assert_allclose(gpu.lof, cpu.lof, rtol=1e-4)
        log(f"small pipeline: card == CPU ({gpu.num_communities} communities)")

        # ---- 5. the main path -------------------------------------------
        t0 = time.perf_counter()
        src, dst, is_anomaly, _ = datasets.planted_anomaly_graph(V_MAIN, E_MAIN, seed=SEED_MAIN)
        edges = work / "edges.txt"
        write_edge_list(edges, src, dst)
        gen_s = time.perf_counter() - t0
        del src, dst
        log(f"main-path edge list written in {gen_s:.1f} s")
        cfg = PipelineConfig(data_path=str(edges), max_iter=5, outlier_method="both",
                             lof_k=LOF_K, lof_impl="exact", device="cuda")
        torch.cuda.reset_peak_memory_stats()
        knn_cuda.launches = 0
        t0 = time.perf_counter()
        res = run_pipeline(cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"knn_topk": knn_cuda.launches}
        peak = torch.cuda.max_memory_allocated()

        v = res.graph.num_vertices
        require(res.labels.shape == (v,) and res.lof.shape == (v,), "output shapes")
        require(bool(np.isfinite(res.lof).all()), "LOF scores not finite")
        require(1 < res.num_communities < v, f"{res.num_communities} communities")
        flagged = int(res.outliers.outlier_vertices.sum())
        require(flagged > 0 and len(res.outliers.thresholds) >= 10,
                "recursive LPA populated no bottom decile")
        orig = res.edge_table.names.astype(np.int64)
        lof_auroc = auroc(res.lof, is_anomaly[orig])
        require(lof_auroc > 0.5, f"LOF AUROC {lof_auroc} no better than chance")
        for name, count in launches.items():
            require(count > 0, f"the main path never launched {name}")
        print(json.dumps({"main_path": {
            "graph": f"planted_anomaly_graph({V_MAIN}, {E_MAIN}, seed={SEED_MAIN})",
            "wall_seconds": wall, "edge_list_seconds": gen_s,
            "phase_seconds": res.metrics.phase_seconds(),
            "vertices": v, "edges": res.graph.num_edges, "messages": res.graph.num_messages,
            "communities": res.num_communities, "flagged_vertices": flagged,
            "lof_over_1_5": int((res.lof > 1.5).sum()), "feature_mode": res.feature_mode,
            "plan": {key: res.metrics.of_phase("plan_build")[0][key]
                     for key in ("buckets", "hub_vertices", "max_degree")},
            "wedges": res.metrics.of_phase("feature_mode")[0]["wedges"],
            "lof_k": LOF_K, "lof_auroc": lof_auroc, "peak_device_bytes": peak,
            "launches": launches,
        }}), flush=True)

        # ---- 6. kernels at the main path's shape ------------------------
        feats = res.features
        del res
        n, f = feats.shape
        d_k, i_k = knn_cuda.knn_topk(feats, LOF_K)
        d_p, i_p = _tiled_knn(feats, LOF_K)
        torch.cuda.synchronize()
        parity = check_knn(feats, LOF_K, d_k, i_k, d_p, i_p)
        log(f"knn_topk parity at the main path's shape: {parity}")
        del d_k, i_k, d_p, i_p
        kernel_ms = cuda_ms(lambda: knn_cuda.knn_topk(feats, LOF_K), reps=5)
        plain_ms = cuda_ms(lambda: _tiled_knn(feats, LOF_K), reps=1)
        library_ms = cuda_ms(lambda: library_knn(feats, LOF_K), reps=1)
        bound_ms, bound_by = knn_bound_ms(n, f, LOF_K)
        print(json.dumps({"kernels": [{
            "name": "knn_topk", "route": "cuda",
            "source": "graphmine_tpu_torch/csrc/knn_topk.cu",
            "replaces": "graphmine_tpu/pallas_kernels/knn_pallas.py:117",
            "shape": {"n": n, "f": f, "k": LOF_K},
            "launches": launches["knn_topk"], "max_abs_err": parity["max_abs_err"],
            "index_mismatches": parity["index_mismatches"],
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
        }]}), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
