#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``graphmine_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --kernels-only   # phases 1-3, then the kernel alone

In order, and failing on the first phase that fails:

1. prints the card's name and power limit (``nvidia-smi``) and turns TF32
   off for matrix products and cuDNN;
2. builds the kernel of the main path from ``graphmine_tpu_torch/csrc``;
3. holds the kernel against its plain PyTorch version on the card, on
   tie-free normal clouds and on clouds of points on the integer grid
   [0, 4)^F, full of exact distance ties (one of 4,096 points and, in the
   full run, one at the main path's shape, 262,144 x 8): kNN indices
   equal, distances within rtol 1e-5 / atol 1e-5, rows ascending, self
   excluded;
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
   indices equal there too), times the kernel, the plain version and one
   library call (``cdist`` + ``topk``) with CUDA events, and prints the
   ``kernels`` JSON line, with the operations bound, then the unfused
   floor on a line of its own;
7. prints the last line, ``{"ok": true, "device": {...}}``.

``--kernels-only`` skips the 25M-edge graph: after phase 3 it holds and
times the kernel at the main path's shape (262,144 x 8, k = 128) on a
normal cloud (the ``kernels`` entry, with its plain and library times), on
the [0, 4)^8 grid cloud and on a constant cloud (every distance 0, so
each row inserts only its first k candidates: the kernel's time with
next to no top-k work), then prints the ``kernels`` line, the floor line
and the last line.

It exits non-zero, printing no result, where CUDA is absent or where the
port's package is not beside this file.
"""

from __future__ import annotations

import argparse
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
FULL_SHAPE = (V_MAIN, 8, LOF_K)  # the kNN's shape on the main path
RTOL = ATOL = 1e-5

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

    from graphmine_tpu_torch.kernels import knn_cuda

    # ---- 2. build -------------------------------------------------------
    build_s = knn_cuda.build(verbose=True)
    log(f"kernel built in {build_s:.2f} s")
    print(json.dumps({"build_seconds": build_s}), flush=True)

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


def run_main_path(work: Path) -> None:
    """Phases 4-6: the pipeline on the card against the CPU, the main path,
    and the kernel at the main path's shape."""
    import torch

    from graphmine_tpu_torch import datasets
    from graphmine_tpu_torch.kernels import knn_cuda
    from graphmine_tpu_torch.ops.lof import auroc
    from graphmine_tpu_torch.pipeline import PipelineConfig, run_pipeline

    # ---- 4. the pipeline on the card against the CPU, small graph -------
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

    # ---- 5. the main path -----------------------------------------------
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

    # ---- 6. kernels at the main path's shape ----------------------------
    feats = res.features
    del res
    entry = kernel_entry(feats, LOF_K, "main_path_features", launches["knn_topk"])
    print_kernels([entry])


if __name__ == "__main__":
    sys.exit(main())
