"""Wrapper of the hand-written Hopper kNN kernel (``csrc/knn_topk.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into
``build/graphmine_tpu_torch/`` under the checkout at first use, loaded with
``ctypes`` and launched on PyTorch's current stream. The source holds three
instances of the kernel: the fast one for F <= 8 and k <= 128 (the main
path's shape), the general one for every other F <= 64 whose top-k keys
fit in shared memory beside its ring of tiles, and the wide one for the
rest (F > 64, or k too large for the general instance's keys).
:func:`launch_plan` picks the instance and its shape (tile, stages, rows,
where the queries and the keys live, shared memory) on the host, and the
call passes them on. One call launches a prologue that packs the points
and their norms into scratch the wrapper allocates, then the main kernel.
``launches`` counts the calls of this process and ``instance_launches``
the calls of each instance; the chip smoke resets and reads them to show
that a pipeline went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "knn_topk.cu"
BUILD_DIR = _PKG.parent / "build" / "graphmine_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

# The fast instance's fixed shape (csrc/knn_topk.cu: kFeatPad, kMaxK, 16
# warps of 6 rows, a ring of 4 tiles of 512 points beside 96 x 160 keys).
FAST_F = 8
FAST_K = 128
FAST_TILE = 512
FAST_STAGES = 4
FAST_ROWS_PER_BLOCK = 96
FAST_SMEM_BYTES = 4 * 512 * 9 * 4 + 96 * (128 + 32) * 8 + 4 * (8 + 4)
# The general instance (csrc/knn_topk.cu: kGen*): F <= 64 rounded up to 8
# (fpad), a ring of 3 or 4 stages of `tile` points, 16 warps of R query rows,
# each row kcap = k rounded up to 32 keys and a 32-key buffer, the queries
# in registers where fpad is 8 and staged in shared memory otherwise.
GENERAL_WARPS = 16
GENERAL_MAX_F = 64
GENERAL_TILE_FLOATS = 4608  # a stage's floats at most, norms included
GENERAL_STAGES = (4, 3)
GENERAL_ROWS_PER_WARP = {"registers": (6, 4, 3, 2, 1), "shared": (8, 6, 4, 3, 2, 1)}
# The wide instance (no ring): 16 warps of R rows reading points and
# queries through L1/L2, keys in shared memory while they fit, else in
# device scratch.
WIDE_WARPS = 16
WIDE_ROWS_PER_WARP = (6, 3, 1)
KEY_BYTES = 8
SMEM_LIMIT_BYTES = 232_448  # dynamic shared memory a block may opt into on sm_90

launches = 0
instance_launches = {"fast": 0, "general": 0, "wide": 0}
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kNN kernel is built from source on the card's host")


def library_path() -> Path:
    """Where :func:`build` puts the library. Its name carries a hash of the
    source and flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libknn_topk_{digest}.so"


def build(verbose: bool = False) -> float:
    """Compile the kernel if the library for this source is missing;
    returns the seconds spent."""
    lib = library_path()
    t0 = time.perf_counter()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
               "-o", str(tmp), str(SOURCE)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if verbose or proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr, flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building {SOURCE}")
        os.replace(tmp, lib)
    _load(lib)
    return time.perf_counter() - t0


def _load(lib: Path) -> None:
    global _lib
    if _lib is not None:
        return
    handle = ctypes.CDLL(str(lib))
    fn = handle.knn_topk_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    handle.knn_topk_scratch_bytes.argtypes = [ctypes.c_int]
    handle.knn_topk_scratch_bytes.restype = ctypes.c_size_t
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    gen = handle.knn_general_f32
    gen.argtypes = [ptr, i32, i32, i32, i32, i32, i32, i32, i32, ctypes.c_size_t, ptr, ptr, ptr,
                    ptr]
    gen.restype = ctypes.c_int
    handle.knn_general_scratch_bytes.argtypes = [i32, i32]
    handle.knn_general_scratch_bytes.restype = ctypes.c_size_t
    wide = handle.knn_wide_f32
    wide.argtypes = [ptr, i32, i32, i32, i32, i32, ctypes.c_size_t, ptr, ptr, ptr, ptr, ptr, ptr]
    wide.restype = ctypes.c_int
    _lib = handle


def general_tile(fpad: int) -> int:
    """Points per stage of the general instance's ring: the most, as a
    power of two up to 512, whose ``fpad`` features and norm fit in
    :data:`GENERAL_TILE_FLOATS`."""
    tile = 512
    while tile * (fpad + 1) > GENERAL_TILE_FLOATS:
        tile //= 2
    return tile


def general_smem_bytes(fpad: int, tile: int, stages: int, rows_per_warp: int, kcap: int,
                       queries: str) -> int:
    """The general instance's dynamic shared memory: the ring, each row's
    kcap keys and 32-key buffer, the staged query rows (``queries ==
    "shared"``) and a barrier and a release count per stage."""
    rows = GENERAL_WARPS * rows_per_warp
    return (stages * tile * (fpad + 1) * 4 + rows * (kcap + 32) * KEY_BYTES
            + (rows * fpad * 4 if queries == "shared" else 0) + stages * (8 + 4))


def launch_plan(n: int, f: int, k: int) -> dict:
    """The instance that :func:`knn_topk` launches for ``n`` points of ``f``
    features at ``k`` (a pure function of the shape): ``instance``
    (``"fast"``, ``"general"`` or ``"wide"``), ``tile`` and ``stages`` (the
    ring; 0 for the wide instance, which has none), ``rows_per_warp``,
    ``rows_per_block``, ``queries`` (``"registers"``, ``"shared"`` or, for
    the wide instance, ``"global"``), ``kcap`` (keys kept a row), ``topk``
    (``"shared"`` or ``"global"``: where those keys live), ``smem_bytes``
    (the block's dynamic shared memory, at most :data:`SMEM_LIMIT_BYTES`)
    and ``scratch_keys`` (the 8-byte keys of device scratch, 0 in shared
    memory).

    The general instance takes F <= 64 with the most rows a warp, then the
    most stages, whose keys fit beside its ring; the wide one
    (:func:`wide_plan`) takes the rest."""
    if not 0 < k < n:
        raise ValueError(f"knn_topk needs 0 < k < N; got k={k}, N={n}")
    if f < 1:
        raise ValueError(f"knn_topk needs at least one feature; got {f}")
    if n >= 1 << 31:
        raise ValueError(f"knn_topk: N={n} out of range")
    if f <= FAST_F and k <= FAST_K:
        return {"instance": "fast", "tile": FAST_TILE, "stages": FAST_STAGES, "rows_per_warp": 6,
                "rows_per_block": FAST_ROWS_PER_BLOCK, "queries": "registers", "kcap": FAST_K,
                "topk": "shared", "smem_bytes": FAST_SMEM_BYTES, "scratch_keys": 0}
    kcap = -(-k // 32) * 32
    if f <= GENERAL_MAX_F:
        fpad = -(-f // 8) * 8
        tile = general_tile(fpad)
        queries = "registers" if fpad == 8 else "shared"
        for r in GENERAL_ROWS_PER_WARP[queries]:
            for stages in GENERAL_STAGES:
                smem = general_smem_bytes(fpad, tile, stages, r, kcap, queries)
                if smem <= SMEM_LIMIT_BYTES:
                    return {"instance": "general", "tile": tile, "stages": stages,
                            "rows_per_warp": r, "rows_per_block": GENERAL_WARPS * r,
                            "queries": queries, "kcap": kcap, "topk": "shared",
                            "smem_bytes": smem, "scratch_keys": 0}
    return wide_plan(n, f, k)


def wide_plan(n: int, f: int, k: int) -> dict:
    """The wide instance's plan (the keys of :func:`launch_plan`): the most
    rows a warp whose keys fit in shared memory, and past that one row a
    warp with its keys in device scratch. It takes any shape; the chip
    smoke launches it beside the general instance at the same shapes."""
    kcap = -(-k // 32) * 32
    wide = {"instance": "wide", "tile": 0, "stages": 0, "queries": "global", "kcap": kcap}
    for r in WIDE_ROWS_PER_WARP:
        smem = WIDE_WARPS * r * (kcap + 32) * KEY_BYTES
        if smem <= SMEM_LIMIT_BYTES:
            return {**wide, "rows_per_warp": r, "rows_per_block": WIDE_WARPS * r,
                    "topk": "shared", "smem_bytes": smem, "scratch_keys": 0}
    rows = WIDE_WARPS
    return {**wide, "rows_per_warp": 1, "rows_per_block": rows, "topk": "global",
            "smem_bytes": WIDE_WARPS * 32 * KEY_BYTES, "scratch_keys": -(-n // rows) * rows * kcap}


def knn_topk(points: torch.Tensor, k: int):
    """k nearest neighbours of every row of ``points`` (float32 ``[N, F]``
    on a CUDA device, contiguous), self excluded: ``(d2 [N, k] float32,
    idx [N, k] int32)``, ascending, ties to the smaller index. Any F >= 1
    and 0 < k < N; :func:`launch_plan` picks the instance."""
    if not points.is_cuda:
        raise ValueError("knn_topk takes a CUDA tensor; the CPU runs ops.knn._tiled_knn")
    if points.dtype != torch.float32 or points.dim() != 2 or not points.is_contiguous():
        raise ValueError("knn_topk takes a contiguous float32 [N, F] tensor")
    return run_plan(points, k, launch_plan(points.shape[0], points.shape[1], k))


def run_plan(points: torch.Tensor, k: int, plan: dict):
    """:func:`knn_topk` on the instance of ``plan`` (:func:`launch_plan`'s
    or :func:`wide_plan`'s for the same shape); ``points`` as there."""
    global launches
    n, f = points.shape
    if _lib is None:
        build()
    dev = points.device
    out_d = torch.empty((n, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((n, k), dtype=torch.int32, device=dev)
    # Scratch is freed on return while the kernel may still run: safe, since
    # the caching allocator hands it out again only to later work on this
    # stream.
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if plan["instance"] == "fast":
            scratch = torch.empty(_lib.knn_topk_scratch_bytes(n) // 4, dtype=torch.float32,
                                  device=dev)
            err = _lib.knn_topk_f32(points.data_ptr(), n, f, k, out_d.data_ptr(),
                                    out_i.data_ptr(), scratch.data_ptr(), stream)
        elif plan["instance"] == "general":
            tiles = torch.empty(_lib.knn_general_scratch_bytes(n, f) // 4, dtype=torch.float32,
                                device=dev)
            err = _lib.knn_general_f32(
                points.data_ptr(), n, f, k, plan["tile"], plan["stages"], plan["rows_per_warp"],
                int(plan["queries"] == "registers"), plan["kcap"], plan["smem_bytes"],
                tiles.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), stream)
        else:
            packed = torch.empty((n, -(-f // 8) * 8), dtype=torch.float32, device=dev)
            norms = torch.empty(n, dtype=torch.float32, device=dev)
            topk = (torch.empty(plan["scratch_keys"], dtype=torch.int64, device=dev)
                    if plan["topk"] == "global" else None)
            err = _lib.knn_wide_f32(
                points.data_ptr(), n, f, k, plan["rows_per_warp"], plan["kcap"],
                plan["smem_bytes"], packed.data_ptr(), norms.data_ptr(),
                None if topk is None else topk.data_ptr(), out_d.data_ptr(),
                out_i.data_ptr(), stream)
    if err:
        raise RuntimeError(f"knn_topk ({plan['instance']} instance) launch failed: "
                           f"cudaError {err}")
    launches += 1
    instance_launches[plan["instance"]] += 1
    return out_d, out_i
