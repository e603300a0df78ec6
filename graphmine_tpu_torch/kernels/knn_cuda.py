"""Wrapper of the hand-written Hopper kNN kernel (``csrc/knn_topk.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into
``build/graphmine_tpu_torch/`` under the checkout at first use, loaded with
``ctypes`` and launched on PyTorch's current stream. The source holds two
instances of the kernel: the fast one for F <= 8 and k <= 128 (the main
path's shape) and a general one for every other F >= 1 and 0 < k < N.
:func:`launch_plan` picks the instance, its rows per block and its shared
memory on the host, and the call passes them on. One call launches a
prologue that packs the points and their norms into scratch the wrapper
allocates, then the main kernel. ``launches`` counts the calls of this
process and ``instance_launches`` the calls of each instance; the chip
smoke resets and reads them to show that a pipeline went through the
kernel.
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
FAST_ROWS_PER_BLOCK = 96
FAST_SMEM_BYTES = 4 * 512 * 9 * 4 + 96 * (128 + 32) * 8 + 4 * (8 + 4)
# The general instance: 16 warps of R rows, kcap = k rounded up to 32 keys
# a row plus a 32-key buffer, in shared memory while they fit.
GENERAL_WARPS = 16
GENERAL_ROWS_PER_WARP = (6, 3, 1)
KEY_BYTES = 8
SMEM_LIMIT_BYTES = 232_448  # dynamic shared memory a block may opt into on sm_90

launches = 0
instance_launches = {"fast": 0, "general": 0}
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
    gen = handle.knn_general_f32
    gen.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    gen.restype = ctypes.c_int
    handle.knn_general_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    handle.knn_general_smem_bytes.restype = ctypes.c_size_t
    _lib = handle


def launch_plan(n: int, f: int, k: int) -> dict:
    """The instance that :func:`knn_topk` launches for ``n`` points of ``f``
    features at ``k`` (a pure function of the shape): ``instance``
    (``"fast"`` or ``"general"``), ``rows_per_warp``, ``rows_per_block``,
    ``kcap`` (keys kept a row), ``topk`` (``"shared"`` or ``"global"``:
    where those keys live), ``smem_bytes`` (the block's dynamic shared
    memory, at most :data:`SMEM_LIMIT_BYTES`) and ``scratch_keys`` (the
    8-byte keys of device scratch, 0 in shared memory). The general
    instance takes the most rows a warp whose keys fit in shared memory,
    and past that one row a warp with its keys in device scratch."""
    if not 0 < k < n:
        raise ValueError(f"knn_topk needs 0 < k < N; got k={k}, N={n}")
    if f < 1:
        raise ValueError(f"knn_topk needs at least one feature; got {f}")
    if n >= 1 << 31:
        raise ValueError(f"knn_topk: N={n} out of range")
    if f <= FAST_F and k <= FAST_K:
        return {"instance": "fast", "rows_per_warp": 6, "rows_per_block": FAST_ROWS_PER_BLOCK,
                "kcap": FAST_K, "topk": "shared", "smem_bytes": FAST_SMEM_BYTES,
                "scratch_keys": 0}
    kcap = -(-k // 32) * 32
    for r in GENERAL_ROWS_PER_WARP:
        smem = GENERAL_WARPS * r * (kcap + 32) * KEY_BYTES
        if smem <= SMEM_LIMIT_BYTES:
            return {"instance": "general", "rows_per_warp": r, "rows_per_block": GENERAL_WARPS * r,
                    "kcap": kcap, "topk": "shared", "smem_bytes": smem, "scratch_keys": 0}
    rows = GENERAL_WARPS
    return {"instance": "general", "rows_per_warp": 1, "rows_per_block": rows, "kcap": kcap,
            "topk": "global", "smem_bytes": GENERAL_WARPS * 32 * KEY_BYTES,
            "scratch_keys": -(-n // rows) * rows * kcap}


def knn_topk(points: torch.Tensor, k: int):
    """k nearest neighbours of every row of ``points`` (float32 ``[N, F]``
    on a CUDA device, contiguous), self excluded: ``(d2 [N, k] float32,
    idx [N, k] int32)``, ascending, ties to the smaller index. Any F >= 1
    and 0 < k < N; :func:`launch_plan` picks the instance."""
    global launches
    if not points.is_cuda:
        raise ValueError("knn_topk takes a CUDA tensor; the CPU runs ops.knn._tiled_knn")
    if points.dtype != torch.float32 or points.dim() != 2 or not points.is_contiguous():
        raise ValueError("knn_topk takes a contiguous float32 [N, F] tensor")
    n, f = points.shape
    plan = launch_plan(n, f, k)
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
        else:
            packed = torch.empty((n, -(-f // 8) * 8), dtype=torch.float32, device=dev)
            norms = torch.empty(n, dtype=torch.float32, device=dev)
            topk = (torch.empty(plan["scratch_keys"], dtype=torch.int64, device=dev)
                    if plan["topk"] == "global" else None)
            err = _lib.knn_general_f32(
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
