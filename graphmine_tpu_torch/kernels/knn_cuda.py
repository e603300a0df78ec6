"""Wrapper of the hand-written Hopper kNN kernel (``csrc/knn_topk.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into
``build/graphmine_tpu_torch/`` under the checkout at first use, loaded with
``ctypes`` and launched on PyTorch's current stream. ``launches`` counts
the launches of this process; the chip smoke resets and reads it to show
that the pipeline went through the kernel.
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
MAX_K = 128
MAX_F = 8

launches = 0
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the kNN kernel is built from source on the card's host")


def build(verbose: bool = False) -> float:
    """Compile the kernel if the library for this source is missing;
    returns the seconds spent. The library's name carries a hash of the
    source and flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libknn_topk_{digest}.so"
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
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = handle


def knn_topk(points: torch.Tensor, k: int):
    """k nearest neighbours of every row of ``points`` (float32 ``[N, F]``
    on a CUDA device, contiguous), self excluded: ``(d2 [N, k] float32,
    idx [N, k] int32)``, ascending, ties to the smaller index."""
    global launches
    if not points.is_cuda:
        raise ValueError("knn_topk takes a CUDA tensor; the CPU runs ops.knn._tiled_knn")
    if points.dtype != torch.float32 or points.dim() != 2 or not points.is_contiguous():
        raise ValueError("knn_topk takes a contiguous float32 [N, F] tensor")
    n, f = points.shape
    if not 0 < k < n or k > MAX_K:
        raise ValueError(f"knn_topk needs 0 < k < N and k <= {MAX_K}; got k={k}, N={n}")
    if not 0 < f <= MAX_F:
        raise ValueError(f"knn_topk takes 1..{MAX_F} features; got {f}")
    if n >= 1 << 31:
        raise ValueError(f"knn_topk: N={n} out of range")
    if _lib is None:
        build()
    out_d = torch.empty((n, k), dtype=torch.float32, device=points.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=points.device)
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.knn_topk_f32(points.data_ptr(), n, f, k, out_d.data_ptr(),
                                out_i.data_ptr(), stream)
    if err:
        raise RuntimeError(f"knn_topk_f32 launch failed: cudaError {err}")
    launches += 1
    return out_d, out_i
