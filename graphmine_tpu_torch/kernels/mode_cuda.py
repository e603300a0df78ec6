"""Wrapper of the hand-written row-mode kernel of the bucketed LPA superstep
(``csrc/bucketed_mode.cu``).

The source is compiled with ``nvcc`` for ``sm_90a`` into
``build/graphmine_tpu_torch/`` under the checkout at first use, loaded with
``ctypes`` and launched on PyTorch's current stream. It takes the row mode
of every width class of a fused, unweighted
:class:`~graphmine_tpu_torch.ops.bucketed_mode.BucketedModePlan` in at most
one launch a width tier: narrow (w <= 32, a group of lanes a row), mid
(w <= 2048, whole warps a row and a hash table in shared memory) and wide
(a block a row, its table in dynamic shared memory; a row with more slots
than the table holds is split into parts over ranges of the labels' hash,
a block each, which meet in a little scratch).

:func:`plan_table` lays out a plan's classes once, when the plan is built:
a descriptor a class (the pointers of its ``send_idx`` and ``vertex_ids``,
no copy of them; its width, rows, rows a block, first block within its
tier, lanes or table entries a row, parts a row, scratch) on the plan's
device, each tier's classes widest first, and the classes wider than
:data:`MAX_WIDTH`, which stay on the plain ``_bucket_mode``.
:func:`launch` runs the kernel for a CUDA tensor or raises; the process's
counters count its launches and rows, and the rows of the plain path on
the card (:data:`PLAIN_ROWS`, counted by the superstep's routing).

The labels and the output need not have one length. One card's plan reads
and writes ``[V]``; a shard of the sharded superstep reads the full label
vector (``D*Vc``, its padding senders equal to that length, so they read
the sentinel) and writes its own chunk by local row, with scratch rows past
it for the padding rows.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from graphmine_tpu_torch.kernels.knn_cuda import BUILD_DIR, _nvcc
from graphmine_tpu_torch.obs.registry import PROCESS

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "bucketed_mode.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC")

TIERS = ("narrow", "mid", "wide")
# csrc/bucketed_mode.cu: kNarrowThreads, kMidThreads, kMidTable, kWideThreads,
# kWideMaxTable.
NARROW_MAX_W = 32
NARROW_THREADS = 256
MID_MAX_W = 2048
MID_THREADS = 256
MID_TABLE = 4096
MID_MAX_ROWS = MID_THREADS // 32
WIDE_THREADS = 512
WIDE_MAX_TABLE = 8192
# A wide row's parts keep each part's table at most 3/4 full on all-distinct
# labels (the kernel redoes a range past 7/8 in halves). At 5/8 graph500-22's
# 34,992- and 10,368-wide rows take 7 and 3 parts, each reading the whole
# row, and the wide tier ran 16% longer on the card.
WIDE_LOAD = (3, 4)
# The widest row the kernel takes: 32 parts. Each part reads the whole row,
# so a row's reads grow as its width squared; a wider class (only where the
# hub budget runs out) stays on the plain row sort.
MAX_PARTS = 32
MAX_WIDTH = MAX_PARTS * WIDE_MAX_TABLE * WIDE_LOAD[0] // WIDE_LOAD[1]
# Columns of a class's descriptor (int64), the kernel's ClassDesc.
DESC_COLUMNS = ("send", "vids", "width", "rows", "rows_per_block", "first_block", "cap",
                "parts", "scratch")

LAUNCHES = PROCESS.counter("graphmine_lpa_mode_kernel_launches_total",
                           "launches of the bucketed LPA superstep's row-mode kernel")
KERNEL_ROWS = PROCESS.counter("graphmine_lpa_mode_kernel_rows_total",
                              "non-hub rows of fused plans whose mode the kernel took")
PLAIN_ROWS = PROCESS.counter("graphmine_lpa_mode_plain_rows_total",
                             "non-hub rows of fused plans on a CUDA device whose mode the "
                             "plain PyTorch path took")
_lib = None


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def class_layout(width: int) -> dict | None:
    """How the kernel runs a class of ``width`` (a pure function of it):
    ``tier``, ``rows_per_block``, ``cap`` (lanes a row in the narrow tier,
    table entries a row otherwise) and ``parts`` (the wide tier's blocks
    a row, each over one range of the labels' hash; else 1); ``None`` past
    :data:`MAX_WIDTH`."""
    if not 1 <= width <= MAX_WIDTH:
        return None
    if width <= NARROW_MAX_W:
        lanes = _pow2_at_least(width)
        return {"tier": "narrow", "rows_per_block": NARROW_THREADS // lanes, "cap": lanes,
                "parts": 1}
    if width <= MID_MAX_W:
        cap = _pow2_at_least(2 * width)
        return {"tier": "mid", "rows_per_block": min(MID_MAX_ROWS, MID_TABLE // cap), "cap": cap,
                "parts": 1}
    cap = min(_pow2_at_least(2 * width), WIDE_MAX_TABLE)
    num, den = WIDE_LOAD
    return {"tier": "wide", "rows_per_block": 1, "cap": cap,
            "parts": -(-width * den // (cap * num))}


@dataclass(frozen=True)
class ModeTable:
    """A fused plan's classes laid out for the kernel (:func:`plan_table`).

    ``desc``: int64 ``[kernel classes, 9]`` on the plan's device, columns
    :data:`DESC_COLUMNS`, the classes in tier order and widest first within
    a tier; ``classes``: the plan's class index of each row of ``desc``;
    ``tier_classes`` and ``tier_blocks``: each tier's classes and grid;
    ``wide_cap``: the wide tier's largest table; ``scratch``: int64
    ``[rows, 2]`` zeros, two words a wide row of several parts (where its
    parts meet; the kernel leaves them zero); ``plain_classes``: the plan's
    classes past :data:`MAX_WIDTH`; ``kernel_rows``/``plain_rows``: their
    rows; ``launches``: the tiers that have a class. A plan's launches run
    one at a time (its stream orders them): they share the scratch."""

    desc: torch.Tensor = field(repr=False)
    scratch: torch.Tensor = field(repr=False)
    classes: tuple
    tier_classes: tuple
    tier_blocks: tuple
    wide_cap: int
    plain_classes: tuple
    kernel_rows: int
    plain_rows: int
    launches: int
    out_rows: int


def plan_table(send_idx: tuple, vertex_ids: tuple, out_rows: int) -> ModeTable:
    """The :class:`ModeTable` of a fused plan's ``send_idx`` matrices and
    ``vertex_ids`` (class by class, each row's target in an output of
    ``out_rows``), on their device. Host work, one small copy, one read of
    the targets' range and the wide rows' scratch; the matrices are
    referenced by pointer, not copied. A class past :data:`MAX_WIDTH`, or
    whose tensors are not contiguous int32, stays on the plain path. A
    kernel row whose target lies outside ``[0, out_rows)`` raises."""
    layouts = [class_layout(int(s.shape[1]))
               if s.dtype == torch.int32 and s.is_contiguous() and ids.is_contiguous()
               and ids.dtype == torch.int32 else None
               for s, ids in zip(send_idx, vertex_ids)]
    device = send_idx[0].device if send_idx else torch.device("cpu")
    _check_targets([ids for ids, lay in zip(vertex_ids, layouts)
                    if lay is not None and ids.numel()], int(out_rows))
    split = [b for b, lay in enumerate(layouts) if lay is not None and lay["parts"] > 1]
    scratch = torch.zeros((sum(int(send_idx[b].shape[0]) for b in split), 2), dtype=torch.int64,
                          device=device)
    offsets, at = {}, 0
    for b in split:
        offsets[b] = scratch.data_ptr() + at * 16
        at += int(send_idx[b].shape[0])
    rows, classes, tier_classes, tier_blocks = [], [], [], []
    for tier in TIERS:
        members = sorted((b for b, lay in enumerate(layouts)
                          if lay is not None and lay["tier"] == tier),
                         key=lambda b: -int(send_idx[b].shape[1]))
        blocks = 0
        for b in members:
            lay, n = layouts[b], int(send_idx[b].shape[0])
            rows.append([send_idx[b].data_ptr(), vertex_ids[b].data_ptr(),
                         int(send_idx[b].shape[1]), n, lay["rows_per_block"], blocks, lay["cap"],
                         lay["parts"], offsets.get(b, 0)])
            blocks += -(-n // lay["rows_per_block"]) * lay["parts"]
        classes += members
        tier_classes.append(len(members))
        tier_blocks.append(blocks)
    plain = tuple(b for b, lay in enumerate(layouts) if lay is None)
    desc = torch.tensor(rows, dtype=torch.int64).reshape(-1, len(DESC_COLUMNS)).to(device)
    return ModeTable(
        desc=desc, scratch=scratch, classes=tuple(classes), tier_classes=tuple(tier_classes),
        tier_blocks=tuple(tier_blocks),
        wide_cap=max((layouts[b]["cap"] for b in classes if layouts[b]["tier"] == "wide"),
                     default=0),
        plain_classes=plain, kernel_rows=sum(int(send_idx[b].shape[0]) for b in classes),
        plain_rows=sum(int(send_idx[b].shape[0]) for b in plain),
        launches=sum(1 for c in tier_classes if c), out_rows=int(out_rows))


def _check_targets(targets: list, out_rows: int) -> None:
    """Raise unless every entry of ``targets`` lies in ``[0, out_rows)``
    (one read of their smallest and largest)."""
    if not targets:
        return
    ends = torch.stack([torch.stack([t.min(), t.max()]) for t in targets]).to(torch.int64)
    lo, hi = int(ends[:, 0].min()), int(ends[:, 1].max())
    if lo < 0 or hi >= out_rows:
        raise ValueError(f"a row's target lies outside [0, {out_rows}): the plan's targets "
                         f"span [{lo}, {hi}]")


def library_path() -> Path:
    """Where :func:`build` puts the library. Its name carries a hash of the
    source and flags, so an edited source is rebuilt."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libbucketed_mode_{digest}.so"


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
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn = handle.lpa_mode_rows
    fn.argtypes = [ptr, ptr, i32, ptr, i32, i64, i32, i64, i32, i64, i32, ptr]
    fn.restype = ctypes.c_int
    _lib = handle


def launch(labels: torch.Tensor, out: torch.Tensor, table: ModeTable) -> None:
    """Write the mode of every class of ``table`` into ``out`` (int32
    ``[table.out_rows]``, contiguous, on the table's CUDA device; rows no
    class targets keep their value) from ``labels`` (int32 ``[L]``,
    contiguous, on the same device; a sender equal to ``L`` reads the
    sentinel): one launch a tier that has a class. Raises for anything
    else, a CPU tensor included, before counting a launch."""
    if not (labels.is_cuda and out.is_cuda):
        raise ValueError("the row-mode kernel takes CUDA tensors; the CPU runs "
                         "ops.bucketed_mode._bucket_mode")
    if (labels.dtype != torch.int32 or out.dtype != torch.int32 or labels.dim() != 1
            or out.dim() != 1 or not (labels.is_contiguous() and out.is_contiguous())
            or out.device != labels.device or table.desc.device != labels.device
            or labels.data_ptr() == out.data_ptr()):
        raise ValueError("the row-mode kernel takes two distinct contiguous 1-D int32 tensors "
                         "on the device of the plan's table")
    if out.shape[0] != table.out_rows:
        raise ValueError(f"the plan's table writes an output of {table.out_rows} rows; "
                         f"got {out.shape[0]}")
    if _lib is None:
        build()
    (n_narrow, n_mid, n_wide), (b_narrow, b_mid, b_wide) = table.tier_classes, table.tier_blocks
    with torch.cuda.device(labels.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.lpa_mode_rows(labels.data_ptr(), out.data_ptr(), labels.shape[0],
                                 table.desc.data_ptr(), n_narrow, b_narrow, n_mid, b_mid,
                                 n_wide, b_wide, table.wide_cap, stream)
    if err:
        raise RuntimeError(f"lpa_mode_rows launch failed: cudaError {err}")
    LAUNCHES.inc(table.launches)
    KERNEL_ROWS.inc(table.kernel_rows)
