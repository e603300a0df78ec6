"""Segment mode: the most frequent value per segment (PyTorch).

Counterpart of ``graphmine_tpu/ops/segment.py::segment_mode``. Same
algorithm and the same answers: sort (segment, value) pairs, rank each
element within its run of equal pairs, take the maximal rank per segment,
and among the values reaching it the smallest (the deterministic
smallest-label tie-break). ``torch.mode`` is not used: its tie rule is not
documented. The weighted mode takes the value of largest weight sum; each
run's sum is accumulated over that run alone, in message order, never as a
difference of a global cumsum, so it has the same bits on every device
and in every run.
"""

from __future__ import annotations

import torch

_INT32_MAX = (1 << 31) - 1
_INT32_MIN = -(1 << 31)


def segment_mode(segment_ids: torch.Tensor, values: torch.Tensor,
                 num_segments: int, weights: torch.Tensor | None = None):
    """Most frequent ``value`` per segment; ties break toward the smallest.

    Out-of-range segment ids (e.g. ``num_segments`` as a drop sentinel) are
    dropped. Empty segments yield ``(INT32_MAX, 0)``. Returns int32
    ``(mode, count)`` of shape ``[num_segments]``.

    ``weights``: non-negative per-element weights; the winner is then the
    value of largest weight sum and ``count`` that sum (float32).
    """
    if weights is not None:
        return _segment_mode_weighted(segment_ids, values, weights.to(torch.float32),
                                      num_segments)
    seg = segment_ids.to(torch.int64)
    val = values.to(torch.int64)
    # One int64 key sorts (segment, value) lexicographically: the segment
    # in the high 32 bits, the value offset to non-negative in the low 32.
    key, _ = torch.sort((seg << 32) | (val - _INT32_MIN))
    seg_s = key >> 32
    val_s = (key & 0xFFFFFFFF) + _INT32_MIN
    m = key.shape[0]
    pos = torch.arange(m, dtype=torch.int64, device=key.device)
    new_run = torch.ones(m, dtype=torch.bool, device=key.device)
    new_run[1:] = key[1:] != key[:-1]
    run_start = torch.cummax(torch.where(new_run, pos, -1), 0).values
    rank = pos - run_start  # multiplicity - 1 within the run
    # Dropped elements reduce into one extra slot that is cut off below.
    valid = (seg_s >= 0) & (seg_s < num_segments)
    seg_x = torch.where(valid, seg_s, num_segments)
    best = torch.full((num_segments + 1,), _INT32_MIN, dtype=torch.int64,
                      device=key.device)
    best.scatter_reduce_(0, seg_x, rank, "amax")
    is_cand = (rank == best[seg_x]) & valid
    cand = torch.where(is_cand, val_s, _INT32_MAX)
    mode = torch.full((num_segments + 1,), _INT32_MAX, dtype=torch.int64,
                      device=key.device)
    mode.scatter_reduce_(0, seg_x, cand, "amin")
    count = torch.clamp(best[:num_segments] + 1, min=0)
    return mode[:num_segments].to(torch.int32), count.to(torch.int32)


def run_totals(new_run: torch.Tensor, w_sorted: torch.Tensor) -> torch.Tensor:
    """Per-element sum of its run's weights, where ``new_run`` marks the
    first element of each run of a sorted array. Each run is summed on its
    own from its first element to its last (``torch.segment_reduce``, one
    sequential loop per run on either device), so the bits depend on the
    data only."""
    starts = torch.nonzero(new_run).flatten()
    ends = torch.cat([starts[1:], starts.new_full((1,), new_run.shape[0])])
    totals = torch.segment_reduce(w_sorted, "sum", lengths=ends - starts)
    return totals[torch.cumsum(new_run.to(torch.int64), 0) - 1]


def _segment_mode_weighted(segment_ids, values, weights, num_segments: int):
    """Argmax of per-(segment, value) weight sums, ties toward the smallest
    value. A stable sort keeps each run's weights in message order."""
    dev = values.device
    m = values.shape[0]
    if m == 0:
        return (torch.full((num_segments,), _INT32_MAX, dtype=torch.int32, device=dev),
                torch.zeros(num_segments, dtype=torch.float32, device=dev))
    seg = segment_ids.to(torch.int64)
    val = values.to(torch.int64)
    key, order = torch.sort((seg << 32) | (val - _INT32_MIN), stable=True)
    seg_s = key >> 32
    val_s = (key & 0xFFFFFFFF) + _INT32_MIN
    new_run = torch.ones(m, dtype=torch.bool, device=dev)
    new_run[1:] = key[1:] != key[:-1]
    total = run_totals(new_run, weights[order])
    valid = (seg_s >= 0) & (seg_s < num_segments)
    seg_x = torch.where(valid, seg_s, num_segments)
    best = torch.full((num_segments + 1,), float("-inf"), dtype=torch.float32, device=dev)
    best.scatter_reduce_(0, seg_x, torch.where(valid, total, float("-inf")), "amax")
    # every element of a winning run is a candidate (one value per run)
    is_cand = (total == best[seg_x]) & valid
    cand = torch.where(is_cand, val_s, _INT32_MAX)
    mode = torch.full((num_segments + 1,), _INT32_MAX, dtype=torch.int64, device=dev)
    mode.scatter_reduce_(0, seg_x, cand, "amin")
    return mode[:num_segments].to(torch.int32), torch.clamp(best[:num_segments], min=0.0)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment sums ``[num_segments, ...]`` along dim 0
    (``jax.ops.segment_sum``): out-of-range ids are dropped, empty segments
    give 0. Integer sums are exact in any order. Float elements are grouped
    by a stable sort (skipped when the ids already ascend) and each segment
    is reduced on its own (``torch.segment_reduce``): on the CPU in element
    order, as the JAX package's scatter-add runs there, on CUDA by a fixed
    tree. Deterministic on each device, and equal across devices wherever
    every partial sum is exact (integer or quarter weights in float32)."""
    if values.is_floating_point():
        return SegmentSums(segment_ids, num_segments).sum(values)
    seg = segment_ids.to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = values.new_zeros((num_segments + 1, *values.shape[1:]))
    return out.index_add_(0, seg, values)[:num_segments]


def _scatter_extreme(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                     reduce: str) -> torch.Tensor:
    """``segment_min``/``segment_max`` along dim 0 with the JAX identities
    for empty segments (the dtype's max for a minimum, its min for a
    maximum; +-inf for floats); out-of-range ids are dropped. Exact in any
    order, so equal on every device."""
    if values.is_floating_point():
        fill = float("inf") if reduce == "amin" else float("-inf")
    elif values.dtype == torch.bool:
        fill = reduce == "amin"
    else:
        info = torch.iinfo(values.dtype)
        fill = info.max if reduce == "amin" else info.min
    seg = segment_ids.to(torch.int64)
    seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = values.new_full((num_segments + 1, *values.shape[1:]), fill)
    index = seg.view(-1, *([1] * (values.dim() - 1))).expand_as(values)
    return out.scatter_reduce_(0, index, values, reduce)[:num_segments]


def segment_min(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_min`` (see :func:`_scatter_extreme`)."""
    return _scatter_extreme(values, segment_ids, num_segments, "amin")


def segment_max(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_max`` (see :func:`_scatter_extreme`)."""
    return _scatter_extreme(values, segment_ids, num_segments, "amax")


class SegmentSums:
    """Float :func:`segment_sum` over fixed segment ids, for loops that sum
    new values over the same ids every iteration: the stable sort by
    segment (skipped when the ids already ascend) and the segment lengths
    are computed once; each :meth:`sum` gathers the values into that
    order and reduces each segment on its own."""

    def __init__(self, segment_ids: torch.Tensor, num_segments: int):
        seg = segment_ids.to(torch.int64)
        seg = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
        self.order = None
        if seg.shape[0] > 1 and not bool((seg[1:] >= seg[:-1]).all()):
            seg, self.order = torch.sort(seg, stable=True)
        self.lengths = torch.bincount(seg, minlength=num_segments + 1)
        self.num_segments = num_segments

    def sum(self, values: torch.Tensor) -> torch.Tensor:
        """Per-segment float sums ``[num_segments, ...]`` of ``values``
        (one per element, in the ids' element order)."""
        if values.shape[0] == 0:
            return values.new_zeros((self.num_segments, *values.shape[1:]))
        if self.order is not None:
            values = values[self.order]
        return torch.segment_reduce(values, "sum", lengths=self.lengths)[:self.num_segments]
