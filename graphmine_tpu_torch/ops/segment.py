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
