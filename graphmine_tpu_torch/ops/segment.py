"""Segment mode: the most frequent value per segment (PyTorch).

Counterpart of ``graphmine_tpu/ops/segment.py::segment_mode``. Same
algorithm and the same answers: sort (segment, value) pairs, rank each
element within its run of equal pairs, take the maximal rank per segment,
and among the values reaching it the smallest (the deterministic
smallest-label tie-break). ``torch.mode`` is not used: its tie rule is not
documented.
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
    """
    if weights is not None:
        raise NotImplementedError(
            "weighted segment mode: ROADMAP.md queue 1 item 1 (weighted LPA)"
        )
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
