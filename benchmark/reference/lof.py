"""Local Outlier Factor over exact k nearest neighbours (Breunig et al.),
with the configuration's floor on reach distances.

    k-distance(p) = distance to p's k-th nearest neighbour
    reach(p, o)   = max(k-distance(o), d(p, o), eps)
    lrd(p)        = k / sum over p's k neighbours o of reach(p, o)
    LOF(p)        = mean over p's k neighbours o of lrd(o) / lrd(p)

``eps`` is 1e-3 times the mean positive neighbour distance (identical rows
would otherwise make lrd unbounded); a point is not its own neighbour, and
among neighbours at the same distance the smaller index comes first.

The neighbours are chosen on squared distances in the configuration's
stated arithmetic, float32 without tensor cores and without fused
multiply-adds: ``(|q|^2 - 2 q.r) + |r|^2`` with each norm and the cross
term summed feature by feature in order, clamped at 0. The scores are
then worked out in float64. ``precision="tf32"`` is the control: the
cross term taken from operands rounded to TF32 (10 mantissa bits), as a
tensor-core product would take them.
"""

from __future__ import annotations

import torch


def round_to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to nearest even at 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    return ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)


def _feature_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum_f a[..., f] * b[..., f]`` accumulated in feature order, each
    product and sum rounded on its own; ``a`` ``[R, 1, F]`` against ``b``
    ``[1, N, F]`` gives ``[R, N]``."""
    acc = a[..., 0] * b[..., 0]
    for f in range(1, a.shape[-1]):
        acc = acc + a[..., f] * b[..., f]
    return acc


def knn(points: torch.Tensor, k: int, precision: str = "float32",
        block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """``(squared distances float32 [N, k], indices int64 [N, k])`` of
    every row's k nearest other rows, in column order within a row (the
    set, not the ranking)."""
    if precision not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {precision!r}")
    pts = points.to(torch.float32)
    n = pts.shape[0]
    sq = _feature_sum(pts, pts)
    cross_pts = round_to_tf32(pts) if precision == "tf32" else pts
    out_d = torch.empty((n, k), dtype=torch.float32, device=pts.device)
    out_i = torch.empty((n, k), dtype=torch.int64, device=pts.device)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        rows = torch.arange(r1 - r0, device=pts.device)
        if precision == "tf32":
            cross = cross_pts[r0:r1] @ cross_pts.T
        else:
            cross = _feature_sum(pts[r0:r1, None, :], pts[None, :, :])
        d2 = (sq[r0:r1, None] - 2.0 * cross) + sq[None, :]
        del cross
        d2.clamp_(min=0)
        d2[rows, rows + r0] = float("inf")
        out_d[r0:r1], out_i[r0:r1] = _smallest_k_by_index(d2, k)
        del d2
    return out_d, out_i


def _smallest_k_by_index(d2: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's k smallest entries, ties at the k-th value to the
    smaller column, returned in column order."""
    kth = torch.topk(d2, k, dim=1, largest=False, sorted=True).values[:, -1:]
    need = k - (d2 < kth).sum(dim=1)
    cand = (d2 <= kth).nonzero()  # row-major: columns ascending within a row
    row, col = cand[:, 0], cand[:, 1]
    tie = d2[row, col] == kth[row, 0]
    tie_rank = torch.cumsum(tie.to(torch.int64), 0)
    counts = torch.bincount(row, minlength=d2.shape[0])
    first = torch.cumsum(counts, 0) - counts
    ties_before_row = torch.cat([tie_rank.new_zeros(1), tie_rank])[first]
    keep = ~tie | (tie_rank - ties_before_row[row] <= need[row])
    row, col = row[keep], col[keep]
    return d2[row, col].view(-1, k), col.view(-1, k)


def lof_from_neighbours(d2: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """LOF per point from each point's neighbour set, in ``d2``'s dtype."""
    dist = torch.sqrt(d2)
    pos = dist > 0
    eps = 1e-3 * dist[pos].sum() / max(int(pos.sum()), 1)
    kdist = dist.max(dim=1).values
    reach = torch.maximum(torch.maximum(kdist[idx], dist), eps)
    lrd = k / torch.clamp(reach.sum(dim=1), min=1e-12)
    return lrd[idx].mean(dim=1) / torch.clamp(lrd, min=1e-12)


def lof(points: torch.Tensor, k: int, precision: str = "float32",
        block: int = 1024) -> torch.Tensor:
    """float64 LOF scores ``[N]``."""
    d2, idx = knn(points, k, precision=precision, block=block)
    return lof_from_neighbours(d2.to(torch.float64), idx, k)
