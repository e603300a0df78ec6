"""Exact k nearest neighbours under squared Euclidean distance (PyTorch).

Counterpart of ``graphmine_tpu/ops/knn.py::knn``. On a CUDA tensor
:func:`knn` launches the hand-written kernel
(:mod:`graphmine_tpu_torch.kernels.knn_cuda`); on a CPU tensor it runs the
plain version :func:`_tiled_knn` below, which is also the kernel's
yardstick on the card.

Both compute every distance with the same float32 operations in the same
order — ``|q|^2 = sum_f q_f*q_f`` and the cross term ``sum_f q_f*r_f``
accumulated feature by feature, each product and sum rounded on its own
(no fused multiply-add), then ``max((|q|^2 - 2*cross) + |r|^2, 0)`` — so
their distances are bit-equal. Both return each row's k smallest in
ascending order with ties to the smaller column index (the JAX package's
rule), so their indices are equal even where distances tie.
"""

from __future__ import annotations

import torch


def knn(points: torch.Tensor, k: int, row_tile: int = 1024):
    """k nearest neighbours of every row of ``points`` ``[N, F]`` (float32),
    self excluded. Returns ``(d2 float32 [N, k], idx int32 [N, k])``,
    ascending by distance."""
    n = points.shape[0]
    if not 0 < k < n:
        raise ValueError(f"k={k} must be in (0, number of points {n})")
    if points.is_cuda:
        from graphmine_tpu_torch.kernels.knn_cuda import knn_topk

        return knn_topk(points, k)
    if points.device.type != "cpu":
        raise ValueError(f"knn runs on CUDA or CPU tensors, not {points.device}")
    return _tiled_knn(points, k, row_tile)


def _sq_norms(x: torch.Tensor) -> torch.Tensor:
    """Row norms accumulated feature by feature (see the module note)."""
    s = x[:, 0] * x[:, 0]
    for f in range(1, x.shape[1]):
        s = s + x[:, f] * x[:, f]
    return s


def _sq_dists(q: torch.Tensor, q_sq: torch.Tensor, r: torch.Tensor,
              r_sq: torch.Tensor) -> torch.Tensor:
    """``[len(q), len(r)]`` squared distances, clamped at 0."""
    cross = q[:, 0, None] * r[None, :, 0]
    for f in range(1, q.shape[1]):
        cross = cross + q[:, f, None] * r[None, :, f]
    d2 = (q_sq[:, None] - 2.0 * cross) + r_sq[None, :]
    return torch.where(d2 > 0, d2, 0.0)


def _tiled_knn(points: torch.Tensor, k: int, row_tile: int = 1024):
    """The plain version: row tiles of the distance matrix, each reduced to
    its k smallest entries. The selection key packs the distance's bits
    (monotone for non-negative floats) over the column index, so every key
    is distinct and the k smallest keys are exactly the first k of a
    stable ascending sort of the distances."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    sq = _sq_norms(pts)
    cols = torch.arange(n, dtype=torch.int64, device=pts.device)
    out_d = torch.empty((n, k), dtype=torch.float32, device=pts.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=pts.device)
    for r0 in range(0, n, row_tile):
        r1 = min(r0 + row_tile, n)
        d2 = _sq_dists(pts[r0:r1], sq[r0:r1], pts, sq)
        rows = torch.arange(r1 - r0, device=pts.device)
        d2[rows, rows + r0] = float("inf")  # self excluded
        key = (d2.view(torch.int32).to(torch.int64) << 32) | cols
        top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
        idx = top & 0xFFFFFFFF
        out_i[r0:r1] = idx.to(torch.int32)
        out_d[r0:r1] = torch.gather(d2, 1, idx)
    return out_d, out_i
