"""Exact k nearest neighbours under squared Euclidean distance (PyTorch).

Counterpart of ``graphmine_tpu/ops/knn.py::knn``. On a CUDA tensor
:func:`knn` launches the hand-written kernel
(:mod:`graphmine_tpu_torch.kernels.knn_cuda`); on a CPU tensor it runs the
plain version :func:`_tiled_knn` below, which is also the kernel's
yardstick on the card. :func:`cross_knn` (queries against references,
the IVF index's probe and the streaming LOF window) is plain PyTorch on
every device, as the JAX package computes it outside any Pallas kernel.

The kernel and the plain version compute every distance with the same
float32 operations in the same order — ``|q|^2 = sum_f q_f*q_f`` and the cross term ``sum_f q_f*r_f``
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
    s = x[..., 0] * x[..., 0]
    for f in range(1, x.shape[-1]):
        s = s + x[..., f] * x[..., f]
    return s


def _cross(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``[..., len(q), len(r)]`` cross terms ``sum_f q_f*r_f``, accumulated
    feature by feature over batches of ``q [..., B, F]``, ``r [..., L, F]``.
    No matrix product: its bits would change with the caller's TF32
    setting and the library's summation order."""
    cross = q[..., 0].unsqueeze(-1) * r[..., 0].unsqueeze(-2)
    for f in range(1, q.shape[-1]):
        cross = cross + q[..., f].unsqueeze(-1) * r[..., f].unsqueeze(-2)
    return cross


def _sq_dists(q: torch.Tensor, q_sq: torch.Tensor, r: torch.Tensor,
              r_sq: torch.Tensor) -> torch.Tensor:
    """``[..., len(q), len(r)]`` squared distances, clamped at 0."""
    d2 = (q_sq.unsqueeze(-1) - 2.0 * _cross(q, r)) + r_sq.unsqueeze(-2)
    return torch.where(d2 > 0, d2, 0.0)


def smallest_k(d2: torch.Tensor, k: int):
    """The ``k`` smallest entries of each last-axis row of ``d2`` (float32,
    non-negative or +inf), ascending, ties to the smaller position:
    ``(values, positions int64)``. The selection key packs the distance's
    bits (monotone for non-negative floats) over the position, so every
    key is distinct and the result is that of a stable ascending sort,
    the rule of ``lax.top_k`` on ``-d2``."""
    cols = torch.arange(d2.shape[-1], dtype=torch.int64, device=d2.device)
    key = (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | cols
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    return (top >> 32).to(torch.int32).view(torch.float32), top & 0xFFFFFFFF


def _tiled_knn(points: torch.Tensor, k: int, row_tile: int = 1024):
    """The plain version: row tiles of the distance matrix, each reduced to
    its k smallest entries (:func:`smallest_k`)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    sq = _sq_norms(pts)
    out_d = torch.empty((n, k), dtype=torch.float32, device=pts.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=pts.device)
    for r0 in range(0, n, row_tile):
        r1 = min(r0 + row_tile, n)
        d2 = _sq_dists(pts[r0:r1], sq[r0:r1], pts, sq)
        rows = torch.arange(r1 - r0, device=pts.device)
        d2[rows, rows + r0] = float("inf")  # self excluded
        out_d[r0:r1], idx = smallest_k(d2, k)
        out_i[r0:r1] = idx.to(torch.int32)
    return out_d, out_i


def cross_knn(queries: torch.Tensor, refs: torch.Tensor, k: int,
              ref_mask: torch.Tensor | None = None, row_tile: int = 1024):
    """k nearest *reference* points of each query (no self-exclusion), the
    plain PyTorch counterpart of the JAX package's ``cross_knn`` on any
    device. ``ref_mask`` (bool ``[M]``) marks the valid reference slots:
    an invalid slot takes distance +inf, so it never beats a valid one
    (the streaming LOF window keeps a fixed shape while it fills). Returns
    ``(d2 float32 [N, k], idx int32 [N, k])``, ascending, ties to the
    smaller reference index. Distances are the feature-by-feature float32
    sums of the module note, whatever the TF32 setting."""
    m = refs.shape[0]
    if k > m:
        raise ValueError(f"k={k} must be <= number of references {m}")
    q_all = queries.to(torch.float32)
    refs = refs.to(torch.float32)
    n = q_all.shape[0]
    r_sq = _sq_norms(refs)
    invalid = None if ref_mask is None else ~ref_mask.to(device=refs.device, dtype=torch.bool)
    out_d = torch.empty((n, k), dtype=torch.float32, device=refs.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=refs.device)
    for r0 in range(0, n, row_tile):
        q = q_all[r0:r0 + row_tile]
        d2 = _sq_dists(q, _sq_norms(q), refs, r_sq)
        if invalid is not None:
            d2 = d2.masked_fill(invalid[None, :], float("inf"))
        out_d[r0:r0 + row_tile], idx = smallest_k(d2, k)
        out_i[r0:r0 + row_tile] = idx.to(torch.int32)
    return out_d, out_i
