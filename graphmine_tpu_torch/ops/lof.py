"""Local Outlier Factor (LOF) scoring (PyTorch).

Counterpart of ``graphmine_tpu/ops/lof.py``. Standard LOF (Breunig et al.):

    k-distance(p)   = distance to p's k-th neighbour
    reach_k(p, o)   = max(k-distance(o), d(p, o))
    lrd(p)          = k / sum_o reach_k(p, o)
    LOF(p)          = mean_o lrd(o) / lrd(p)

with reach distances floored at 1e-3 x the mean positive kNN distance
(discrete graph features produce many identical rows, whose k-distance 0
would make lrd unbounded).
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.ops.knn import knn

# The JAX package's exact -> IVF crossover for impl="auto". The port has no
# IVF index yet, so "auto" at or above it raises instead of quietly
# switching to exact.
LOF_IVF_MIN_POINTS = 1 << 17

_IVF_MISSING = (
    "IVF kNN: ROADMAP.md queue 1 item 3 (port ops/ann.py); "
    "pass impl='exact' for the exact scorer"
)


def select_lof_impl(n: int, k: int, impl: str = "auto",
                    ivf_min_points: int | None = None) -> tuple[str, str]:
    """Resolve the kNN family (``"ivf"`` / ``"exact"``) for an ``[n, F]``
    cloud, with the reason: the JAX package's policy."""
    if impl not in ("auto", "ivf", "exact"):
        raise ValueError(f"unknown LOF impl {impl!r}; use 'auto', 'ivf' or 'exact'")
    if impl != "auto":
        return impl, f"impl={impl!r} requested explicitly"
    threshold = LOF_IVF_MIN_POINTS if ivf_min_points is None else int(ivf_min_points)
    if n >= threshold:
        if 0 < k < n:
            return "ivf", f"n={n} >= crossover {threshold}"
        return "exact", f"k={k} not in (0, n={n}): the exact path owns the contract error"
    return "exact", f"n={n} < crossover {threshold}"


def lof_scores(points: torch.Tensor, k: int = 20, row_tile: int = 1024,
               impl: str = "auto", sink=None,
               ivf_min_points: int | None = None) -> torch.Tensor:
    """LOF score per point, shape ``[N]`` (higher = more outlying)."""
    n = int(points.shape[0])
    family, reason = select_lof_impl(n, k, impl=impl, ivf_min_points=ivf_min_points)
    if sink is not None:
        sink.emit("impl_selected", op="lof_knn", impl=family, requested=impl,
                  n=n, k=k, reason=reason)
    if family == "ivf":
        raise NotImplementedError(_IVF_MISSING)
    d2, idx = knn(points, k=k, row_tile=row_tile)
    return lof_from_knn(d2, idx, k)


def lof_from_knn(d2: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """LOF scores from a kNN result (``[N, k]`` squared distances +
    neighbour indices)."""
    idx = idx.to(torch.int64)
    dists = torch.sqrt(d2)
    finite_pos = (dists > 0) & torch.isfinite(dists)
    eps = 1e-3 * torch.where(finite_pos, dists, 0.0).sum() / torch.clamp(
        finite_pos.sum(), min=1
    )
    kdist = dists[:, -1]
    reach = torch.maximum(torch.maximum(kdist[idx], dists), eps)
    lrd = k / torch.clamp(reach.sum(dim=1), min=1e-12)
    return lrd[idx].mean(dim=1) / torch.clamp(lrd, min=1e-12)


def auroc(scores, is_outlier) -> float:
    """Area under the ROC curve via the rank statistic (host-side)."""
    from scipy.stats import rankdata

    scores = np.asarray(scores, dtype=np.float64)
    y = np.asarray(is_outlier, dtype=bool)
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        raise ValueError("need both outliers and inliers for AUROC")
    ranks = rankdata(scores)  # average ranks handle ties
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))
