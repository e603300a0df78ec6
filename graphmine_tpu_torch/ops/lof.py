"""Local Outlier Factor (LOF) scoring (PyTorch).

Counterpart of ``graphmine_tpu/ops/lof.py``. Standard LOF (Breunig et al.):

    k-distance(p)   = distance to p's k-th neighbour
    reach_k(p, o)   = max(k-distance(o), d(p, o))
    lrd(p)          = k / sum_o reach_k(p, o)
    LOF(p)          = mean_o lrd(o) / lrd(p)

with reach distances floored at 1e-3 x the mean positive kNN distance
(discrete graph features produce many identical rows, whose k-distance 0
would make lrd unbounded). The kNN is the exact one
(:func:`~graphmine_tpu_torch.ops.knn.knn`, the hand-written kernel on
CUDA) or the IVF index (:func:`~graphmine_tpu_torch.ops.ann.ivf_knn`),
by the JAX package's policy.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from graphmine_tpu_torch.ops.ann import ivf_knn
from graphmine_tpu_torch.ops.knn import knn

# The JAX package's exact -> IVF crossover for impl="auto" (measured there
# on a TPU, not on the card); GRAPHMINE_LOF_IVF_MIN_N overrides it, as in
# the JAX package.
LOF_IVF_MIN_POINTS = 1 << 17


# The JAX package's names: "xla" and "pallas" chose one of its exact
# kernels; here both, like "exact", mean the exact kNN (the hand-written
# kernel on CUDA, the plain version on the CPU).
LOF_IMPLS = ("auto", "ivf", "exact", "xla", "pallas")


def select_lof_impl(n: int, k: int, impl: str = "auto",
                    ivf_min_points: int | None = None) -> tuple[str, str]:
    """Resolve the kNN family (``"ivf"`` / ``"exact"``) for an ``[n, F]``
    cloud, with the reason: the JAX package's policy."""
    if impl not in LOF_IMPLS:
        raise ValueError(f"unknown LOF impl {impl!r}; use 'auto', 'ivf', 'exact', "
                         "'xla' or 'pallas'")
    if impl != "auto":
        family = "ivf" if impl == "ivf" else "exact"
        return family, f"impl={impl!r} requested explicitly"
    threshold = resolved_ivf_min_points(ivf_min_points)
    if n >= threshold:
        if 0 < k < n:
            return "ivf", f"n={n} >= crossover {threshold}"
        return "exact", f"k={k} not in (0, n={n}): the exact path owns the contract error"
    return "exact", f"n={n} < crossover {threshold}"


def resolved_ivf_min_points(ivf_min_points: int | None = None) -> int:
    """The active exact -> IVF crossover: the argument, else
    ``$GRAPHMINE_LOF_IVF_MIN_N``, else :data:`LOF_IVF_MIN_POINTS`."""
    if ivf_min_points is not None:
        return int(ivf_min_points)
    return int(os.environ.get("GRAPHMINE_LOF_IVF_MIN_N", LOF_IVF_MIN_POINTS))


def lof_scores(points: torch.Tensor, k: int = 20, row_tile: int = 1024,
               impl: str = "auto", sink=None,
               ivf_min_points: int | None = None) -> torch.Tensor:
    """LOF score per point, shape ``[N]`` (higher = more outlying).
    ``sink`` gets the ``impl_selected`` record and, from the IVF index, its
    ``ivf_index`` record or any ``ivf_fallback``."""
    n = int(points.shape[0])
    family, reason = select_lof_impl(n, k, impl=impl, ivf_min_points=ivf_min_points)
    if sink is not None:
        sink.emit("impl_selected", op="lof_knn", impl=family, requested=impl,
                  n=n, k=k, reason=reason,
                  thresholds={"lof_ivf_min_points": resolved_ivf_min_points(ivf_min_points)})
    if family == "ivf":
        d2, idx = ivf_knn(points, k=k, sink=sink)
    else:
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
