"""Clustering-accuracy metrics: adjusted Rand index and NMI (host NumPy).

Counterpart of ``graphmine_tpu/ops/cluster_metrics.py``, a copy of its
host code: the standard external measures for comparing a detected
partition with ground truth (SBM blocks from
:func:`graphmine_tpu_torch.datasets.sbm`) or two algorithms (LPA against
Louvain), invariant to label permutation. Labels may be arrays or tensors
on any device.
"""

from __future__ import annotations

import numpy as np


def _host(labels) -> np.ndarray:
    """Labels (array, list or tensor on any device) as a host array."""
    if hasattr(labels, "detach"):
        return labels.detach().cpu().numpy()
    return np.asarray(labels)


def _contingency(a: np.ndarray, b: np.ndarray):
    """Sparse contingency: ``(cell_counts, cell_rows, cell_cols, row_sums,
    col_sums)`` over compacted label ids — O(nnz) memory, so comparing two
    fine-grained partitions (each with ~V communities) never materializes
    a ka×kb table."""
    a = _host(a).ravel()
    b = _host(b).ravel()
    if a.shape != b.shape:
        raise ValueError(f"label arrays differ in length: {a.shape} vs {b.shape}")
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    ka, kb = int(ai.max(initial=-1)) + 1, int(bi.max(initial=-1)) + 1
    codes = ai.astype(np.int64) * kb + bi
    uniq, counts = np.unique(codes, return_counts=True)
    row_sums = np.bincount(ai, minlength=ka)
    col_sums = np.bincount(bi, minlength=kb)
    return counts, uniq // kb, uniq % kb, row_sums, col_sums


def adjusted_rand_index(labels_a, labels_b) -> float:
    """Adjusted Rand index in [-0.5, 1]; 1 = identical partitions, ~0 =
    chance agreement. Permutation-invariant (matches
    ``sklearn.metrics.adjusted_rand_score``)."""
    counts, _, _, row_sums, col_sums = _contingency(labels_a, labels_b)
    n = row_sums.sum()
    if n == 0:
        return 1.0

    def comb2(x):
        return x * (x - 1) / 2.0

    sum_ij = comb2(counts.astype(np.float64)).sum()
    sum_a = comb2(row_sums.astype(np.float64)).sum()
    sum_b = comb2(col_sums.astype(np.float64)).sum()
    total = comb2(float(n))
    expected = sum_a * sum_b / total if total else 0.0
    max_index = 0.5 * (sum_a + sum_b)
    if max_index == expected:  # both partitions trivial (all-one-cluster etc.)
        return 1.0
    return float((sum_ij - expected) / (max_index - expected))


def normalized_mutual_info(labels_a, labels_b,
                           average: str = "arithmetic") -> float:
    """NMI in [0, 1]; 1 = identical partitions. ``average``:
    arithmetic (sklearn default) | geometric | min | max."""
    counts, rows, cols, row_sums, col_sums = _contingency(labels_a, labels_b)
    n = float(row_sums.sum())
    if n == 0:
        return 1.0
    pa = row_sums / n
    pb = col_sums / n
    pab = counts / n  # nonzero cells only
    mi = float(np.sum(pab * np.log(pab / (pa[rows] * pb[cols]))))
    ha = -float(np.sum(pa[pa > 0] * np.log(pa[pa > 0])))
    hb = -float(np.sum(pb[pb > 0] * np.log(pb[pb > 0])))
    if ha == 0.0 and hb == 0.0:  # both single-cluster: identical
        return 1.0
    if average == "arithmetic":
        denom = (ha + hb) / 2.0
    elif average == "geometric":
        denom = np.sqrt(ha * hb)
    elif average == "min":
        denom = min(ha, hb)
    elif average == "max":
        denom = max(ha, hb)
    else:
        raise ValueError(f"unknown average {average!r}")
    if denom == 0.0:
        return 0.0
    return float(np.clip(mi / denom, 0.0, 1.0))
