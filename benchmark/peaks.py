"""Published peaks of one NVIDIA H100 SXM and the exact kNN's work.

The peaks are NVIDIA's data sheet's dense rates at the 700 W limit. The
kNN arithmetic is frozen here so that no later change to the program can
move the yardstick: every off-diagonal pair of ``n`` points of ``f``
features costs ``2f + 3`` float32 operations (``f`` products and ``f - 1``
sums for the cross term, the doubling, the two norm terms and the clamp),
the points are read once and ``[n, k]`` float32 distances and int32
indices are written once.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def knn_work(n: int, f: int, k: int) -> tuple[float, int]:
    """``(float32 operations, bytes moved)`` of the exact kNN of ``n``
    points of ``f`` features, self excluded."""
    return float(n) * (n - 1) * (2 * f + 3), n * f * 4 + n * k * (4 + 4)


def knn_bound_ms(n: int, f: int, k: int) -> tuple[float, str]:
    """Least milliseconds one H100 could take for :func:`knn_work` at its
    float32 peak (a fused multiply-add counted as two operations) and
    memory rate, and which of the two binds."""
    ops, moved = knn_work(n, f, k)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, moved / PEAK_HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
