"""What several metric readers share."""

from __future__ import annotations

# knn_topk.cu's entry points: the packing prologues and the fast, general
# and wide instances
KNN_KERNELS = r"\b(pack_\w*kernel|knn_\w*kernel)\b"


def knn_device_seconds(ctx) -> float | None:
    """Device seconds of the kNN kernels per traced job, or ``None``."""
    if ctx.trace is None or not ctx.jobs_traced or "points" not in ctx.facts:
        return None
    total = ctx.trace.device_seconds(KNN_KERNELS)
    return total / ctx.jobs_traced if total > 0 else None
