"""The ``knn_topk`` kernel's share of its roofline, in %: the least time
one H100 could take for the exact kNN's work (``peaks.knn_bound_ms``,
frozen: operations at 67 TFLOP/s, bytes at 3.35 TB/s) over the device
time of the kernel's launches (its prologue included) per job."""

from benchmark.metrics_common import knn_device_seconds
from benchmark.peaks import knn_bound_ms


def read(ctx):
    per_job = knn_device_seconds(ctx)
    if not per_job:
        return None
    bound_ms, _ = knn_bound_ms(ctx.facts["points"], ctx.facts["features"], ctx.facts["k"])
    return 100.0 * bound_ms / (1e3 * per_job)
