"""Device milliseconds per LOF job outside the ``knn_topk`` kernel: the
gathers, reductions and sums of ``lof_from_knn``."""

from benchmark.metrics_common import knn_device_seconds


def read(ctx):
    per_job = knn_device_seconds(ctx)
    if not per_job:
        return None
    return 1e3 * (ctx.trace.device_seconds() / ctx.jobs_traced - per_job)
