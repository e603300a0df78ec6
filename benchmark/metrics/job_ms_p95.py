"""The 95th percentile of job milliseconds over every job in the window
(host clock, each job synchronised; linear between order statistics)."""

import numpy as np


def read(ctx):
    if not ctx.job_seconds:
        return None
    return 1e3 * float(np.percentile(np.asarray(ctx.job_seconds, dtype=np.float64), 95))
