"""Device milliseconds of one WCC job: the union of device operations in
the traced window over the jobs in it."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops or not ctx.jobs_traced:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.jobs_traced
