"""Device milliseconds of one LPA superstep: the union of device
operations in the traced window over the supersteps its jobs ran."""


def read(ctx):
    steps = ctx.facts.get("supersteps_per_job")
    if ctx.trace is None or not ctx.trace.ops or not ctx.jobs_traced or not steps:
        return None
    return 1e3 * ctx.trace.busy_s / (ctx.jobs_traced * steps)
