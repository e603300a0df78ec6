"""Device milliseconds of one sharded LPA superstep, paced by the slowest
card: that card's busy seconds in the traced window (the union of its
device operations) over the supersteps the traced jobs ran."""


def read(ctx):
    steps = ctx.facts.get("supersteps_per_job")
    if ctx.trace is None or not ctx.trace.ops or not ctx.jobs_traced or not steps:
        return None
    return 1e3 * max(ctx.trace.busy_s_by_card().values()) / (ctx.jobs_traced * steps)
