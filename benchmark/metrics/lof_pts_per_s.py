"""Points scored per second: the points of every completed job over the
seconds those jobs took, host clock, each job synchronised."""


def read(ctx):
    if not ctx.job_seconds or "points" not in ctx.facts:
        return None
    return ctx.facts["points"] * len(ctx.job_seconds) / sum(ctx.job_seconds)
