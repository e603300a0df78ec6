"""Graphalytics' throughput: (vertices + edges) of every completed job
over the seconds those jobs took, host clock, each job synchronised."""


def read(ctx):
    if not ctx.job_seconds or "vertices" not in ctx.facts:
        return None
    work = ctx.facts["vertices"] + ctx.facts["edges"]
    return work * len(ctx.job_seconds) / sum(ctx.job_seconds)
