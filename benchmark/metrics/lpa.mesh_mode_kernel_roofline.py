"""The row-mode kernel's share of its floor in the sharded LPA superstep,
in %: the sum over the cards of each card's floor
(``mesh_floor.card_floor_seconds``, bytes at 3.35 TB/s, from the job's
facts) over the sum of the cards' ``mode_{narrow,mid,wide}_kernel``
device seconds a superstep in the traced window."""

from benchmark.mesh_floor import card_floor_seconds

MODE_KERNELS = r"\bmode_(?:narrow|mid|wide)_kernel\b"


def read(ctx):
    steps = ctx.facts.get("supersteps_per_job")
    floor = card_floor_seconds(ctx.facts)
    if ctx.trace is None or not ctx.jobs_traced or not steps or not floor:
        return None
    kernel = sum(ctx.trace.device_seconds(MODE_KERNELS, card=c) for c in ctx.trace.cards)
    if kernel <= 0:
        return None
    return 100.0 * sum(floor) / (kernel / (ctx.jobs_traced * steps))
