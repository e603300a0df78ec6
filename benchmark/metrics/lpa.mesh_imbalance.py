"""Load balance of the cards in the traced window: the slowest card's
busy seconds over the mean of the cards' busy seconds (1 when even);
nothing on one card."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    busy = list(ctx.trace.busy_s_by_card().values())
    mean = sum(busy) / len(busy)
    if len(busy) < 2 or mean <= 0:
        return None
    return max(busy) / mean
