"""The device's idle share of the traced window in %: 100 x (1 - the
seconds in which some device operation ran over the window's seconds),
both from the trace. The profiler's own host work slows jobs that the
host's launches pace, so in such cells this reads above the idle share
of an untraced run."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
