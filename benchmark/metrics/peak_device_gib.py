"""The device's peak allocated bytes (``torch.cuda.max_memory_allocated``)
in GiB, from the moment the benchmark had made its inputs through the
program's set-up and the window; for a multi-card cell, the fullest
card's; nothing on the CPU."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
