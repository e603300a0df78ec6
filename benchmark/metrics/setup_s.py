"""Set-up seconds on the host clock: from the process's start through
making the inputs, handing them to the program and one warm-up job
(plans, the kernel's library, the allocator), synchronised."""


def read(ctx):
    return ctx.setup_s
