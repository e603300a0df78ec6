"""Seconds of the program's ``build_graph`` in set-up (host arrays to the
device-resident message CSR), host clock, synchronised at both ends."""


def read(ctx):
    return ctx.spans.get("build_graph_s")
