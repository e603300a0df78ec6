"""Host milliseconds of one sharded LPA superstep inside the program: the
``lpa.sharded_superstep`` op span's ``perf_counter`` seconds (the enqueue
on every card, the exchange included; not synchronised) over its count,
in the traced window."""

from benchmark.program_obs import per_call_ms


def read(ctx):
    return per_call_ms("lpa.sharded_superstep", "host_s")
