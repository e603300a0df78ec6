"""Share of the non-hub rows of the LPA supersteps on the card whose mode
the program's row-mode kernel took: its counters of kernel rows over
kernel and plain rows, set-up's warm-up job included. A program without
those counters, or with no such row, gives nothing."""

from benchmark.program_obs import counter


def read(ctx):
    kernel = counter("graphmine_lpa_mode_kernel_rows_total")
    plain = counter("graphmine_lpa_mode_plain_rows_total")
    if kernel is None or plain is None or not kernel + plain:
        return None
    return kernel / (kernel + plain)
