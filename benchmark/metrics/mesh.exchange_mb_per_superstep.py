"""Megabytes (1e6 bytes) the mesh's label exchange moves between cards a
sharded LPA superstep: the program's counters
``graphmine_mesh_all_gather_bytes_total`` over
``graphmine_sharded_lpa_supersteps_total`` (set-up's warm-up job
included). A program without them, or with no such superstep, gives
nothing."""

from benchmark.program_obs import counter


def read(ctx):
    moved = counter("graphmine_mesh_all_gather_bytes_total")
    steps = counter("graphmine_sharded_lpa_supersteps_total")
    if moved is None or not steps:
        return None
    return moved / steps / 1e6
