#!/usr/bin/env python3
"""The readings the limits of ``limits/<cell>.json`` are set from.

    python3 benchmark/controls.py --workload <cell> --seeds <n> [<n> ...]

For each seed, in one process that owns the cell's cards (``cuda:0`` to
``cuda:n-1``, as ``run.py`` gives them): the cell's inputs, one job
through the program's entry as the window runs it, the plain reference,
and the control (the reference with one stated guarantee or precision
broken: ``Job.control``). Prints one JSON line a seed with each compared
number for the program and for the control, and last a summary: the
largest program reading and the smallest control reading of each number
beside the cell's limit. The benchmark's own runs do not run this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell = harness.resolve_cell(harness.load_spec(), args.workload)
    try:
        cards = harness.cell_cards(cell)
    except harness.BenchError as e:
        print(f"controls: {e}", file=sys.stderr)
        return 2
    sync = harness.synchronizer(cards)
    worst, least = {}, {}
    for seed in args.seeds:
        row = {"seed": seed}
        t0 = time.perf_counter()
        job = harness.make_job(cell, seed, cards)
        job.setup({})
        out = job.run()
        sync()
        row["facts"] = job.facts
        row["program_s"] = time.perf_counter() - t0
        job.release()
        t0 = time.perf_counter()
        ref = job.reference()
        row["program"] = job.compare(out, ref)
        del out
        ctl = job.control()
        row["control"] = job.compare(ctl, ref)
        row["reference_and_control_s"] = time.perf_counter() - t0
        del ctl, ref, job
        gc.collect()
        harness.empty_caches(cards)
        for name, value in row["program"].items():
            worst[name] = max(worst.get(name, value), value)
        for name, value in row["control"].items():
            least[name] = min(least.get(name, value), value)
        print(json.dumps(row), flush=True)
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "program_max": worst, "control_min": least,
                      "limits": cell.limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
