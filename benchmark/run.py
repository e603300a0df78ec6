#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card and print its line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The inputs are made on the card from
``--seed``; the cell's jobs run back to back for ``--seconds`` (with
``--trace 1`` a short window under ``torch.profiler`` instead, and the
per-layer metrics in place of the end-to-end ones); what the window
produced is checked against the plain reference once it has closed. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit); the checks are also the last lines of standard error.

A cell with ``chips: n`` runs in this one process on ``cuda:0`` to
``cuda:n-1``. Exits 2 and prints no result without CUDA, with fewer
cards than the cell asks for, or when JAX or the JAX package was loaded.
Build and kernel caches stay inside the checkout (``build/``);
``GRAPHMINE_*`` variables are cleared so the program runs as the cell
states.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _environment() -> None:
    for key in [k for k in os.environ if k.startswith("GRAPHMINE_")]:
        del os.environ[key]
    cache = ROOT / "build" / "benchmark_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    args = parse_args(argv)
    _environment()
    from benchmark import harness

    try:
        cell = harness.resolve_cell(harness.load_spec(), args.workload)
        result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                  harness.cell_cards(cell), t_start=T_START)
    except harness.BenchError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    found = harness.banned_modules()
    if found:
        print(f"bench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
