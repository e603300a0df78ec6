#!/usr/bin/env python3
"""Time a checkout's wide kNN instance at the chip smoke's shapes, on one card.

    python3 tools/knn_wide_times.py [--tree DIR] [--general] [--plain]

Imports ``graphmine_tpu_torch`` from ``DIR`` (default: this checkout),
builds its ``knn_topk`` kernel and, at each shape of this checkout's
``chip_smoke.WIDE_TIMED`` (and ``GENERAL_TIMED`` with ``--general``), holds
that tree's wide instance (``knn_cuda.wide_plan`` + ``run_plan``) against
the plain version on a seeded normal cloud (``chip_smoke.check_knn``:
distances bit-equal, indices equal) and times it (mean of 5 launches
after a warm-up; 3 for each variant). ``--plain`` adds the plain version's and the
library call's times (one run each) and the bound. Prints one JSON line,
``{"knn_wide_times": {"tree": ..., "card": ..., "rows": [...]}}``, and
writes it to ``--out`` where given. ``--constant`` adds each shape's time on
a constant cloud (every distance 0: each row inserts only its first k
candidates, so the time is the distance stream's with next to no top-k
work); ``--variants`` holds and times, at each shape, every plan of the
wide instance that fits (rows a warp, query layout, stages, key home;
this tree's ``knn_cuda.wide_smem_bytes`` and ``WIDE_*`` choices).

To hold two commits against each other on one card, unpack the other one
into a git-ignored directory of the checkout (``git archive <commit> | tar
-x -C build/parent``) and run this tool on both trees in turns (other,
this, this, other) in one command: each run is a process of its own, so
each imports and builds its own tree's kernel.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _variants(knn_cuda, n: int, f: int, k: int) -> list:
    """Every plan of the wide instance at (n, f, k) that fits in shared
    memory, as :func:`knn_cuda.wide_plan` would build it."""
    plan = knn_cuda.wide_plan(n, f, k)
    out = []
    for topk in ("shared", "global"):
        for queries, rows in knn_cuda.WIDE_ROWS_PER_WARP.items():
            for r in rows:
                for stages in (knn_cuda.WIDE_ONE_ROW_STAGES if r == 1 else knn_cuda.WIDE_STAGES):
                    smem = knn_cuda.wide_smem_bytes(f, stages, r, plan["kcap"], queries, topk)
                    if smem > knn_cuda.SMEM_LIMIT_BYTES:
                        continue
                    groups = -(-n // (16 * r))
                    blocks = min(groups, knn_cuda.WIDE_RESIDENT_BLOCKS) if topk == "global" \
                        else groups
                    out.append({**plan, "stages": stages, "rows_per_warp": r,
                                "rows_per_block": 16 * r, "queries": queries, "topk": topk,
                                "smem_bytes": smem, "blocks": blocks,
                                "scratch_keys": blocks * 16 * r * plan["kcap"]
                                if topk == "global" else 0})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT), help="checkout whose package is timed")
    ap.add_argument("--general", action="store_true", help="also the general rows' shapes")
    ap.add_argument("--plain", action="store_true", help="also the plain and library times")
    ap.add_argument("--constant", action="store_true", help="also on a constant cloud")
    ap.add_argument("--variants", action="store_true", help="also every plan that fits")
    ap.add_argument("--out", help="append the JSON line to this file")
    args = ap.parse_args(argv)
    smoke = _smoke()
    import torch

    if not torch.cuda.is_available():
        print("knn_wide_times: CUDA is not available", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    from graphmine_tpu_torch.kernels import knn_cuda
    from graphmine_tpu_torch.ops.knn import _tiled_knn

    require_tree = Path(knn_cuda.__file__).resolve()
    smoke.require(tree in require_tree.parents, f"imported {require_tree}, not {tree}'s")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    build_s = knn_cuda.build(verbose=True)
    shapes = list(smoke.WIDE_TIMED) + (list(smoke.GENERAL_TIMED) if args.general else [])
    rows = []
    for n, f, k in shapes:
        rng = np.random.default_rng([n, f, k])
        pts = torch.from_numpy(rng.normal(size=(n, f)).astype(np.float32)).cuda()
        plan = knn_cuda.wide_plan(n, f, k)
        d_k, i_k = knn_cuda.run_plan(pts, k, plan)
        d_p, i_p = _tiled_knn(pts, k)
        torch.cuda.synchronize()
        row = {"shape": {"n": n, "f": f, "k": k}, "plan": plan,
               **smoke.check_knn(pts, k, d_k, i_k, d_p, i_p)}
        del d_k, i_k
        row["ms"] = smoke.cuda_ms(lambda: knn_cuda.run_plan(pts, k, plan), reps=5)
        if args.variants:
            row["variants"] = []
            for var in _variants(knn_cuda, n, f, k):
                d_k, i_k = knn_cuda.run_plan(pts, k, var)
                torch.cuda.synchronize()
                smoke.check_knn(pts, k, d_k, i_k, d_p, i_p)
                del d_k, i_k
                ms = smoke.cuda_ms(lambda: knn_cuda.run_plan(pts, k, var), reps=3)
                row["variants"].append({key: var[key] for key in (
                    "rows_per_warp", "queries", "stages", "topk")} | {"ms": ms})
        del d_p, i_p
        if args.constant:
            ones = torch.ones_like(pts)
            row["constant_ms"] = smoke.cuda_ms(lambda: knn_cuda.run_plan(ones, k, plan), reps=5)
            del ones
        if args.plain:
            row["plain_ms"] = smoke.cuda_ms(lambda: _tiled_knn(pts, k), reps=1)
            row["library_ms"] = smoke.cuda_ms(lambda: smoke.library_knn(pts, k), reps=1)
            row["bound_ms"], row["bound_by"] = smoke.knn_bound_ms(n, f, k)
            row["unfused_floor_ms"] = smoke.knn_unfused_floor_ms(n, f, k)
        print(f"knn_wide_times {tree.name} {n}x{f} k={k}: {row['ms']:.3f} ms", file=sys.stderr,
              flush=True)
        rows.append(row)
        del pts
        torch.cuda.empty_cache()
    line = json.dumps({"knn_wide_times": {"tree": str(tree.relative_to(ROOT)) if ROOT in
                                          tree.parents else ".", "card": card,
                                          "build_seconds": build_s, "rows": rows}})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
