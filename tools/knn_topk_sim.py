#!/usr/bin/env python3
"""Count a knn_topk row's top-k work on the host, as the kernel does it.

The kernel scans the points in index order, 32 a step, and keeps for each
row its k best keys and a buffer of 32 candidates: a point is a candidate
when its distance is below the row's threshold, the k-th best distance at
the last merge, and a buffer that would overflow is merged into the k best
first (csrc/knn_topk.cu). This replays that scheme on a seeded normal
cloud (float64 distances: the counts, not the bits, are the point) for the
first ``--rows`` rows and prints, per row, the candidates, the merges, the
steps that carry a candidate, and the buffer's mean fill at a merge, beside
k (1 + ln(N / k)), the candidates of a random order with an exact
threshold.

    python3 tools/knn_topk_sim.py --n 65536 --f 8 --k 256
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np


def simulate(pts: np.ndarray, k: int, rows: int, buf: int = 32) -> dict:
    n = len(pts)
    q = pts[:rows]
    d = ((q[:, None, :] - pts[None]) ** 2).sum(-1)
    d[np.arange(rows), np.arange(rows)] = np.inf  # the self pair never enters
    cand = merges = hit_steps = 0
    fills = []
    for r in range(rows):
        top, pending = np.full(k, np.inf), []
        thr = np.inf
        for s0 in range(0, n, 32):
            step = d[r, s0:s0 + 32]
            passed = step[step < thr]
            if not len(passed):
                continue
            hit_steps += 1
            if len(pending) + len(passed) > buf:
                merges += 1
                fills.append(len(pending))
                top = np.sort(np.concatenate([top, pending]))[:k]
                thr, pending = top[k - 1], []
                passed = step[step < thr]
            cand += len(passed)
            pending.extend(passed)
    return {"candidates": cand / rows, "merges": merges / rows, "hit_steps": hit_steps / rows,
            "mean_fill": float(np.mean(fills)) if fills else 0.0,
            "k_1_plus_ln_n_over_k": k * (1 + math.log(n / k))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--f", type=int, required=True)
    ap.add_argument("--k", type=int, required=True)
    ap.add_argument("--rows", type=int, default=16, help="rows replayed (default 16)")
    ap.add_argument("--seed", type=int, default=6)
    args = ap.parse_args(argv)
    pts = np.random.default_rng(args.seed).normal(size=(args.n, args.f))
    out = {"n": args.n, "f": args.f, "k": args.k, "rows": args.rows,
           **simulate(pts, args.k, args.rows)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
