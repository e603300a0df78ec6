"""Graph500 Kronecker generator, made the way LDBC Graphalytics built its
``graph500-*`` datasets, on the device from the seed.

The Graph500 specification's generator (``kronecker_generator.m``):
``edge_factor * 2**scale`` edges, each of ``scale`` bits chosen by two
uniform draws from the initiator ``A, B, C`` (``D = 1 - A - B - C``),
then the vertex ids permuted. Graphalytics then made the graph simple and
undirected: self-loops and duplicate undirected edges dropped, vertices
left with no edge dropped, and the remaining ids kept in their order. The
result is one undirected edge ``(a, b)``, ``a < b``, per row, sorted.
"""

from __future__ import annotations

import torch


def generate(params: dict, seed: int, device: torch.device) -> dict:
    """``{"src", "dst"}`` int32 ``[E]`` on ``device`` and ``num_vertices``."""
    scale = int(params["scale"])
    a, b, c = float(params["a"]), float(params["b"]), float(params["c"])
    n = 1 << scale
    m = int(params["edge_factor"]) * n
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    ab = a + b
    c_norm, a_norm = c / (1.0 - ab), a / ab
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        i_bit = torch.rand(m, generator=gen, device=device) > ab
        thr = torch.where(i_bit, c_norm, a_norm)
        j_bit = torch.rand(m, generator=gen, device=device) > thr
        i |= i_bit.to(torch.int64) << bit
        j |= j_bit.to(torch.int64) << bit
    del i_bit, j_bit, thr
    perm = torch.randperm(n, generator=gen, device=device)
    i, j = perm[i], perm[j]
    del perm
    keep = i != j
    lo = torch.minimum(i, j)[keep]
    hi = torch.maximum(i, j)[keep]
    del i, j, keep
    key = torch.unique(lo * n + hi)  # sorted: one row per undirected edge
    del lo, hi
    lo, hi = key // n, key % n
    del key
    present = torch.zeros(n, dtype=torch.bool, device=device)
    present[lo] = True
    present[hi] = True
    new_id = torch.cumsum(present, 0) - 1
    v = int(present.sum())
    return {"src": new_id[lo].to(torch.int32), "dst": new_id[hi].to(torch.int32),
            "num_vertices": v}
