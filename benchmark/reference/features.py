"""The eight structural columns of graphmine's LOF feature table, from
their definitions (the program's ``ops/features.py`` documents the same
columns), in float64 on the edges' device:

log1p(out-degree), log1p(in-degree), log1p(message degree), log1p(size
of the vertex's community), log1p(mean neighbour message degree),
log1p(distinct neighbour communities), the share of messages from the
vertex's own community, and the local clustering coefficient, here the
wedge-sampled estimate (the program's definition for graphs past the
exact wedge count): the closed share of ``samples`` uniform pairs of
distinct neighbours in the simple undirected graph. Messages run both
ways along every edge, duplicates counted. The columns are then
standardised to zero mean and unit population deviation.
"""

from __future__ import annotations

import torch


def vertex_features(src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
                    communities: torch.Tensor, samples: int, seed: int) -> torch.Tensor:
    """float32 ``[V, 8]`` feature table (not standardised)."""
    v = int(num_vertices)
    src, dst = src.to(torch.int64), dst.to(torch.int64)
    comm = communities.to(torch.int64)
    recv, send = torch.cat([dst, src]), torch.cat([src, dst])
    out_deg = torch.bincount(src, minlength=v)
    in_deg = torch.bincount(dst, minlength=v)
    msg_deg = torch.bincount(recv, minlength=v)
    comm_size = torch.bincount(comm, minlength=v)[comm]
    neigh_deg = torch.zeros(v, dtype=torch.float64, device=src.device).index_add_(
        0, recv, msg_deg[send].to(torch.float64))
    per_msg = torch.clamp(msg_deg, min=1).to(torch.float64)
    same = torch.bincount(recv[comm[send] == comm[recv]], minlength=v)
    distinct = torch.bincount(torch.unique(recv * v + comm[send]) // v, minlength=v)
    counts = torch.stack([out_deg, in_deg, msg_deg, comm_size], dim=1).to(torch.float64)
    cols = torch.cat([
        torch.log1p(counts),
        torch.log1p(neigh_deg / per_msg)[:, None],
        torch.log1p(distinct.to(torch.float64))[:, None],
        (same / per_msg)[:, None],
        sampled_clustering(src, dst, v, samples, seed)[:, None],
    ], dim=1)
    return cols.to(torch.float32)


def sampled_clustering(src: torch.Tensor, dst: torch.Tensor, num_vertices: int,
                       samples: int, seed: int) -> torch.Tensor:
    """float64 ``[V]``: the closed share of ``samples`` neighbour pairs a
    vertex (0 below two distinct neighbours)."""
    v = int(num_vertices)
    keep = src != dst
    lo = torch.minimum(src, dst)[keep]
    hi = torch.maximum(src, dst)[keep]
    edges = torch.unique(lo * v + hi)  # sorted: the membership table
    lo, hi = edges // v, edges % v
    nodes, nbrs = torch.cat([lo, hi]), torch.cat([hi, lo])
    nbrs = nbrs[torch.argsort(nodes, stable=True)]
    deg = torch.bincount(nodes, minlength=v)
    ptr = torch.cumsum(deg, 0) - deg
    gen = torch.Generator(device=src.device)
    gen.manual_seed(int(seed))
    d = deg[:, None].to(torch.float64)
    last = max(len(nbrs) - 1, 0)
    u1 = torch.rand((v, samples), generator=gen, device=src.device, dtype=torch.float64)
    u2 = torch.rand((v, samples), generator=gen, device=src.device, dtype=torch.float64)
    # a uniform first neighbour, and a uniform other one after it (mod d)
    first = torch.minimum((u1 * d).to(torch.int64), torch.clamp(deg - 1, min=0)[:, None])
    step = 1 + torch.minimum((u2 * (d - 1)).to(torch.int64), torch.clamp(deg - 2, min=0)[:, None])
    second = (first + step) % torch.clamp(deg, min=1)[:, None]
    a = nbrs[torch.clamp(ptr[:, None] + first, max=last)]
    b = nbrs[torch.clamp(ptr[:, None] + second, max=last)]
    key = torch.minimum(a, b) * v + torch.maximum(a, b)
    pos = torch.clamp(torch.searchsorted(edges, key), max=max(len(edges) - 1, 0))
    closed = (edges[pos] == key).to(torch.float64).mean(dim=1)
    return torch.where(deg >= 2, closed, 0.0)


def standardize(feats: torch.Tensor) -> torch.Tensor:
    """Zero-mean, unit population deviation columns (a constant column
    divides by 1e-6), float32."""
    x = feats.to(torch.float64)
    mu = x.mean(dim=0, keepdim=True)
    sd = x.std(dim=0, correction=0, keepdim=True)
    return ((x - mu) / torch.clamp(sd, min=1e-6)).to(torch.float32)
