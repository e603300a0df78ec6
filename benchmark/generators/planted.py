"""Planted communities over a sparse hub skeleton, with planted anomalies:
graphmine's own e2e tier (``planted_anomaly_graph``), drawn on the device
from the seed.

The recipe of the JAX package's ``datasets.planted_anomaly_graph``, kept
here as the benchmark's own copy in PyTorch (a ``torch.Generator`` on the
device, so the draws differ from NumPy's): vertices land in
``n_communities`` blocks of Zipf-like sizes; each vertex draws
``n_friends`` partners in its block, Pareto-skewed toward the block's
first rows; every edge anchors a uniform vertex and takes a uniform
partner from its pool (the edge budget lands as duplicate multiplicity,
which is kept); a ``p_noise`` share of partners is redrawn uniformly over
the graph; then ``num_anomalies`` vertices are wired to
``edges_per_anomaly`` uniform endpoints each. Edges are directed, with
duplicates and self-loops kept, as the reference keeps them.
"""

from __future__ import annotations

import torch


def generate(params: dict, seed: int, device: torch.device) -> dict:
    """``{"src", "dst"}`` int32 ``[E]`` on ``device`` and ``num_vertices``."""
    v, e = int(params["num_vertices"]), int(params["num_edges"])
    n_comm = int(params.get("n_communities") or max(8, v >> 9))
    n_friends = int(params["n_friends"])
    num_anomalies = int(params.get("num_anomalies") or max(32, v // 2000))
    per_anomaly = int(params["edges_per_anomaly"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))

    def uniform(*shape, dtype=torch.float32):
        return torch.rand(shape, generator=gen, device=device, dtype=dtype)

    def integers(high, *shape):
        return torch.randint(0, high, shape, generator=gen, device=device)

    w = (1.0 + torch.arange(n_comm, dtype=torch.float64, device=device)) ** -float(
        params["size_skew"])
    comm = torch.multinomial(w / w.sum(), v, replacement=True, generator=gen)
    order = torch.argsort(comm, stable=True)
    sizes = torch.bincount(comm, minlength=n_comm)
    starts = torch.cumsum(sizes, 0) - sizes
    sz = sizes[comm].to(torch.float64)
    # NumPy's pareto(a): Lomax, (1 - U) ** (-1 / a) - 1
    raw = (1.0 - uniform(v, n_friends, dtype=torch.float64)) ** (-1.0 / float(params["hub_skew"])) - 1.0
    loc = torch.minimum(raw * sz[:, None] / float(params["hub_scale"]), (sz - 1.0)[:, None])
    friends = order[starts[comm][:, None] + loc.to(torch.int64)]
    del raw, loc, sz
    anchors = integers(v, e)
    partners = friends[anchors, integers(n_friends, e)]
    noise = uniform(e) < float(params["p_noise"])
    partners = torch.where(noise, integers(v, e), partners)
    del noise, friends
    anomalies = torch.randperm(v, generator=gen, device=device)[:num_anomalies]
    a_src = anomalies.repeat_interleave(per_anomaly)
    a_dst = integers(v, num_anomalies * per_anomaly)
    src = torch.cat([anchors, a_src]).to(torch.int32)
    dst = torch.cat([partners, a_dst]).to(torch.int32)
    return {"src": src, "dst": dst, "num_vertices": v}
