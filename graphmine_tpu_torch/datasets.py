"""Synthetic graph generators (host-side NumPy) and the benchmark ladder.

Counterpart of ``graphmine_tpu/datasets.py``: ``rmat``, ``sbm``,
``planted_anomaly_graph``, ``inject_structural_anomalies`` and the SNAP
ladder (``LadderRung``, ``LADDER``, ``snap_path``, ``load``), copied so
that the port never imports the JAX package. They draw from
``np.random.default_rng(seed)`` in the same order as the JAX package's
copies, so both packages get bit-equal graphs from one seed. A rung loads
its real SNAP edge list when the file is on disk and its R-MAT stand-in
otherwise, so nothing is downloaded.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

__all__ = [
    "rmat", "sbm", "LadderRung", "LADDER", "load", "snap_path",
    "inject_structural_anomalies", "planted_anomaly_graph",
]


def rmat(
    scale: int,
    edge_factor: float = 16.0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    seed: int = 0,
    dedup: bool = False,
    permute: bool = True,
):
    """R-MAT edge list: ``2**scale`` vertices, ``edge_factor * 2**scale`` edges.

    Returns ``(src, dst)`` int32 arrays. ``permute`` relabels vertices with
    a random permutation (breaks the correlation between id and degree that
    raw R-MAT has). ``dedup`` drops duplicate directed pairs (Graph500
    keeps them; the reference also keeps duplicates — ``Graphframes.py:70-74``
    — so the default matches both).
    """
    if not 0 < a + b + c <= 1.0:
        raise ValueError("quadrant probabilities must satisfy 0 < a+b+c <= 1")
    v = 1 << scale
    e = int(edge_factor * v)
    rng = np.random.default_rng(seed)
    src = np.zeros(e, dtype=np.int64)
    dst = np.zeros(e, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(e)
        # quadrant draw: [0,a) -> (0,0), [a,a+b) -> (0,1), [a+b,a+b+c) -> (1,0)
        src_bit = r >= a + b
        dst_bit = (r >= a) & (r < a + b) | (r >= a + b + c)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    if permute:
        perm = rng.permutation(v)
        src, dst = perm[src], perm[dst]
    if dedup:
        pairs = np.unique(src * v + dst)
        src, dst = pairs // v, pairs % v
    return src.astype(np.int32), dst.astype(np.int32)


def sbm(
    block_sizes,
    p_in: float,
    p_out: float,
    seed: int = 0,
    directed: bool = False,
):
    """Stochastic block model with planted communities — the ground-truth
    generator for community-detection *accuracy* evaluation (the axis the
    reference's ``Overview:9`` names but never measures).

    Returns ``(src, dst, blocks)``: int32 edge endpoints (no self-loops,
    deduplicated) and the int32 planted block id per vertex. Sampling is
    sparse — per block pair, the edge count is drawn ``Binomial(n_pairs,
    p)`` and that many endpoint pairs are sampled uniformly — so cost is
    O(edges), not O(V²).
    """
    sizes = np.asarray(block_sizes, dtype=np.int64)
    if (sizes <= 0).any():
        raise ValueError("block sizes must be positive")
    for name, p in (("p_in", p_in), ("p_out", p_out)):
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"{name} must be in [0, 1]")
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    blocks = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for i in range(len(sizes)):
        j_range = range(len(sizes)) if directed else range(i, len(sizes))
        for j in j_range:
            p = p_in if i == j else p_out
            if p <= 0.0:
                continue
            if i == j:
                # diagonal blocks: count *distinct* vertex pairs, else the
                # intra density doubles relative to p (both orientations of
                # a draw land on the same unordered edge)
                ni = int(sizes[i])
                n_pairs = ni * (ni - 1) if directed else ni * (ni - 1) // 2
            else:
                n_pairs = int(sizes[i] * sizes[j])
            m = rng.binomial(n_pairs, p)
            if m == 0:
                continue
            a = rng.integers(0, sizes[i], m) + offsets[i]
            b = rng.integers(0, sizes[j], m) + offsets[j]
            keep = a != b
            a, b = a[keep], b[keep]
            if i == j and not directed:
                a, b = np.minimum(a, b), np.maximum(a, b)  # canonical orientation
            srcs.append(a)
            dsts.append(b)
    if not srcs:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32), blocks)
    src = np.concatenate(srcs).astype(np.int64)
    dst = np.concatenate(dsts).astype(np.int64)
    v = int(offsets[-1])
    pairs = np.unique(src * v + dst)
    return (pairs // v).astype(np.int32), (pairs % v).astype(np.int32), blocks


@dataclass(frozen=True)
class LadderRung:
    """One rung of the BASELINE.json benchmark ladder."""

    name: str
    snap_file: str  # the SNAP edge list's file name, when downloaded
    scale: int  # R-MAT scale of the stand-in
    edge_factor: float
    description: str


# The SNAP graphs' sizes, rounded to powers of two (BASELINE.json "configs").
LADDER: dict[str, LadderRung] = {
    r.name: r
    for r in [
        LadderRung("ego-facebook", "facebook_combined.txt", 12, 21.5,
                   "SNAP ego-Facebook: 4K nodes / 88K edges — LPA + CC"),
        LadderRung("com-amazon", "com-amazon.ungraph.txt", 18, 3.5,
                   "SNAP com-Amazon: 335K nodes / 926K edges — Louvain vs LPA"),
        LadderRung("com-livejournal", "com-lj.ungraph.txt", 22, 8.3,
                   "SNAP com-LiveJournal: 4M nodes / 34M edges — sharded CSR over the mesh"),
        LadderRung("twitter-2010", "twitter-2010.txt", 25, 42.0,
                   "Twitter-2010: 41M nodes / 1.4B edges — streaming LOF at slice scale"),
    ]
}


def snap_path(name: str, data_dir: str = "data") -> str | None:
    """Path of the rung's real SNAP edge list, or ``None`` when absent."""
    rung = LADDER.get(name)
    if rung is None:
        raise KeyError(f"unknown ladder rung {name!r}; have {sorted(LADDER)}")
    path = os.path.join(data_dir, rung.snap_file)
    return path if os.path.exists(path) else None


def load(name: str, data_dir: str = "data", seed: int = 0, max_scale: int | None = None):
    """A ladder rung as an :class:`~graphmine_tpu_torch.io.edges.EdgeTable`:
    the real SNAP file when present (always in full), else the R-MAT
    stand-in of ``seed``, its scale capped at ``max_scale``."""
    rung = LADDER.get(name)
    if rung is None:
        raise KeyError(f"unknown ladder rung {name!r}; have {sorted(LADDER)}")
    path = snap_path(name, data_dir)
    if path is not None:
        from graphmine_tpu_torch.io.edges import load_edge_list

        return load_edge_list(path)
    from graphmine_tpu_torch.io.edges import from_arrays

    scale = rung.scale if max_scale is None else min(rung.scale, max_scale)
    src, dst = rmat(scale, rung.edge_factor, seed=seed)
    return from_arrays(src, dst)


def planted_anomaly_graph(
    num_vertices: int,
    num_edges: int,
    n_communities: int | None = None,
    size_skew: float = 0.7,
    n_friends: int = 4,
    hub_skew: float = 1.3,
    hub_scale: float = 20.0,
    p_noise: float = 0.03,
    num_anomalies: int | None = None,
    edges_per_anomaly: int = 60,
    seed: int = 0,
):
    """Planted communities over a sparse hub skeleton + injected
    anomalies — the e2e bench dataset (VERDICT r5 weak-item 1: the old
    pure power-law draw collapsed under LPA to 3 giant communities, so
    the timed census / outlier chapters detected NOTHING and the
    flagship number measured a vacuous pipeline).

    Construction (fully vectorized, O(V + E) host work):

    - vertices land in ``n_communities`` planted blocks with Zipf-ish
      sizes (``(1+i)^-size_skew``, normalized);
    - each vertex draws a fixed pool of ``n_friends`` partners within
      its block, pareto-skewed toward the block's first rows (consistent
      per-block hubs, the reference data's CommonCrawl pattern); every
      edge anchors a uniform vertex and picks uniformly from the
      anchor's pool. The edge *budget* lands as duplicate multiplicity
      (reference parity — duplicates kept, ``Graphframes.py:70-74``)
      while the DISTINCT-pair skeleton stays sparse. That sparsity is
      load-bearing for the outlier chapter: 5-superstep LPA genuinely
      does not converge on a large-diameter sparse skeleton, so the
      top-level census finds a long-tailed thousands-of-communities
      partition (like the reference data: 4.6K vertices → ~650
      communities) and the recursive masked re-run fragments each
      sizable parent into many sub-communities — populating the
      bottom-decile rule (``Graphframes.py:135-136``) the dense
      all-pairs draw starved (a dense block re-converges identically in
      both passes; measured flagged=0 across every dense knob setting);
    - a ``p_noise`` fraction of partners is re-drawn uniformly across
      the graph: cross-community weather, non-trivial boundaries;
    - ``inject_structural_anomalies`` wires ``num_anomalies`` vertices
      (default ``max(32, V/2000)``) to uniform endpoints — the held-out
      ground truth the LOF chapter must detect.

    Returns ``(src, dst, is_anomaly, communities)``: int32 edge arrays
    (directed, duplicates kept), the bool anomaly mask, and the planted
    block id per vertex.
    """
    rng = np.random.default_rng(seed)
    v, e = num_vertices, num_edges
    if n_communities is None:
        n_communities = max(8, v >> 9)
    w = (1.0 + np.arange(n_communities)) ** -size_skew
    w /= w.sum()
    comm = rng.choice(n_communities, size=v, p=w).astype(np.int32)
    order = np.argsort(comm, kind="stable")
    sizes = np.bincount(comm, minlength=n_communities).astype(np.int64)
    starts = np.zeros(n_communities, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])

    sz = sizes[comm]  # >= 1: the vertex itself lives in its block
    raw = rng.pareto(hub_skew, size=(v, n_friends))
    loc = np.minimum(
        (raw * sz[:, None] / hub_scale).astype(np.int64), (sz - 1)[:, None]
    )
    friends = order[starts[comm][:, None] + loc]  # [V, n_friends]

    anchors = rng.integers(0, v, e)
    partners = friends[anchors, rng.integers(0, n_friends, e)]
    noise = rng.random(e) < p_noise
    partners[noise] = rng.integers(0, v, int(noise.sum()))

    src = anchors.astype(np.int32)
    dst = partners.astype(np.int32)
    if num_anomalies is None:
        num_anomalies = max(32, v // 2000)
    src, dst, is_anomaly = inject_structural_anomalies(
        src, dst, v, num_anomalies=num_anomalies,
        edges_per_anomaly=edges_per_anomaly, seed=seed + 1,
    )
    return src, dst, is_anomaly, comm


def inject_structural_anomalies(
    src: np.ndarray,
    dst: np.ndarray,
    num_vertices: int,
    num_anomalies: int,
    edges_per_anomaly: int = 20,
    seed: int = 0,
):
    """Wire ``num_anomalies`` random existing vertices to uniform-random
    endpoints, making them community-bridging hubs — the held-out outliers
    of the LOF AUROC harness (BASELINE.json metric). Uniform cross-graph
    edges put the anomaly in no community's neighborhood, which is exactly
    the structural signature the feature/LOF pipeline scores.

    Returns ``(src, dst, is_anomaly)`` with the new edges appended;
    ``is_anomaly`` is a bool ``[num_vertices]`` ground-truth mask.
    """
    rng = np.random.default_rng(seed)
    anomalies = rng.choice(num_vertices, size=num_anomalies, replace=False)
    a_src = np.repeat(anomalies, edges_per_anomaly)
    a_dst = rng.integers(0, num_vertices, num_anomalies * edges_per_anomaly)
    out_src = np.concatenate([src, a_src]).astype(np.int32)
    out_dst = np.concatenate([dst, a_dst]).astype(np.int32)
    mask = np.zeros(num_vertices, dtype=bool)
    mask[anomalies] = True
    return out_src, out_dst, mask
