"""Approximate kNN: IVF-flat (k-means + cluster-probe search) (PyTorch).

Counterpart of ``graphmine_tpu/ops/ann.py``, which ``lof_scores`` takes
from 2^17 points under ``impl="auto"``. The index:

- **k-means** (:func:`kmeans`): Lloyd iterations from a NumPy seeded
  sample of the points; the assignment is a tiled argmin over the
  centers, the update sums each cluster's points in point order (a stable
  sort by assignment, then one sequential sum per cluster), so the
  centers have the same bits on every device and in every run; empty
  clusters keep their center.
- **Inverted lists**, built on the host with NumPy exactly as the JAX
  package builds them: points in cluster order, big clusters split into
  sublists of at most ``l_cap`` members, (query, sublist) pairs grouped by
  sublist and cut into chunks of 4096 query slots.
- **Search** (:func:`_search_chunks`): for groups of chunks at once, the
  distances from each chunk's queries to its sublist's members and their
  k smallest; then :func:`_merge_tiles` takes each query's k smallest over
  its pairs. A member belongs to one sublist, so candidates never repeat.

Distances are the exact kNN's plain float32 formula, feature by feature
(``ops/knn.py``), with no matrix product, so no TF32 setting reaches
them; selections break ties toward the smaller position, the rule of
``lax.top_k``. The result contract is :func:`~graphmine_tpu_torch.ops.knn.knn`'s:
``(d2, idx)`` ascending, self excluded. The pathology guards fall back to
the exact kNN loudly: a warning and an ``ivf_fallback`` record.
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from graphmine_tpu_torch.ops.knn import _cross, _sq_dists, _sq_norms, cross_knn, knn, smallest_k

_ASSIGN_TILE = 1 << 15  # [32768, C] distance tiles in the assignment
_CHUNK_B = 4096         # query slots per search chunk
_MERGE_T = 16384        # queries per merge tile
_SEARCH_ELEMS = 1 << 25  # distance entries per batched search launch


def default_n_clusters(n: int) -> int:
    """The IVF index's default cluster count for an ``n``-point set:
    ``~sqrt(N)``, rounded to a multiple of 8, min 8."""
    return max(8, int(round(np.sqrt(n) / 8)) * 8)


def _assign_tiled(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-center id (int64) per point: row tiles of
    ``|c|^2 - 2 p.c``, argmin to the first minimum."""
    c_sq = _sq_norms(centers)
    out = torch.empty(points.shape[0], dtype=torch.int64, device=points.device)
    for t0 in range(0, points.shape[0], _ASSIGN_TILE):
        p = points[t0:t0 + _ASSIGN_TILE]
        # |p|^2 is constant per row: the argmin does not need it
        out[t0:t0 + _ASSIGN_TILE] = torch.argmin(c_sq[None, :] - 2.0 * _cross(p, centers), dim=1)
    return out


def _lloyd_step(points: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    a = _assign_tiled(points, centers)
    counts = torch.bincount(a, minlength=centers.shape[0])
    order = torch.argsort(a, stable=True)
    sums = torch.segment_reduce(points[order], "sum", lengths=counts)
    cnt = counts.to(torch.float32)
    return torch.where(cnt[:, None] > 0, sums / torch.clamp(cnt, min=1.0)[:, None], centers)


def kmeans(points: torch.Tensor, n_clusters: int, iters: int = 5, seed: int = 0) -> torch.Tensor:
    """Lloyd k-means on ``points``' device. Returns float32 centers
    ``[n_clusters, F]``, deterministic in ``seed`` (the init is
    ``np.random.default_rng(seed).choice`` of the points)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    if n_clusters > n:
        raise ValueError(f"n_clusters={n_clusters} > num points {n}")
    rng = np.random.default_rng(seed)
    init = rng.choice(n, n_clusters, replace=False)
    centers = pts[torch.from_numpy(init).to(pts.device)]
    for _ in range(iters):
        centers = _lloyd_step(pts, centers)
    return centers


def _search_chunks(pts, m_gid, m_valid, q_gid, row_sub, k: int):
    """The cluster-batched search on ``pts``' device. ``q_gid [R, B]``
    query ids of each chunk, ``row_sub [R]`` its sublist, ``m_gid
    [n_sub, Lmax]`` / ``m_valid`` the sublists' members. Groups of chunks
    run as one batch of ``[G, B, Lmax]`` distances. Returns ``([R, B, k]
    d2, [R, B, k] int32 ids)``; padded query slots give rows that are
    never read."""
    r, b = q_gid.shape
    l_max = m_gid.shape[1]
    sq = _sq_norms(pts)
    d2_all = torch.empty((r, b, k), dtype=torch.float32, device=pts.device)
    gid_all = torch.empty((r, b, k), dtype=torch.int32, device=pts.device)
    group = max(1, _SEARCH_ELEMS // (b * l_max))
    for g0 in range(0, r, group):
        qg = q_gid[g0:g0 + group]
        s = row_sub[g0:g0 + group]
        mg = m_gid[s]
        d2 = _sq_dists(pts[qg], sq[qg], pts[mg], sq[mg])
        masked = ~m_valid[s][:, None, :] | (qg[:, :, None] == mg[:, None, :])  # self
        d2k, j = smallest_k(d2.masked_fill_(masked, float("inf")), k)
        d2_all[g0:g0 + group] = d2k
        gid_all[g0:g0 + group] = torch.gather(mg, 1, j.flatten(1)).view(j.shape)
    return d2_all, gid_all


def _exact_fallback(pts, k: int, guard: str, detail: str, sink):
    """The exit when a pathology guard trips: the exact kNN, loudly."""
    warnings.warn(
        f"ivf_knn guard {guard!r} tripped ({detail}); falling back to the "
        "exact kNN path",
        stacklevel=3,
    )
    if sink is not None:
        sink.emit("ivf_fallback", guard=guard, detail=detail)
    return knn(pts, k)


def ivf_knn(points: torch.Tensor, k: int, n_clusters: int | None = None, n_probe: int = 16,
            seed: int = 0, kmeans_iters: int = 5, sink=None, centers=None, search_exec=None):
    """Approximate k nearest neighbours (IVF-flat) of ``points`` ``[N, F]``
    on their device: ``(d2 float32 [N, k], idx int32 [N, k])`` ascending,
    self excluded, like :func:`~graphmine_tpu_torch.ops.knn.knn`.

    ``n_clusters`` defaults to :func:`default_n_clusters`; each query
    searches its ``n_probe`` nearest clusters. Clouds under
    ``4 * n_clusters`` points take the exact path by design. The guards
    ``k_unfillable``, ``capacity``, ``skew`` and ``index_bound`` take it
    loudly (a warning, and an ``ivf_fallback`` record on ``sink``).
    ``centers``: pre-trained ``[C, F]`` centers, which skip k-means. With a
    ``sink``, an index that runs emits an ``ivf_index`` record of its sizes
    and of the host seconds of k-means with the probe and of the host
    tables.

    ``search_exec`` replaces the executor of the cluster-batched search,
    the dominant distance work: ``(pts, m_gid, m_valid, q_gid, row_sub,
    k) -> (d2, gid)`` with :func:`_search_chunks`' arguments (tensors on
    the points' device) and results of ``[R', 4096, k]``, ``R' >= R``
    chunk rows, extra rows appended at the end (never read). The
    mesh-sharded LOF splits this stage over a mesh
    (:func:`graphmine_tpu_torch.parallel.knn.mesh_ivf_search_exec`).
    """
    pts = points.to(torch.float32).contiguous()
    dev = pts.device
    n, f = pts.shape
    if not 0 < k < n:
        raise ValueError(f"k={k} must be in (0, {n})")
    if centers is not None:
        centers = torch.as_tensor(centers, dtype=torch.float32, device=dev)
        if centers.ndim != 2 or centers.shape[1] != f:
            raise ValueError(f"centers must be [C, {f}], got {tuple(centers.shape)}")
        n_clusters = int(centers.shape[0])
    elif n_clusters is None:
        n_clusters = default_n_clusters(n)
    n_probe = min(n_probe, n_clusters)

    if n < 4 * n_clusters:
        # a sizing rule, not a pathology guard: tiny clouds take the exact
        # path by design, with no warning
        return knn(pts, k)

    t0 = time.perf_counter()
    if centers is None:
        centers = kmeans(pts, n_clusters, iters=kmeans_iters, seed=seed)
    # each query's n_probe nearest centers; column 0 is its own cluster
    _, probe = cross_knn(pts, centers, n_probe)
    probe = probe.cpu().numpy()
    t1 = time.perf_counter()
    assign = probe[:, 0]

    # ---- host: size-capped inverted sublists ---------------------------
    order = np.argsort(assign, kind="stable")     # members in cluster order
    sizes = np.bincount(assign, minlength=n_clusters)
    starts = np.zeros(n_clusters, np.int64)
    np.cumsum(sizes[:-1], out=starts[1:])
    l_cap = max(2 * (-(-n // n_clusters)), k + 1)
    n_subs_per_c = np.maximum(-(-sizes // l_cap), 1)
    n_sub = int(n_subs_per_c.sum())
    sub_cluster = np.repeat(np.arange(n_clusters), n_subs_per_c)
    sub_first = np.zeros(n_clusters, np.int64)
    np.cumsum(n_subs_per_c[:-1], out=sub_first[1:])
    sub_rank = np.arange(n_sub) - sub_first[sub_cluster]
    sub_start = starts[sub_cluster] + sub_rank * l_cap
    sub_len = np.minimum(sizes[sub_cluster] - sub_rank * l_cap, l_cap)
    sub_len = np.maximum(sub_len, 0)
    l_max = int(sub_len.max())
    if k >= sizes.max():
        return _exact_fallback(pts, k, "k_unfillable",
                               f"k={k} >= largest cluster size {int(sizes.max())}", sink)
    # member id matrix [n_sub, Lmax]; clamps keep empty sublists in bounds
    j = np.arange(l_max)
    m_rows = sub_start[:, None] + np.minimum(j[None, :], np.maximum(sub_len[:, None] - 1, 0))
    m_gid = order[np.minimum(m_rows, n - 1)]
    m_valid = j[None, :] < sub_len[:, None]

    # (query, sublist) pairs grouped by sublist, cut into chunks of B slots
    chunk_b = _CHUNK_B
    probe_subs = n_subs_per_c[probe]              # [N, p] sublists per probe
    pairs_per_q = probe_subs.sum(axis=1)          # [N]
    p_max = int(pairs_per_q.max())
    # capacity: a query whose probed clusters hold < k+1 members cannot
    # fill its top-k; skew: one dominant cluster expands every probe of it
    # into many sublists
    probed_sizes = sizes[probe].sum(axis=1)
    if int(probed_sizes.min()) < k + 1:
        return _exact_fallback(
            pts, k, "capacity",
            f"a query's probed clusters hold {int(probed_sizes.min())} "
            f"members < k+1={k + 1} (its top-k cannot fill)", sink,
        )
    if p_max > 4 * n_probe:
        return _exact_fallback(
            pts, k, "skew",
            f"probe expansion {p_max} sublists/query > 4*n_probe="
            f"{4 * n_probe} (one dominant cluster; IVF has no structure "
            "to exploit)", sink,
        )
    pair_q = np.repeat(np.arange(n, dtype=np.int64), pairs_per_q)
    # expand each probed cluster c into sub_first[c] .. +n_subs_per_c[c]
    flat_c = probe.reshape(-1).astype(np.int64)
    flat_q_subs = probe_subs.reshape(-1)
    pair_c = (
        np.repeat(sub_first[flat_c], flat_q_subs)
        + (np.arange(int(flat_q_subs.sum()))
           - np.repeat(np.cumsum(flat_q_subs) - flat_q_subs, flat_q_subs))
    )
    n_pairs = len(pair_q)
    pair_order = np.argsort(pair_c, kind="stable")
    q_counts = np.bincount(pair_c, minlength=n_sub)
    q_starts = np.zeros(n_sub, np.int64)
    np.cumsum(q_counts[:-1], out=q_starts[1:])
    chunks_per_s = -(-q_counts // chunk_b)       # ceil; 0 for unprobed
    r_rows = int(chunks_per_s.sum())
    # the merge indexes the flat [r_rows * chunk_b + 1] result rows; keep
    # the JAX package's int32 bound on those row ids
    if r_rows * chunk_b >= (1 << 31):
        return _exact_fallback(
            pts, k, "index_bound",
            f"merge-gather row ids reach {r_rows * chunk_b:,} >= 2^31 "
            "(int32 device gather would wrap)", sink,
        )
    row_sub = np.repeat(np.arange(n_sub), chunks_per_s)
    chunk_rank = np.arange(r_rows) - np.repeat(np.cumsum(chunks_per_s) - chunks_per_s,
                                               chunks_per_s)
    row_start = q_starts[row_sub] + chunk_rank * chunk_b
    row_len = np.minimum(q_counts[row_sub] - chunk_rank * chunk_b, chunk_b)
    jb = np.arange(chunk_b)
    q_rows = row_start[:, None] + np.minimum(jb[None, :], np.maximum(row_len[:, None] - 1, 0))
    q_valid = jb[None, :] < row_len[:, None]
    q_gid = pair_q[pair_order[q_rows]]            # [R, B]

    # valid (row, slot) cells in row-major order visit the sorted pair
    # positions 0..P-1 in order, so each real pair's flat result row is its
    # valid-cell flat index
    slot_of_pair = np.empty(n_pairs, np.int64)
    slot_of_pair[pair_order] = np.arange(r_rows * chunk_b).reshape(r_rows, chunk_b)[q_valid]
    if sink is not None:
        # host clock; the first span ends in the probe's copy to the host
        sink.emit("ivf_index", n=n, k=k, n_clusters=n_clusters, n_probe=n_probe,
                  sublists=n_sub, l_max=l_max, p_max=p_max, pairs=n_pairs,
                  chunks=r_rows, largest_cluster=int(sizes.max()),
                  train_probe_seconds=t1 - t0, tables_seconds=time.perf_counter() - t1)

    to_dev = lambda a: torch.from_numpy(a).to(dev)
    exec_fn = search_exec if search_exec is not None else _search_chunks
    d2_all, gid_all = exec_fn(pts, to_dev(m_gid), to_dev(m_valid), to_dev(q_gid),
                              to_dev(row_sub), k)
    if (d2_all.shape[0] < r_rows or tuple(d2_all.shape[1:]) != (chunk_b, k)
            or gid_all.shape != d2_all.shape):
        # a short result would clamp real pairs onto the junk row
        raise ValueError(
            f"search_exec returned shapes {tuple(d2_all.shape)}/{tuple(gid_all.shape)}; "
            f"expected [R'>= {r_rows}, {chunk_b}, {k}] with extra rows appended at the end")
    # per-pair rows (an executor's padded rows cut off), plus one all-inf
    # junk row that pads the queries with fewer than p_max pairs (never
    # selected)
    junk = r_rows * chunk_b
    d2_flat = torch.cat([d2_all.reshape(-1, k)[:junk].to(dev),
                         torch.full((1, k), float("inf"), dtype=torch.float32, device=dev)])
    gid_flat = torch.cat([gid_all.reshape(-1, k)[:junk].to(dev),
                          torch.full((1, k), -1, dtype=torch.int32, device=dev)])
    del d2_all, gid_all
    take = np.full((n, p_max), junk, np.int64)
    pair_col = np.arange(n_pairs) - np.repeat(np.cumsum(pairs_per_q) - pairs_per_q, pairs_per_q)
    take[pair_q, pair_col] = slot_of_pair
    return _merge_tiles(d2_flat, gid_flat, to_dev(take), k)


def _merge_tiles(d2_flat, gid_flat, take, k: int):
    """Per-query merge in tiles of ``_MERGE_T`` queries: gather each
    query's pair rows (``take [N, p_max]``) and take the k smallest of the
    ``p_max * k`` candidates, ties to the earlier pair."""
    n, p_max = take.shape
    out_d = torch.empty((n, k), dtype=torch.float32, device=take.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=take.device)
    for t0 in range(0, n, _MERGE_T):
        tk = take[t0:t0 + _MERGE_T]
        d2_t = d2_flat[tk].reshape(tk.shape[0], p_max * k)
        gid_t = gid_flat[tk].reshape(tk.shape[0], p_max * k)
        out_d[t0:t0 + _MERGE_T], sel = smallest_k(d2_t, k)
        out_i[t0:t0 + _MERGE_T] = torch.gather(gid_t, 1, sel)
    return out_d, out_i
