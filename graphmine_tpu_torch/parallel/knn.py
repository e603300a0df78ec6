"""Ring-sharded kNN + LOF over a mesh (PyTorch).

Counterpart of ``graphmine_tpu/parallel/knn.py``. Points stay row-sharded:
shard ``s`` holds rows ``[s*chunk, (s+1)*chunk)``, the chunks rotate round
the ring (:func:`~graphmine_tpu_torch.parallel.mesh.ppermute`), and each
shard folds the visiting chunk into a running top-k of its own rows. A hop
is a cross kNN in plain PyTorch
(:func:`~graphmine_tpu_torch.ops.knn.cross_knn`, global row ids masking
self pairs, padding rows masked), as the JAX package's hop is plain jnp:
no hand-written kernel runs inside the ring.

Semantics match :func:`graphmine_tpu_torch.ops.knn.knn` (self excluded by
global id, duplicates kept, squared Euclidean, ascending), with the JAX
package's one scoped difference: among exactly tied distances the
neighbour order follows the ring's visit order, not the ascending global
index, so tied id lists may differ while the distance lists agree.
"""

from __future__ import annotations

import numpy as np
import torch

from graphmine_tpu_torch.ops.knn import cross_knn, smallest_k
from graphmine_tpu_torch.ops.lof import lof_from_knn
from graphmine_tpu_torch.parallel.mesh import Mesh, gather_to, ppermute


def _as_points(points, device) -> torch.Tensor:
    if not isinstance(points, torch.Tensor):
        points = torch.from_numpy(np.asarray(points, np.float32))
    return points.to(device=device, dtype=torch.float32)


def can_shard(n: int, num_devices: int, k: int) -> bool:
    """Whether ``[n, F]`` points can ride the ring with this ``k``: each
    shard's chunk (``ceil(n/D)``) must hold at least ``k`` candidates."""
    return 0 < k < n and k <= -(-n // num_devices)


def sharded_knn(points, mesh: Mesh, k: int, row_tile: int = 1024):
    """k nearest neighbours with the points sharded over a 1-D mesh:
    ``(d2 float32 [N, k], idx int32 [N, k])`` on the mesh's first device,
    the contract of :func:`graphmine_tpu_torch.ops.knn.knn`."""
    dev0, d = mesh.devices[0], mesh.size
    pts = _as_points(points, dev0)
    n, f = pts.shape
    chunk = -(-n // d)
    if not can_shard(n, d, k):
        if not 0 < k < n:
            raise ValueError(f"k={k} must be < number of points {n}")
        raise ValueError(
            f"k={k} exceeds the per-device chunk {chunk} (= ceil(N/D)); "
            "use fewer devices or the single-device ops.knn path"
        )
    padded = torch.zeros((d * chunk, f), dtype=torch.float32, device=dev0)
    padded[:n] = pts
    own = [padded[s * chunk:(s + 1) * chunk].to(dev, copy=True)
           for s, dev in enumerate(mesh.devices)]
    span = [torch.arange(chunk, dtype=torch.int32, device=dev) for dev in mesh.devices]
    local_gid = [s * chunk + span[s] for s in range(d)]
    best_d = [torch.full((chunk, k), float("inf"), dtype=torch.float32, device=dev)
              for dev in mesh.devices]
    best_g = [torch.zeros((chunk, k), dtype=torch.int32, device=dev) for dev in mesh.devices]
    visit = list(own)
    for r in range(d):
        for s in range(d):
            visit_gid = ((s - r) % d) * chunk + span[s]
            d2, idx = cross_knn(own[s], visit[s], k, ref_mask=visit_gid < n, row_tile=row_tile,
                                query_ids=local_gid[s], ref_ids=visit_gid)
            cat_d = torch.cat([best_d[s], d2], dim=1)
            cat_g = torch.cat([best_g[s], visit_gid[idx.to(torch.int64)]], dim=1)
            best_d[s], pos = smallest_k(cat_d, k)
            best_g[s] = torch.gather(cat_g, 1, pos)
        if r != d - 1:
            visit = ppermute(mesh, visit)
    return gather_to(best_d, dev0)[:n], gather_to(best_g, dev0)[:n]


def mesh_ivf_search_exec(mesh: Mesh):
    """A ``search_exec`` for :func:`graphmine_tpu_torch.ops.ann.ivf_knn`
    that splits the cluster-batched search over ``mesh``: the chunk rows
    are padded to a multiple of the shard count (rows appended at the end,
    which ``ivf_knn`` cuts off) and shard ``s`` searches the ``s``-th
    contiguous block on its device, the points and member tables
    replicated there. Each chunk row's result is that of the one-device
    search, bit for bit."""
    from graphmine_tpu_torch.ops.ann import _search_chunks

    def exec_fn(pts, m_gid, m_valid, q_gid, row_sub, k):
        d = mesh.size
        r, b = q_gid.shape
        per = -(-r // d)
        qg = torch.zeros((per * d, b), dtype=q_gid.dtype, device=q_gid.device)
        qg[:r] = q_gid
        # padded rows search sublist 0 for query 0: never read back
        rs = torch.zeros(per * d, dtype=row_sub.dtype, device=row_sub.device)
        rs[:r] = row_sub
        outs_d, outs_g = [], []
        for s, dev in enumerate(mesh.devices):
            sl = slice(s * per, (s + 1) * per)
            d2, gid = _search_chunks(pts.to(dev), m_gid.to(dev), m_valid.to(dev),
                                     qg[sl].to(dev), rs[sl].to(dev), k)
            outs_d.append(d2)
            outs_g.append(gid)
        return gather_to(outs_d, pts.device), gather_to(outs_g, pts.device)

    return exec_fn


def sharded_lof(points, mesh: Mesh, k: int = 128, row_tile: int = 1024, impl: str = "auto",
                sink=None) -> torch.Tensor:
    """LOF scores over a mesh, float32 ``[N]`` on the mesh's first device.

    ``impl``: ``"exact"`` runs the ring-sharded kNN; ``"ivf"`` the IVF
    index with its search split over the mesh
    (:func:`mesh_ivf_search_exec`; the index build and the merge stay on
    the first device; its pathology guards fall back to the exact kNN
    loudly); ``"auto"`` takes the policy of
    :func:`graphmine_tpu_torch.ops.lof.select_lof_impl` (IVF from 2^17
    points) and, with a ``sink``, emits the ``impl_selected`` record."""
    from graphmine_tpu_torch.ops.lof import resolved_ivf_min_points, select_lof_impl

    if impl not in ("auto", "ivf", "exact"):
        raise ValueError(f"unknown sharded LOF impl {impl!r}; use 'auto', 'ivf' or 'exact'")
    pts = _as_points(points, mesh.devices[0])
    n, f = int(pts.shape[0]), int(pts.shape[1])
    family, reason = select_lof_impl(n, k, impl=impl)
    if sink is not None:
        from graphmine_tpu_torch.obs.costmodel import lof_cost

        sink.emit("impl_selected", op="lof_knn", impl=family, requested=impl, n=n, k=k,
                  devices=int(mesh.size), reason=reason,
                  thresholds={"lof_ivf_min_points": resolved_ivf_min_points()},
                  cost=lof_cost(family, n, k, features=f, devices=int(mesh.size)).record())
    if family == "ivf":
        from graphmine_tpu_torch.ops.ann import ivf_knn

        d2, gid = ivf_knn(pts, k=k, sink=sink, search_exec=mesh_ivf_search_exec(mesh))
    else:
        d2, gid = sharded_knn(pts, mesh, k, row_tile)
    return lof_from_knn(d2, gid, k)
