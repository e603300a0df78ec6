"""Ring-sharded supersteps: labels stay sharded, chunks rotate (PyTorch).

Counterpart of ``graphmine_tpu/parallel/ring.py``. Where
:mod:`~graphmine_tpu_torch.parallel.sharded` keeps a full label vector on
every shard, here each shard keeps only its own ``[Vc]`` chunk, and a
superstep gathers sender labels by rotating the chunks once round the
ring (:func:`_ring_gather`: D - 1 :func:`~graphmine_tpu_torch.parallel.mesh.ppermute`
hops, each shard filling the positions owned by the chunk in hand). Per
shard the memory is the O(M/D) messages and two chunks, with no
replicated O(V) term; the bytes moved equal one all-gather. The answers
are those of the single-device ops: labels bit for bit, PageRank within
its float tolerance.
"""

from __future__ import annotations

import torch

from graphmine_tpu_torch.ops.segment import SegmentSums, segment_min, segment_mode
from graphmine_tpu_torch.parallel.mesh import VERTEX_AXIS, Mesh, gather_to, ppermute, psum
from graphmine_tpu_torch.parallel.sharded import (
    ShardedGraph,
    _check_pagerank_weighted,
    _fixpoint_supersteps,
    _need,
    _on_mesh,
    _padded_init_labels,
    _pad_labels,
    _pagerank_terms,
    _scan_supersteps,
)


def _check_ring_mesh(sg: ShardedGraph, mesh: Mesh) -> ShardedGraph:
    """Ring schedules shift over the one vertex axis: a multi-axis mesh
    is refused (the replicated schedules take those)."""
    sg = _on_mesh(sg, mesh)
    if tuple(mesh.axis_names) != (VERTEX_AXIS,):
        raise ValueError(
            f"ring schedules need a 1-D ('{VERTEX_AXIS}',) mesh (got axes "
            f"{tuple(mesh.axis_names)}); use the sharded_* replicated "
            "schedules on multi-slice meshes"
        )
    return sg


def _ring_gather(mesh: Mesh, chunks, global_idx, chunk_size: int) -> list:
    """``values[global_idx[s]]`` for every shard ``s`` of a vertex-range
    sharded vector whose shard ``s`` holds ``chunks[s]``. The chunks
    rotate one hop a step; after hop ``r`` shard ``s`` holds the chunk of
    shard ``(s - r) % D`` and fills the positions that chunk owns. The
    last owner's chunk is used in hand, so D - 1 hops suffice."""
    d = mesh.size
    out = [torch.zeros(i.shape, dtype=c.dtype, device=c.device)
           for c, i in zip(chunks, global_idx)]
    owner_of = [torch.div(i, chunk_size, rounding_mode="floor") for i in global_idx]
    hand = list(chunks)
    for r in range(d):
        for s in range(d):
            owner = (s - r) % d
            sel = owner_of[s] == owner
            local = torch.clamp(global_idx[s] - owner * chunk_size, 0, chunk_size - 1)
            out[s] = torch.where(sel, hand[s][local], out[s])
        if r != d - 1:
            hand = ppermute(mesh, hand)
    return out


def _ring_init(sg: ShardedGraph, mesh: Mesh, init_labels) -> list:
    """The sharded initial state: shard ``s`` holds chunk ``s``."""
    dev0, vc = mesh.devices[0], sg.chunk_size
    full = (_padded_init_labels(sg, dev0) if init_labels is None
            else _pad_labels(init_labels, sg, dev0))
    return [full[s * vc:(s + 1) * vc].to(dev, copy=True) for s, dev in enumerate(mesh.devices)]


def _lpa_ring_step(sg: ShardedGraph, mesh: Mesh):
    """Ring LPA superstep: ring-gather sender labels, shard-local segment
    mode (weighted when the partition carries weights; only labels travel
    the ring), keep the own label where no message arrives."""
    vc, d = sg.chunk_size, sg.num_shards
    recv, send, deg = _need(sg.msg_recv_local, "message CSR"), sg.msg_send, sg.degrees
    w = sg.msg_weight

    def step(own):
        msg = _ring_gather(mesh, own, send, vc)
        out = []
        for s in range(d):
            mode, _ = segment_mode(recv[s], msg[s], vc, weights=None if w is None else w[s])
            out.append(torch.where(deg[s] > 0, mode, own[s]).to(torch.int32))
        return out

    return step


def _cc_ring_step(sg: ShardedGraph, mesh: Mesh):
    """Ring CC superstep: min-propagation, then pointer jumping, whose
    gather at arbitrary label ids is one more ring pass."""
    vc, d = sg.chunk_size, sg.num_shards
    recv, send, deg = _need(sg.msg_recv_local, "message CSR"), sg.msg_send, sg.degrees

    def step(own):
        msg = _ring_gather(mesh, own, send, vc)
        new = [torch.where(deg[s] > 0, torch.minimum(own[s], segment_min(msg[s], recv[s], vc)),
                           own[s]).to(torch.int32) for s in range(d)]
        rep = _ring_gather(mesh, new, new, vc)
        return [torch.minimum(n, r).to(torch.int32) for n, r in zip(new, rep)]

    return step


def ring_label_propagation(sg: ShardedGraph, mesh: Mesh, max_iter: int = 5,
                           init_labels=None) -> torch.Tensor:
    """Distributed synchronous LPA with sharded labels; labels identical
    to :func:`graphmine_tpu_torch.ops.lpa.label_propagation`. Returns int32
    labels ``[V]`` on the mesh's first device."""
    sg = _check_ring_mesh(sg, mesh)
    state = _scan_supersteps(_lpa_ring_step(sg, mesh), _ring_init(sg, mesh, init_labels),
                             max_iter, lambda st: st, mesh.devices[0])
    return gather_to(state, mesh.devices[0])[: sg.num_vertices]


def ring_connected_components(sg: ShardedGraph, mesh: Mesh, max_iter: int = 0) -> torch.Tensor:
    """Distributed weakly connected components with sharded labels, equal
    to :func:`graphmine_tpu_torch.ops.cc.connected_components`."""
    sg = _check_ring_mesh(sg, mesh)
    state = _fixpoint_supersteps(_cc_ring_step(sg, mesh), _ring_init(sg, mesh, None), sg,
                                 max_iter, lambda st: st, mesh.devices[0])
    return gather_to(state, mesh.devices[0])[: sg.num_vertices]


def ring_pagerank(sg: ShardedGraph, mesh: Mesh, out_degrees, alpha: float = 0.85,
                  max_iter: int = 100, tol: float = 1e-6,
                  weighted: bool | None = None) -> torch.Tensor:
    """Distributed PageRank with the rank vector sharded: a power
    iteration rotates the contribution chunks once (one ring gather), and
    the dangling mass and the convergence delta are two scalar
    :func:`~graphmine_tpu_torch.parallel.mesh.psum` s. ``sg`` comes from a
    directed graph; a weighted run takes float out-edge weight sums as
    ``out_degrees``. Returns float32 ranks ``[V]`` summing to 1."""
    sg = _check_ring_mesh(sg, mesh)
    weighted = _check_pagerank_weighted(sg, out_degrees, weighted)
    dev0, vc, d = mesh.devices[0], sg.chunk_size, sg.num_shards
    inv_out, reset, dangling = _pagerank_terms(out_degrees, sg.num_vertices,
                                               sg.padded_vertices, dev0)

    def chunked(x):
        return [x[s * vc:(s + 1) * vc].to(dev, copy=True) for s, dev in enumerate(mesh.devices)]

    inv_o, res, dang = chunked(inv_out), chunked(reset), chunked(dangling)
    recv, send = _need(sg.msg_recv_local, "message CSR"), sg.msg_send
    sums = [SegmentSums(recv[s], vc) for s in range(d)]
    pr = [r.clone() for r in res]
    delta, it = 1.0, 0
    while delta > tol and it < max_iter:
        msg = _ring_gather(mesh, [p * i for p, i in zip(pr, inv_o)], send, vc)
        inflow = []
        for s in range(d):
            m = msg[s] * (recv[s] < vc)
            if weighted:
                m = m * sg.msg_weight[s]
            inflow.append(sums[s].sum(m))
        dm = psum(mesh, [torch.where(dg, p, 0.0).sum() for dg, p in zip(dang, pr)])
        new = [alpha * (inflow[s] + dm[s] * res[s]) + (1.0 - alpha) * res[s] for s in range(d)]
        delta = float(psum(mesh, [(n - p).abs().sum() for n, p in zip(new, pr)])[0])
        pr = new
        it += 1
    return gather_to(pr, dev0)[: sg.num_vertices]
