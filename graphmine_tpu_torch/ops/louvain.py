"""Louvain and Leiden community detection (PyTorch).

Counterpart of ``graphmine_tpu/ops/louvain.py``, with the same algorithm
and the same answers. The inner phase is **synchronous parallel local
moves**: every vertex scores the modularity gain of joining each
neighbouring community and the best movers switch together, as sort and
segment work on the device:

  inner sweep (device):  sort (vertex, neighbour-community) message pairs
      → per-run weight totals → per-vertex argmax of the gain score →
      masked synchronous move (alternating vertex parity and the
      singleton-ordering rule break the swap cycles of synchronous moves)
  level contraction (host NumPy, the JAX package's own code):
      communities become super-vertices; edge weights aggregate;
      self-loops accumulate internal weight

Levels repeat until modularity stops improving. The level arrays are
padded to powers of two as in the JAX package (where the padding lets
compiled programs be reused); it changes no answer, and keeps the arrays
equal to the reference's step for step.

Parity: the gain score is float32 with the JAX package's order of
operations, ties go to the smallest community id, and the level decisions
read :func:`~graphmine_tpu_torch.ops.modularity.modularity_weighted` in
float32. Where every weight sum is exact in float32 (unweighted graphs,
weights in quarters) the labels equal the JAX package's bit for bit; Q
agrees to the last bits of a float32 sum.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.modularity import message_weights, modularity_weighted
from graphmine_tpu_torch.ops.segment import run_totals, segment_sum

_NEG_BIG = -3.4e38
_INT32_MAX = np.iinfo(np.int32).max


@dataclass(frozen=True)
class _Level:
    """One Louvain level: symmetric weighted messages + self-loop weights
    (host-side, padded; recv == padded V is the drop sentinel)."""

    recv: np.ndarray         # int32 [M_pad]
    send: np.ndarray         # int32 [M_pad]
    weight: np.ndarray       # float32 [M_pad]
    self_weight: np.ndarray  # float32 [V_pad]
    num_vertices: int        # true vertex count (<= V_pad)


def _pow2(n: int) -> int:
    return 1 << max(int(max(n, 1) - 1).bit_length(), 3)


def _pad_level(recv, send, w, self_w, v) -> _Level:
    m_pad, v_pad = _pow2(len(recv)), _pow2(v)
    pad = m_pad - len(recv)
    recv = np.concatenate([recv.astype(np.int32), np.full(pad, v_pad, np.int32)])
    send = np.concatenate([send.astype(np.int32), np.zeros(pad, np.int32)])
    w = np.concatenate([w.astype(np.float32), np.zeros(pad, np.float32)])
    self_w = np.concatenate([self_w.astype(np.float32), np.zeros(v_pad - v, np.float32)])
    return _Level(recv, send, w, self_w, v)


def _level_from_graph(graph: Graph) -> _Level:
    if not graph.symmetric:
        raise ValueError(
            "louvain needs the symmetric message list (both edge "
            "directions); rebuild the graph with symmetric=True"
        )
    recv = graph.msg_recv.cpu().numpy()
    send = graph.msg_send.cpu().numpy()
    # the self-loop/weight convention modularity_weighted reads, so the
    # gain optimizes exactly the score the level decisions report
    w, self_w = (a.cpu().numpy().astype(np.float32) for a in message_weights(graph))
    return _pad_level(recv, send, w, self_w, graph.num_vertices)


def _local_moves(recv, send, weight, self_weight, num_vertices: int, gamma: float,
                 max_sweeps: int, init=None, device=None) -> torch.Tensor:
    """Synchronous gain-based local moves until two sweeps in a row move
    no vertex, at most ``max_sweeps``. Operates on padded arrays (host or
    tensors) on ``device``; ``num_vertices`` is the padded size (padding
    vertices are isolated and never move). ``init``: the starting
    partition (default singletons). Returns int32 labels [num_vertices]."""
    v = num_vertices
    dev = resolve_device(device)
    recv = torch.as_tensor(recv).to(dev, torch.int64)
    send = torch.as_tensor(send).to(dev, torch.int64)
    w = torch.as_tensor(weight).to(dev, torch.float32)
    self_w = torch.as_tensor(self_weight).to(dev, torch.float32)
    k = segment_sum(w, recv, v) + 2.0 * self_w
    two_m = torch.clamp(k.sum(), min=1e-12)
    vertex_ids = torch.arange(v, dtype=torch.int64, device=dev)
    # Candidate messages: neighbour communities, plus a zero-weight "stay"
    # candidate per vertex so the current community is always scored.
    seg = torch.cat([recv, vertex_ids])
    wgt = torch.cat([w, torch.zeros(v, dtype=torch.float32, device=dev)])
    parity = vertex_ids % 2

    def sweep(comm: torch.Tensor, it: int):
        sigma_tot = segment_sum(k, comm, v)
        comm_size = torch.bincount(comm, minlength=v)
        val = torch.cat([comm[send], comm])
        # one stable sort by (seg, val): seg <= v and val < v
        key, order = torch.sort(seg * (v + 1) + val, stable=True)
        seg_s, val_s = key // (v + 1), key % (v + 1)
        new_run = torch.ones(key.shape[0], dtype=torch.bool, device=dev)
        new_run[1:] = key[1:] != key[:-1]
        run_w = run_totals(new_run, wgt[order])
        # Gain of vertex i joining community d (terms constant in i
        # dropped): w_{i->d} - gamma * k_i * Sigma_tot'_d / (2m), where
        # Sigma_tot' excludes i itself from its own community.
        valid = seg_s < v
        seg_c = torch.clamp(seg_s, max=v - 1)
        k_i = k[seg_c]
        own = val_s == comm[seg_c]
        tot_adj = sigma_tot[torch.clamp(val_s, max=v - 1)] - torch.where(own, k_i, 0.0)
        score = torch.where(valid, run_w - gamma * k_i * tot_adj / two_m, _NEG_BIG)
        # segment reductions into v + 1 slots: the sentinel's run lands in
        # the last one and is cut off
        neg_inf = torch.full((v + 1,), float("-inf"), dtype=torch.float32, device=dev)
        best = neg_inf.clone().scatter_reduce_(0, seg_s, score, "amax")[:v]
        is_best = (score >= best[seg_c]) & valid
        cand = torch.where(is_best, val_s, _INT32_MAX)
        choice = torch.full((v + 1,), _INT32_MAX, dtype=torch.int64, device=dev)
        choice = choice.scatter_reduce_(0, seg_s, cand, "amin")[:v]
        choice = torch.where(choice == _INT32_MAX, comm, choice)
        # strict improvement over staying, with an epsilon against noise
        stay = torch.where(valid & own, score, _NEG_BIG)
        stay_best = neg_inf.scatter_reduce_(0, seg_s, stay, "amax")[:v]
        improves = best > stay_best + 1e-4
        # alternating parity serializes half of all conflicting moves; a
        # singleton joins another singleton only toward the smaller id
        may_move = parity == (it % 2)
        i_single = comm_size[comm] == 1
        tgt_single = comm_size[torch.clamp(choice, max=v - 1)] == 1
        swap_risk = i_single & tgt_single & (choice > comm)
        new_comm = torch.where(improves & may_move & ~swap_risk, choice, comm)
        return new_comm, int((new_comm != comm).sum())

    comm = vertex_ids if init is None else torch.as_tensor(init).to(dev, torch.int64)
    quiet = it = 0
    # parity alternation: one quiet sweep proves only half the vertices
    # have no move; stop after a quiet even+odd pair
    while quiet < 2 and it < max_sweeps:
        comm, moved = sweep(comm, it)
        quiet = 0 if moved > 0 else quiet + 1
        it += 1
    return comm.to(torch.int32)


def _contract(level: _Level, comm: np.ndarray):
    """Host-side level contraction: communities -> super-vertices.

    Returns ``(new_level, dense)`` where ``dense[i]`` is the super-vertex of
    old vertex ``i``. Levels shrink geometrically, so level 0 dominates.
    """
    v = level.num_vertices
    uniq, dense = np.unique(comm[:v], return_inverse=True)
    c = len(uniq)
    real = level.recv < len(level.self_weight)
    cu = dense[level.recv[real]]
    cv = dense[level.send[real]]
    w = level.weight[real]
    internal = cu == cv
    new_self = np.zeros(c, np.float64)
    np.add.at(new_self, dense, level.self_weight[:v].astype(np.float64))
    np.add.at(new_self, cu[internal], 0.5 * w[internal].astype(np.float64))
    key = cu[~internal].astype(np.int64) * c + cv[~internal]
    pairs, pair_inv = np.unique(key, return_inverse=True)
    new_w = np.zeros(len(pairs), np.float64)
    np.add.at(new_w, pair_inv, w[~internal].astype(np.float64))
    new_recv = (pairs // c).astype(np.int32)
    new_send = (pairs % c).astype(np.int32)
    new_level = _pad_level(new_recv, new_send, new_w, new_self, c)
    return new_level, dense.astype(np.int32)


class _Scorer:
    """Modularity of host labels on ``graph`` (float32, on its device),
    with the message weights split once."""

    def __init__(self, graph: Graph, gamma: float):
        self.graph, self.gamma = graph, gamma
        self.w, self.self_w = message_weights(graph)

    def __call__(self, labels: np.ndarray) -> float:
        g = self.graph
        lab = torch.from_numpy(np.ascontiguousarray(labels, dtype=np.int32)).to(g.device)
        return float(modularity_weighted(lab, g.msg_recv, g.msg_send, self.w, self.self_w,
                                         g.num_vertices, self.gamma))


def _moves(level: _Level, gamma: float, max_sweeps: int, device, weight=None,
           init=None) -> np.ndarray:
    """:func:`_local_moves` over a level, back on the host."""
    return _local_moves(
        level.recv, level.send, level.weight if weight is None else weight,
        level.self_weight, num_vertices=len(level.self_weight), gamma=gamma,
        max_sweeps=max_sweeps, init=init, device=device,
    ).cpu().numpy()


def leiden(graph: Graph, gamma: float = 1.0, max_levels: int = 12, max_sweeps: int = 32,
           tol: float = 1e-6):
    """Leiden-style community detection: Louvain local moves plus a
    **refinement phase** before each contraction.

    Refinement re-runs the local moves from singletons with edge weights
    masked to intra-community messages only, so aggregation merges
    connected intra-community groups instead of whole Louvain communities;
    the next level's moves start from the previous communities projected
    onto the refined super-vertices (a deterministic variant of Traag et
    al.'s randomized refinement). A final pass splits every internally
    disconnected community into its connected pieces. Returns
    ``(labels, q)`` like :func:`louvain`.
    """
    score = _Scorer(graph, gamma)
    dev = graph.device
    level = _level_from_graph(graph)
    mapping = np.arange(graph.num_vertices, dtype=np.int32)
    best_labels = mapping
    best_q = score(mapping)
    v_pad = len(level.self_weight)
    init = np.arange(v_pad, dtype=np.int32)  # level 0: singletons
    for _ in range(max_levels):
        v_pad = len(level.self_weight)
        comm = _moves(level, gamma, max_sweeps, dev, init=init)
        # partition of record at this level, flattened to original vertices
        flat = comm[mapping]
        _, flat_dense = np.unique(flat, return_inverse=True)
        q = score(flat_dense.astype(np.int32))
        if q > best_q + tol:
            best_labels, best_q = flat_dense.astype(np.int32), q
        # refinement: local moves from singletons over intra-community
        # messages only (cross-community weights masked to zero)
        recv_c = np.clip(level.recv, 0, v_pad - 1)
        intra = comm[level.send] == comm[recv_c]
        refined = _moves(level, gamma, max_sweeps, dev,
                         weight=np.where(intra, level.weight, 0.0).astype(np.float32),
                         init=np.arange(v_pad, dtype=np.int32))
        new_level, dense = _contract(level, refined)
        # next level's initial partition: each refined super-vertex starts
        # in the community its members came from
        c = new_level.num_vertices
        first_member = np.full(c, np.iinfo(np.int64).max)
        np.minimum.at(first_member, dense, np.arange(level.num_vertices, dtype=np.int64))
        sv_comm = comm[first_member]
        _, sv_comm_dense = np.unique(sv_comm, return_inverse=True)
        next_pad = len(new_level.self_weight)
        init = np.arange(next_pad, dtype=np.int32)
        init[:c] = sv_comm_dense.astype(np.int32)
        mapping = dense[mapping]
        if new_level.num_vertices >= level.num_vertices or q <= best_q - tol:
            break
        level = new_level
    # Final guarantee pass: split any internally disconnected community
    # into its connected components (never lowers Q).
    labels = _split_disconnected(best_labels, graph)
    return torch.as_tensor(labels, dtype=torch.int32, device=dev), score(labels)


def _split_disconnected(labels: np.ndarray, graph: Graph) -> np.ndarray:
    """Relabel so every community is a connected piece: connected
    components of the intra-community edge subgraph (vertices with no
    intra-community edge become singletons)."""
    from graphmine_tpu_torch.graph.container import build_graph
    from graphmine_tpu_torch.ops.cc import connected_components

    labels = np.asarray(labels)
    src = graph.src.cpu().numpy()
    dst = graph.dst.cpu().numpy()
    keep = labels[src] == labels[dst]
    sub = build_graph(src[keep], dst[keep], num_vertices=graph.num_vertices,
                      device=graph.device)
    comp = connected_components(sub).cpu().numpy()
    _, dense = np.unique(comp, return_inverse=True)
    return dense.astype(np.int32)


def louvain(graph: Graph, gamma: float = 1.0, max_levels: int = 12, max_sweeps: int = 32,
            tol: float = 1e-6):
    """Louvain community labels + modularity for a :class:`Graph`.

    Returns ``(labels, q)``: int32 labels ``[V]`` on the graph's device
    (level-0 vertex-dense community ids) and the float modularity of that
    partition on the input graph. Deterministic: synchronous sweeps with
    smallest-id tie-breaks, no randomness.
    """
    score = _Scorer(graph, gamma)
    dev = graph.device
    level = _level_from_graph(graph)
    mapping = np.arange(graph.num_vertices, dtype=np.int32)
    best_labels, best_q = mapping, score(mapping)
    for _ in range(max_levels):
        comm = _moves(level, gamma, max_sweeps, dev)
        new_level, dense = _contract(level, comm)
        mapping = dense[mapping]
        q = score(mapping)
        if q > best_q + tol:
            best_labels, best_q = mapping.copy(), q
        shrunk = new_level.num_vertices < level.num_vertices
        if not shrunk or q <= best_q - tol:
            break
        level = new_level
    return torch.as_tensor(best_labels, dtype=torch.int32, device=dev), best_q
