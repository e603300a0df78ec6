"""Maximal independent set (Luby) and greedy colouring by repeated MIS.

Counterpart of ``graphmine_tpu/ops/mis.py``. Each round draws a fresh
uint32 priority per vertex from the port's copy of JAX's PRNG
(:mod:`~graphmine_tpu_torch.ops._threefry`: ``bits(fold_in(key, round))
| 1``), so for the same ``seed`` the masks and colours are bit-equal to
the JAX package's. A vertex joins when its priority is above every
undecided neighbour's (one ``segment_max`` over the symmetric message
CSR), then its neighbours drop out. The loops run on the host, one
synchronise per round.
"""

from __future__ import annotations

import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops import _threefry
from graphmine_tpu_torch.ops.segment import segment_max

_UNDECIDED, _IN, _OUT = 0, 1, 2


def _round_priorities(key, it: int, v: int, device) -> torch.Tensor:
    """Fresh uint32 priority per vertex per round (int64), bit 0 set so
    0 can be the masked-out sentinel."""
    return _threefry.bits(_threefry.fold_in(key, it), (v,), device) | 1


def _mis_rounds(state: torch.Tensor, send, recv, v: int, key, limit: int) -> torch.Tensor:
    """Run Luby rounds until no vertex is undecided (or ``limit``)."""
    # a self-loop must not let a vertex block itself
    not_self = send != recv
    it = 0
    while it < limit and bool((state == _UNDECIDED).any()):
        pri = torch.where(state == _UNDECIDED, _round_priorities(key, it, v, state.device), 0)
        nbr_max = segment_max(torch.where(not_self, pri[send], 0), recv, v)
        join = (state == _UNDECIDED) & (pri > nbr_max)
        state = torch.where(join, _IN, state)
        nbr_in = segment_max(torch.where(not_self, (state[send] == _IN).to(torch.int32), 0),
                             recv, v)
        state = torch.where((state == _UNDECIDED) & (nbr_in > 0), _OUT, state)
        it += 1
    return state


def _symmetric_messages(graph: Graph, what: str):
    if not graph.symmetric:
        raise ValueError(f"{what} needs symmetric=True "
                         "(independence is an undirected property)")
    return graph.msg_send.to(torch.int64), graph.msg_recv.to(torch.int64)


def maximal_independent_set(graph: Graph, seed: int = 0, max_iter: int = 0) -> torch.Tensor:
    """Boolean ``[V]`` MIS membership mask (independent and maximal) on a
    symmetric graph; deterministic for ``seed``; self-loops are ignored.
    ``max_iter`` (default V) caps the Luby rounds."""
    send, recv = _symmetric_messages(graph, "maximal_independent_set")
    v = graph.num_vertices
    limit = max_iter if max_iter > 0 else v
    state = torch.full((v,), _UNDECIDED, dtype=torch.int32, device=graph.device)
    state = _mis_rounds(state, send, recv, v, _threefry.PRNGKey(seed), limit)
    return state == _IN


def greedy_color(graph: Graph, seed: int = 0, max_colors: int = 0) -> torch.Tensor:
    """Proper vertex colouring ``[V]`` (int32 colours from 0) by repeated
    MIS: round ``c``'s maximal independent set of the uncoloured subgraph
    gets colour ``c``. Symmetric graph; deterministic for ``seed``;
    self-loops ignored. With the default cap every vertex is coloured; an
    explicit ``max_colors`` that runs out leaves the rest at ``-1``."""
    send, recv = _symmetric_messages(graph, "greedy_color")
    v = graph.num_vertices
    limit = max_colors if max_colors > 0 else v
    key = _threefry.PRNGKey(seed)
    colors = torch.full((v,), -1, dtype=torch.int32, device=graph.device)
    c = 0
    while c < limit and bool((colors < 0).any()):
        # coloured vertices start out, so they neither join nor block; a
        # message with a coloured end takes no part in the rounds (its
        # sender's priority and membership read as 0, or its receiver is
        # decided), so only the uncoloured subgraph's messages are kept
        state = torch.where(colors < 0, _UNDECIDED, _OUT).to(torch.int32)
        live = (colors[send] < 0) & (colors[recv] < 0)
        send, recv = send[live], recv[live]
        state = _mis_rounds(state, send, recv, v, _threefry.fold_in(key, c), v)
        colors = torch.where(state == _IN, c, colors)
        c += 1
    return colors
