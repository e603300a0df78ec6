"""Strongly connected components: the coloring algorithm (PyTorch).

Counterpart of ``graphmine_tpu/ops/scc.py`` (Orzan's coloring algorithm,
the same BSP shape as LPA and CC):

  repeat until every vertex is assigned:
    1. forward min-propagation of vertex ids among unassigned vertices to a
       fixpoint ("coloring"): each vertex's color is the smallest
       unassigned id that reaches it along edge direction;
    2. roots are vertices whose color is their own id; a root's SCC is the
       set of vertices that reach it backward without leaving its color
       class;
    3. those vertices take their color as final SCC id and drop out.

Each ``while_loop`` of the JAX package is a Python loop here with one host
read per iteration. Every step is a minimum, a maximum or a mask, exact in
any order, so the labels equal the JAX package's on every device. Labels
are canonical representatives (a member vertex id).
"""

from __future__ import annotations

import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops.segment import segment_max, segment_min

_SENT = (1 << 31) - 1


def _until_stable(body, state: torch.Tensor) -> torch.Tensor:
    """Apply ``body`` until it changes nothing (at least once)."""
    while True:
        new = body(state)
        if not bool((new != state).any()):
            return new
        state = new


def strongly_connected_components(graph: Graph) -> torch.Tensor:
    """SCC id per vertex, int32 ``[V]`` (id = a member vertex of the SCC)."""
    v = graph.num_vertices
    src, dst = graph.src.to(torch.int64), graph.dst.to(torch.int64)
    ids = torch.arange(v, dtype=torch.int32, device=graph.device)

    def color_fixpoint(unassigned: torch.Tensor) -> torch.Tensor:
        """Forward min-propagation of ids within the unassigned set."""

        def body(color):
            msg = torch.where(unassigned[src], color[src], _SENT)
            relax = segment_min(msg, dst, v)
            return torch.where(unassigned, torch.minimum(color, relax), color)

        return _until_stable(body, torch.where(unassigned, ids, _SENT))

    def backward_fixpoint(roots, color, unassigned) -> torch.Tensor:
        """Backward reachability of roots within each color class."""

        def body(in_scc):
            hit = in_scc[dst] & (color[src] == color[dst])
            relax = segment_max(hit.to(torch.int32), src, v) > 0
            return in_scc | (relax & unassigned)

        return _until_stable(body, roots)

    scc = torch.full((v,), -1, dtype=torch.int32, device=graph.device)
    while bool((scc < 0).any()):
        unassigned = scc < 0
        color = color_fixpoint(unassigned)
        roots = unassigned & (color == ids)
        in_scc = backward_fixpoint(roots, color, unassigned)
        scc = torch.where(in_scc, color, scc)
    return scc
