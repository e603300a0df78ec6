"""Spectral vertex embeddings via subspace iteration (PyTorch).

Counterpart of ``graphmine_tpu/ops/embedding.py``: each vertex gets a
``dim``-dimensional coordinate from the top nontrivial eigenvectors of
the normalized adjacency ``D^{-1/2} A D^{-1/2}``, by the block power
method on ``(M + I) / 2`` with the trivial ``D^{1/2} 1`` direction
deflated every round, a thin QR of the ``[V, dim + 1]`` block per round,
and the columns ordered by Rayleigh quotient at the end. The starting
block is the JAX package's draw (``jax.random.normal(PRNGKey(seed))``
through :mod:`~graphmine_tpu_torch.ops._threefry`), made on the host so
every device starts from the same bits. The block's sparse product is a
fixed-order segment sum over the message CSR.
"""

from __future__ import annotations

import torch

from graphmine_tpu_torch.graph.container import Graph
from graphmine_tpu_torch.ops import _threefry
from graphmine_tpu_torch.ops.segment import SegmentSums


def spectral_embedding(graph: Graph, dim: int = 8, num_iters: int = 60,
                       seed: int = 0) -> torch.Tensor:
    """``[V, dim]`` float32 spectral coordinates (orthonormal columns,
    eigenvalue-ordered) of a symmetric graph; isolated vertices embed at
    the origin. Deterministic for ``seed``."""
    if not graph.symmetric:
        raise ValueError("spectral_embedding needs symmetric=True "
                         "(the normalized adjacency must be symmetric)")
    v, dev = graph.num_vertices, graph.device
    if dim + 1 > v:
        raise ValueError(
            f"dim={dim} needs at least dim+1={dim + 1} vertices (have {v}); "
            "lower dim for toy graphs"
        )
    send = graph.msg_send.to(torch.int64)
    b = dim + 1  # the extra lane absorbs leakage toward the deflated direction
    sums = SegmentSums(graph.msg_recv, v)
    deg = sums.sum(torch.ones(send.shape[0], dtype=torch.float32, device=dev))
    inv_sqrt = torch.where(deg > 0, 1.0 / torch.sqrt(torch.clamp(deg, min=1.0)),
                           torch.zeros_like(deg))
    triv = torch.sqrt(torch.clamp(deg, min=0.0))
    triv = triv / torch.clamp(torch.sqrt((triv * triv).sum()), min=1e-30)
    active = (deg > 0).to(torch.float32)[:, None]

    def matvec(x):  # M @ x with M = D^{-1/2} A D^{-1/2}
        return sums.sum((x * inv_sqrt[:, None])[send]) * inv_sqrt[:, None]

    def deflate(x):
        proj = triv @ x
        return (x - triv[:, None] * proj[None, :]) * active

    x0 = _threefry.normal(_threefry.PRNGKey(seed), (v, b)).to(dev)
    q = torch.linalg.qr(deflate(x0)).Q
    for _ in range(num_iters):
        # (M + I) / 2 has its spectrum in [0, 1]: the iteration converges
        # to the algebraically largest directions
        q = torch.linalg.qr(deflate(0.5 * (matvec(q) + q))).Q
    lam = (q * matvec(q)).sum(dim=0)
    order = torch.argsort(-lam, stable=True)
    return q[:, order[:dim]]
