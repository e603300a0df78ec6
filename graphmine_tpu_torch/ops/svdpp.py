"""SVD++ latent-factor model (GraphFrames ``svdPlusPlus`` parity), PyTorch.

Counterpart of ``graphmine_tpu/ops/svdpp.py``: rating prediction over a
bipartite (user → item) edge set,

    r̂(u, i) = μ + b_u + b_i + q_iᵀ (p_u + |N(u)|^-½ Σ_{j∈N(u)} y_j)

trained by full-batch gradient descent with the gradients written out
(each epoch two gathers, per-user and per-item segment sums, dense
``[V, rank]`` updates). The factors start from the JAX package's seeded
draw (``jax.random.normal`` of three split keys, through
:mod:`~graphmine_tpu_torch.ops._threefry`, on the host); ``init=`` takes
a model instead, so both packages can start from the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.ops import _threefry
from graphmine_tpu_torch.ops.segment import SegmentSums

__all__ = ["SVDPlusPlusModel", "svd_plus_plus", "svdpp_predict"]


@dataclass
class SVDPlusPlusModel:
    """Learned parameters, indexed by vertex id: ``p``/``q``/``y`` user,
    item and implicit-feedback factors ``[V, rank]``; ``bu``/``bi`` biases
    ``[V]``; ``mu`` the global mean rating (a float32 scalar tensor)."""

    p: torch.Tensor
    q: torch.Tensor
    y: torch.Tensor
    bu: torch.Tensor
    bi: torch.Tensor
    mu: torch.Tensor

    @classmethod
    def from_numpy(cls, p, q, y, bu, bi, mu, device=None) -> "SVDPlusPlusModel":
        """A model from host arrays (another package's model carried
        across), as float32 tensors on ``device`` (CUDA unless named)."""
        dev = resolve_device(device)
        t = lambda a: torch.as_tensor(np.array(a, np.float32), device=dev)
        return cls(t(p), t(q), t(y), t(bu), t(bi), t(mu))

    def to(self, device) -> "SVDPlusPlusModel":
        return SVDPlusPlusModel(*(getattr(self, f).to(device)
                                  for f in ("p", "q", "y", "bu", "bi", "mu")))


def _implicit(p, y, by_user: SegmentSums, dst, norm):
    """z_u = p_u + |N(u)|^-½ Σ_{j∈N(u)} y_j."""
    return p + by_user.sum(y[dst]) * norm[:, None]


def _seeded_init(v: int, rank: int, mu, seed: int, device) -> SVDPlusPlusModel:
    """The JAX package's starting model: three normal draws from
    ``split(PRNGKey(seed), 3)`` scaled by ``0.1 / sqrt(rank)``, zero
    biases."""
    keys = _threefry.split(_threefry.PRNGKey(seed), 3)
    scale = np.float32(0.1) / np.sqrt(np.float32(rank))
    draw = lambda k: (_threefry.normal(k, (v, rank)) * scale).to(device)
    zeros = torch.zeros(v, dtype=torch.float32, device=device)
    return SVDPlusPlusModel(draw(keys[0]), draw(keys[1]), draw(keys[2]), zeros,
                            zeros.clone(), mu)


def svd_plus_plus(src, dst, ratings, num_vertices: int, rank: int = 10, max_iter: int = 20,
                  lr_bias: float = 0.5, lr_factor: float = 0.5, reg_bias: float = 0.05,
                  reg_factor: float = 0.05, min_val: float = 0.0, max_val: float = 5.0,
                  seed: int = 0, device=None, init: SVDPlusPlusModel | None = None):
    """Train SVD++ on rating edges ``(src=user, dst=item, rating)`` on
    ``device`` (CUDA unless named; a tensor input's device otherwise).

    Returns ``(model, rmse_history)``: ``rmse_history[t]`` is the training
    RMSE at the start of epoch ``t``. The names mirror GraphX's ``Conf``
    (gamma1/gamma2/lambda1/lambda2 are lr_bias/lr_factor/reg_bias/
    reg_factor). ``init``: a starting model in place of the seeded draw
    (its ``mu`` is kept), a seam for holding this package against another
    from the same bits.
    """
    if device is None and torch.is_tensor(src):
        device = src.device
    dev = resolve_device(device)
    as_idx = lambda a: torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a) else a,
                                                  np.int64), device=dev)
    src, dst = as_idx(src), as_idx(dst)
    ratings = torch.as_tensor(
        np.asarray(ratings.cpu() if torch.is_tensor(ratings) else ratings, np.float32),
        device=dev)
    v, e = int(num_vertices), src.shape[0]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    by_user, by_item = SegmentSums(src, v), SegmentSums(dst, v)
    ones = torch.ones(e, dtype=torch.float32, device=dev)
    deg_u, deg_i = by_user.sum(ones), by_item.sum(ones)
    zero = torch.zeros(v, dtype=torch.float32, device=dev)
    inv_u = torch.where(deg_u > 0, 1.0 / torch.clamp(deg_u, min=1.0), zero)
    inv_i = torch.where(deg_i > 0, 1.0 / torch.clamp(deg_i, min=1.0), zero)
    norm = torch.where(deg_u > 0, torch.rsqrt(torch.clamp(deg_u, min=1.0)), zero)
    if init is None:
        m = _seeded_init(v, rank, ratings.mean(), seed, dev)
    else:
        m = init.to(dev)
    lr_b, lr_f, reg_b, reg_f = f32(lr_bias), f32(lr_factor), f32(reg_bias), f32(reg_factor)
    lo, hi = f32(min_val), f32(max_val)
    un = norm * inv_u
    rmse = []
    for _ in range(max_iter):
        z = _implicit(m.p, m.y, by_user, dst, norm)
        pred = m.mu + m.bu[src] + m.bi[dst] + (m.q[dst] * z[src]).sum(dim=1)
        err = ratings - torch.clamp(pred, lo, hi)
        rmse.append(torch.sqrt((err * err).mean()))
        bu = m.bu + lr_b * (by_user.sum(err) * inv_u - reg_b * m.bu)
        bi = m.bi + lr_b * (by_item.sum(err) * inv_i - reg_b * m.bi)
        q = m.q + lr_f * (by_item.sum(err[:, None] * z[src]) * inv_i[:, None] - reg_f * m.q)
        qe = err[:, None] * m.q[dst]
        p = m.p + lr_f * (by_user.sum(qe) * inv_u[:, None] - reg_f * m.p)
        # y_j's gradient: t_u = Σ_i err q_i per user, scattered back to the
        # user's items through the same edges
        t = by_user.sum(qe)
        y_grad = by_item.sum(un[src, None] * t[src]) * inv_i[:, None]
        y = m.y + lr_f * (y_grad - reg_f * m.y)
        m = SVDPlusPlusModel(p, q, y, bu, bi, m.mu)
    hist = torch.stack(rmse) if rmse else torch.zeros(0, dtype=torch.float32, device=dev)
    return m, hist


def svdpp_predict(model: SVDPlusPlusModel, src, dst, train_src, train_dst,
                  min_val: float | None = 0.0, max_val: float | None = 5.0) -> torch.Tensor:
    """Predicted ratings for query pairs on the model's device;
    ``train_*`` define N(u). Clipped to ``[min_val, max_val]`` (``None``
    drops a bound)."""
    dev = model.p.device
    as_idx = lambda a: torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a) else a,
                                                  np.int64), device=dev)
    src, dst, train_src, train_dst = map(as_idx, (src, dst, train_src, train_dst))
    v = model.p.shape[0]
    by_user = SegmentSums(train_src, v)
    deg_u = by_user.sum(torch.ones(train_src.shape[0], dtype=torch.float32, device=dev))
    norm = torch.where(deg_u > 0, torch.rsqrt(torch.clamp(deg_u, min=1.0)),
                       torch.zeros_like(deg_u))
    z = _implicit(model.p, model.y, by_user, train_dst, norm)
    out = model.mu + model.bu[src] + model.bi[dst] + (model.q[dst] * z[src]).sum(dim=1)
    if min_val is not None or max_val is not None:
        out = torch.clamp(out, min_val, max_val)
    return out
