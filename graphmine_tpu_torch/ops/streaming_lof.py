"""Streaming LOF: outlier scores for point streams too large for all-pairs
(PyTorch).

Counterpart of ``graphmine_tpu/ops/streaming_lof.py``. Each arriving chunk
is scored against a fixed-capacity reference *window*:

- **fit** (:func:`fit_lof`): kNN of the window against itself, giving each
  reference its k-distance and local reachability density (lrd), batch
  LOF's model state;
- **score** (:func:`score_lof`): chunk-against-window cross kNN
  (:func:`~graphmine_tpu_torch.ops.knn.cross_knn`), reachability against
  the window's k-distances, LOF(q) = mean lrd of q's reference neighbours
  / lrd(q), the reference-model LOF (sklearn's ``novelty=True``);
- **slide**: scored chunks enter the window ring-buffer style, evicting
  the oldest points; the model is re-fit on the padded window.

The window is a fixed ``[capacity, F]`` host buffer with a validity mask,
as in the JAX package. The kNN of the first chunk is
:func:`~graphmine_tpu_torch.ops.lof.lof_scores` (the hand-written
``knn_topk`` kernel on CUDA below the IVF crossover); the window's fits and
scores are the plain cross kNN, true float32 on every device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from graphmine_tpu_torch.device import resolve_device
from graphmine_tpu_torch.ops.knn import cross_knn


@dataclass(frozen=True)
class LOFModel:
    """Fitted reference-window state: points + mask + k-distance + lrd."""

    refs: torch.Tensor    # [M, F] padded reference points
    mask: torch.Tensor    # bool [M]: valid slots
    kdist: torch.Tensor   # [M] distance to the k-th neighbour (within window)
    lrd: torch.Tensor     # [M] local reachability density
    k: int = 20


def _reach_lrd(dists: torch.Tensor, idx: torch.Tensor, kdist: torch.Tensor,
               pos: torch.Tensor, k: int) -> torch.Tensor:
    """lrd from a kNN result: reach distances floored at 1e-3 x the mean
    positive kNN distance (the duplicate guard of batch LOF)."""
    eps = 1e-3 * torch.where(pos, dists, 0.0).sum() / torch.clamp(pos.sum(), min=1)
    reach = torch.maximum(torch.maximum(kdist[idx], dists), eps)
    return k / torch.clamp(reach.sum(dim=1), min=1e-12)


def fit_lof(refs: torch.Tensor, mask: torch.Tensor | None = None, k: int = 20,
            row_tile: int = 1024) -> LOFModel:
    """Fit the LOF reference model on a (possibly padded) point set.

    ``mask`` marks valid rows; invalid rows get zeroed model state and
    never act as neighbours. Needs at least ``k + 1`` valid points."""
    refs = refs.to(torch.float32)
    m = refs.shape[0]
    if mask is None:
        mask = torch.ones(m, dtype=torch.bool, device=refs.device)
    mask = mask.to(device=refs.device, dtype=torch.bool)
    # self-exclusion: k+1 within the window, column 0 dropped (the point
    # itself at distance 0; under duplicates any zero-distance column is
    # an equally valid self)
    d2, idx = cross_knn(refs, refs, k=k + 1, ref_mask=mask, row_tile=row_tile)
    d2, idx = d2[:, 1:], idx[:, 1:].to(torch.int64)
    dists = torch.sqrt(torch.clamp(d2, min=0.0))
    kdist = dists[:, -1]
    lrd = _reach_lrd(dists, idx, kdist, (dists > 0) & mask[:, None], k)
    return LOFModel(refs=refs, mask=mask, kdist=torch.where(mask, kdist, 0.0),
                    lrd=torch.where(mask, lrd, 0.0), k=k)


def _model_state_from_knn(d2: torch.Tensor, idx: torch.Tensor, k: int):
    """k-distance and lrd from a self-excluding kNN result ``[M, k]``: the
    :func:`fit_lof` formula for the IVF re-fit path."""
    idx = idx.to(torch.int64)
    dists = torch.sqrt(torch.clamp(d2, min=0.0))
    kdist = dists[:, -1]
    lrd = _reach_lrd(dists, idx, kdist, (dists > 0) & torch.isfinite(dists), k)
    return kdist, lrd


def score_lof(model: LOFModel, queries: torch.Tensor, row_tile: int = 1024) -> torch.Tensor:
    """LOF score per query against the fitted window (higher = outlier)."""
    d2, idx = cross_knn(queries, model.refs, k=model.k, ref_mask=model.mask,
                        row_tile=row_tile)
    idx = idx.to(torch.int64)
    dists = torch.sqrt(torch.clamp(d2, min=0.0))
    lrd_q = _reach_lrd(dists, idx, model.kdist, dists > 0, model.k)
    return model.lrd[idx].mean(dim=1) / torch.clamp(lrd_q, min=1e-12)


class StreamingLOF:
    """Sliding-window streaming LOF scorer on ``device`` (CUDA unless the
    caller names another).

    >>> s = StreamingLOF(k=20, capacity=4096, device="cpu")
    >>> for chunk in stream:            # chunks of [n_i, F] points
    ...     scores = s.update(chunk)    # scores, then admits the chunk

    Each chunk is scored against the current window, then written into the
    ring buffer (evicting the oldest points) and the model is re-fit.

    ``impl="ivf"``: the window re-fit, a ``[capacity, capacity]`` self-kNN
    every admitted chunk, goes through the IVF index
    (:func:`~graphmine_tpu_torch.ops.ann.ivf_knn`) with one reused set of
    k-means centers, trained on the first FULL window (earlier re-fits stay
    exact); ``ivf_retrain_every=N`` re-trains every N IVF re-fits (0 =
    once). Chunk scoring stays the exact cross kNN.
    """

    def __init__(self, k: int = 20, capacity: int = 4096,
                 admit_threshold: float | None = None, impl: str = "exact",
                 ivf_retrain_every: int = 0, sink=None, centers=None, device=None):
        """``admit_threshold``: points scoring above it are flagged but NOT
        admitted to the window. ``centers``: pre-trained float32 ``[C, F]``
        k-means centers for the IVF re-fit (a scorer resuming from a
        snapshot skips Lloyd); ignored under ``impl="exact"``."""
        if capacity <= k + 1:
            raise ValueError(f"capacity {capacity} must exceed k+1 = {k + 1}")
        if impl not in ("exact", "ivf"):
            raise ValueError(f"unknown impl {impl!r}; use 'exact' or 'ivf'")
        if ivf_retrain_every < 0:
            raise ValueError("ivf_retrain_every must be >= 0 (0 = once)")
        self.device = resolve_device(device)
        self.k = k
        self.capacity = capacity
        self.admit_threshold = admit_threshold
        self.impl = impl
        self.ivf_retrain_every = ivf_retrain_every
        self.ivf_retrains = 0  # k-means trainings performed
        self._sink = sink
        self._ivf_fits = 0     # re-fits that rode the index
        self._centers = None if centers is None else np.array(centers, np.float32)
        self._refs: np.ndarray | None = None  # [capacity, F] host ring buffer
        self._valid = 0
        self._write = 0
        self._model: LOFModel | None = None

    @property
    def fitted(self) -> bool:
        return self._model is not None

    def sync(self) -> None:
        """Wait for the card to finish the most recent re-fit (call after
        the last chunk when timing throughput)."""
        if self._model is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dev(self, arr) -> torch.Tensor:
        """A copy on the scorer's device (never a view of the ring buffer,
        which the next admit rewrites)."""
        return torch.tensor(np.asarray(arr), device=self.device)

    def update(self, chunk) -> np.ndarray:
        """Score ``chunk`` against the window, then admit it and re-fit.

        Returns ``[n]`` LOF scores. The first chunk bootstraps the window
        (at least ``k + 1`` points) and is scored in-window with the
        self-excluding batch formula; every later chunk is scored against
        the window as fitted before the chunk entered it."""
        chunk = np.asarray(chunk, dtype=np.float32)
        if chunk.ndim != 2:
            raise ValueError("chunk must be [n, features]")
        bootstrap = self._model is None
        if bootstrap:
            if len(chunk) < self.k + 1:
                raise ValueError(
                    f"first chunk needs >= k+1 = {self.k + 1} points, got {len(chunk)}"
                )
            from graphmine_tpu_torch.ops.lof import lof_scores

            scores = lof_scores(self._dev(chunk), k=self.k).cpu().numpy()
        else:
            scores = score_lof(self._model, self._dev(chunk)).cpu().numpy()
        admit = chunk
        if self.admit_threshold is not None:
            admit = chunk[scores <= self.admit_threshold]
        if bootstrap and len(admit) < self.k + 1:
            # raise before touching the window, so the caller can retry
            raise ValueError(
                f"admit_threshold leaves {len(admit)} bootstrap points; "
                f"need >= k+1 = {self.k + 1}"
            )
        if len(admit):
            if self._refs is None:
                self._refs = np.zeros((self.capacity, chunk.shape[1]), np.float32)
            self._admit(admit)
            self._fit()
        return scores

    def _fit(self) -> None:
        if self.impl == "ivf":
            self._fit_ivf()
        else:
            self._model = fit_lof(self._dev(self._refs), self._dev(self._mask()), k=self.k)

    def _fit_ivf(self) -> None:
        """Window re-fit through the IVF index with reused centers, sized
        for the FULL window (``~sqrt(capacity)`` clusters); until the
        window fills, re-fits take the exact path."""
        from graphmine_tpu_torch.ops.ann import default_n_clusters, ivf_knn, kmeans

        n_clusters = default_n_clusters(self.capacity)
        valid = self._valid
        if valid < self.capacity:
            self._model = fit_lof(self._dev(self._refs), self._dev(self._mask()), k=self.k)
            return
        pts = self._dev(self._refs[:valid])
        retrain = self._centers is None or (
            self.ivf_retrain_every and self._ivf_fits % self.ivf_retrain_every == 0
        )
        if retrain:
            self._centers = kmeans(pts, n_clusters, seed=0).cpu().numpy()
            self.ivf_retrains += 1
        self._ivf_fits += 1
        d2, idx = ivf_knn(pts, k=self.k, centers=self._centers, sink=self._sink)
        kdist, lrd = _model_state_from_knn(d2, idx, self.k)
        pad = self.capacity - valid
        self._model = LOFModel(
            refs=self._dev(self._refs), mask=self._dev(self._mask()),
            kdist=torch.nn.functional.pad(kdist, (0, pad)),
            lrd=torch.nn.functional.pad(lrd, (0, pad)), k=self.k,
        )

    def _mask(self) -> np.ndarray:
        mask = np.zeros(self.capacity, bool)
        mask[: self._valid] = True
        return mask

    def _admit(self, chunk: np.ndarray) -> None:
        take = chunk[-self.capacity:]  # only the newest fit in the window
        n = len(take)
        end = min(self._write + n, self.capacity)
        first = end - self._write
        self._refs[self._write:end] = take[:first]
        if first < n:
            self._refs[: n - first] = take[first:]
        self._write = (self._write + n) % self.capacity
        self._valid = min(self._valid + n, self.capacity)
