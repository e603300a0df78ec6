"""Result-quality observability: snapshot quality state, drift, canary.

Counterpart of ``graphmine_tpu/obs/quality.py``, run at every snapshot
publish:

- :class:`QualityState`: one snapshot's result distributions: the LOF
  score sketch and the community-size sketch, the anomaly rate (share of
  scores above the threshold) and census scalars;
- :func:`quality_drift`: snapshot-over-parent drift: the churned-vertex
  fraction (matched by partition, so renumbered labels do not read as
  churn), new and dissolved communities, PSI drift of both sketches, the
  anomaly-rate delta;
- :class:`CanaryProbe`: a seeded planted-anomaly probe (features frozen
  in the snapshot) re-scored through the port's LOF scorer on the run's
  device at every publish, so a recall drop is the scorer moving;
- :func:`run_quality_pass`: computes all of it, emits the
  ``quality_snapshot``, ``quality_drift`` and ``canary_score`` records
  and mirrors the headline numbers into a registry's gauges
  (:func:`export_gauges`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from graphmine_tpu_torch.obs.sketch import (
    DEFAULT_SCORE_LADDER,
    DEFAULT_SIZE_LADDER,
    QuantileSketch,
    env_float,
    psi_distance,
)

# Share of vertices with LOF above this is the anomaly rate (the pipeline
# reports LOF > 1.5 as its flagged count).
DEFAULT_LOF_THRESHOLD = 1.5

# Snapshot arrays of the canary probe, and its manifest key.
CANARY_ARRAYS = ("canary_features", "canary_is_anomaly")
CANARY_META_KEY = "canary"


def lof_threshold() -> float:
    """``$GRAPHMINE_QUALITY_LOF_THRESHOLD``, else 1.5; malformed raises."""
    return env_float("GRAPHMINE_QUALITY_LOF_THRESHOLD", DEFAULT_LOF_THRESHOLD)


def sketch_of(values, ladder, name: str = "sketch") -> QuantileSketch:
    """A sketch of a host array, binned in one vectorized pass."""
    sk = QuantileSketch(name=name, buckets=ladder)
    vals = np.asarray(values, np.float64).reshape(-1)
    if not len(vals):
        return sk
    bounds = np.asarray(sk.bounds, np.float64)
    idx = np.searchsorted(bounds, vals, side="left")
    counts = np.bincount(idx, minlength=len(bounds) + 1)
    sk.add_counts(counts.tolist(), total=float(vals.sum()))
    return sk


@dataclass
class QualityState:
    """The result-quality observables of one published snapshot."""

    version: int = 0
    num_vertices: int = 0
    num_communities: int = 0
    largest_community: int = 0
    anomaly_count: int = 0
    anomaly_rate: float = 0.0
    threshold: float = DEFAULT_LOF_THRESHOLD
    lof_sketch: QuantileSketch = field(
        default_factory=lambda: QuantileSketch("lof_score", buckets=DEFAULT_SCORE_LADDER))
    size_sketch: QuantileSketch = field(
        default_factory=lambda: QuantileSketch("community_size", buckets=DEFAULT_SIZE_LADDER))

    @classmethod
    def from_arrays(cls, labels, lof=None, version: int = 0,
                    threshold: float | None = None) -> "QualityState":
        """The state of host label and score columns: one bincount for the
        census, one binning pass a sketch."""
        labels = np.asarray(labels).reshape(-1)
        thr = lof_threshold() if threshold is None else float(threshold)
        sizes = np.bincount(labels.astype(np.int64))
        sizes = sizes[sizes > 0]
        lof_arr = (np.zeros(0, np.float32) if lof is None
                   else np.asarray(lof, np.float32).reshape(-1))
        n_anom = int((lof_arr > thr).sum())
        return cls(
            version=int(version),
            num_vertices=int(len(labels)),
            num_communities=int(len(sizes)),
            largest_community=int(sizes.max()) if len(sizes) else 0,
            anomaly_count=n_anom,
            anomaly_rate=round(n_anom / len(lof_arr), 6) if len(lof_arr) else 0.0,
            threshold=thr,
            lof_sketch=sketch_of(lof_arr, DEFAULT_SCORE_LADDER, "lof_score"),
            size_sketch=sketch_of(sizes, DEFAULT_SIZE_LADDER, "community_size"),
        )

    def payload(self) -> dict:
        """The ``quality_snapshot`` record body: scalars and both sketches."""
        return {
            "version": self.version,
            "num_vertices": self.num_vertices,
            "num_communities": self.num_communities,
            "largest_community": self.largest_community,
            "anomaly_count": self.anomaly_count,
            "anomaly_rate": self.anomaly_rate,
            "lof_threshold": self.threshold,
            "lof_sketch": self.lof_sketch.to_state(),
            "size_sketch": self.size_sketch.to_state(),
        }


def partition_churn(parent_labels, labels) -> float:
    """Churned-vertex fraction over the common vertex prefix: each child
    community is matched to the parent community it overlaps most, and
    ``churn = 1 - (sum of those overlaps) / V``; 0.0 for partitions equal
    up to renaming."""
    parent = np.asarray(parent_labels).reshape(-1)
    child = np.asarray(labels).reshape(-1)
    n = min(len(parent), len(child))
    if n == 0:
        return 0.0
    parent, child = parent[:n].astype(np.int64), child[:n].astype(np.int64)
    pair = np.stack([child, parent], axis=1)
    uniq, counts = np.unique(pair, axis=0, return_counts=True)
    order = np.lexsort((-counts, uniq[:, 0]))
    uniq, counts = uniq[order], counts[order]
    first = np.ones(len(uniq), bool)
    first[1:] = uniq[1:, 0] != uniq[:-1, 0]
    matched = int(counts[first].sum())
    return round(1.0 - matched / n, 6)


def _label_sets(parent_labels, labels):
    """(new, dissolved) community-id counts by raw id set difference."""
    p = np.unique(np.asarray(parent_labels).reshape(-1))
    c = np.unique(np.asarray(labels).reshape(-1))
    new = int(len(np.setdiff1d(c, p, assume_unique=True)))
    dissolved = int(len(np.setdiff1d(p, c, assume_unique=True)))
    return new, dissolved


def quality_drift(parent: QualityState, state: QualityState, parent_labels, labels) -> dict:
    """The ``quality_drift`` record body."""
    new, dissolved = _label_sets(parent_labels, labels)
    return {
        "version": state.version,
        "parent_version": parent.version,
        "churn_frac": partition_churn(parent_labels, labels),
        "new_communities": new,
        "dissolved_communities": dissolved,
        "lof_psi": round(psi_distance(parent.lof_sketch, state.lof_sketch), 6),
        "size_psi": round(psi_distance(parent.size_sketch, state.size_sketch), 6),
        "anomaly_rate": state.anomaly_rate,
        "anomaly_rate_delta": round(state.anomaly_rate - parent.anomaly_rate, 6),
    }


# ---- canary probe ----------------------------------------------------------


def _probe_features(src, dst, comm, num_vertices: int):
    """Standardized structural features of the probe graph, computed once
    with NumPy: log degree, log distinct partners, log mean partner
    degree, cross-community partner share."""
    es = np.concatenate([src, dst]).astype(np.int64)
    ed = np.concatenate([dst, src]).astype(np.int64)
    deg = np.bincount(es, minlength=num_vertices).astype(np.float64)
    pair = es * num_vertices + ed
    uniq = np.unique(pair)
    distinct = np.bincount(uniq // num_vertices, minlength=num_vertices).astype(np.float64)
    nbr_deg_sum = np.bincount(es, weights=deg[ed], minlength=num_vertices)
    mean_nbr_deg = nbr_deg_sum / np.maximum(deg, 1.0)
    cross = np.bincount(es, weights=(comm[es] != comm[ed]).astype(np.float64),
                        minlength=num_vertices) / np.maximum(deg, 1.0)
    feats = np.stack([np.log1p(deg), np.log1p(distinct), np.log1p(mean_nbr_deg), cross], axis=1)
    mu = feats.mean(axis=0)
    sd = feats.std(axis=0)
    sd[sd == 0] = 1.0
    return ((feats - mu) / sd).astype(np.float32)


@dataclass
class CanaryProbe:
    """A frozen planted-anomaly probe, re-scored at every publish.

    ``features`` [N, d] and ``is_anomaly`` [N] are generated once from a
    seed and persisted in the snapshot (arrays :data:`CANARY_ARRAYS`,
    parameters under :data:`CANARY_META_KEY`), so every publish of a store
    scores the same probe; the same seed gives the JAX package's probe."""

    features: object          # np.ndarray [N, d] float32
    is_anomaly: object        # np.ndarray [N] bool
    k: int = 16
    recall_k: int = 0         # 0: twice the number of planted anomalies
    seed: int = 0

    @property
    def num_anomalies(self) -> int:
        return int(np.asarray(self.is_anomaly).sum())

    def _recall_k(self) -> int:
        return int(self.recall_k) if self.recall_k else 2 * self.num_anomalies

    @classmethod
    def generate(cls, seed: int = 0, num_vertices: int = 384, num_anomalies: int = 6,
                 edges_per_vertex: int = 8, edges_per_anomaly: int = 48,
                 k: int = 16, recall_k: int = 0) -> "CanaryProbe":
        """A small planted-community graph with injected hubs, reduced to
        a frozen feature matrix; deterministic per seed."""
        from graphmine_tpu_torch.datasets import planted_anomaly_graph

        src, dst, is_anomaly, comm = planted_anomaly_graph(
            num_vertices, num_vertices * edges_per_vertex,
            n_communities=max(8, num_vertices // 48), num_anomalies=num_anomalies,
            edges_per_anomaly=edges_per_anomaly, seed=seed,
        )
        feats = _probe_features(src, dst, comm, num_vertices)
        return cls(features=feats, is_anomaly=is_anomaly, k=k, recall_k=recall_k, seed=seed)

    def arrays(self) -> dict:
        """The snapshot arrays a publish attaches."""
        return {"canary_features": np.asarray(self.features, np.float32),
                "canary_is_anomaly": np.asarray(self.is_anomaly, np.uint8)}

    def meta(self) -> dict:
        """The manifest entry (under :data:`CANARY_META_KEY`)."""
        return {"seed": int(self.seed), "k": int(self.k), "recall_k": self._recall_k()}

    @classmethod
    def from_arrays(cls, arrays: dict, meta: dict) -> "CanaryProbe | None":
        """The probe of a raw array dict and manifest meta; None when they
        carry none."""
        feats = arrays.get("canary_features")
        mask = arrays.get("canary_is_anomaly")
        if feats is None or mask is None:
            return None
        probe_meta = (meta or {}).get(CANARY_META_KEY) or {}
        return cls(features=np.asarray(feats, np.float32),
                   is_anomaly=np.asarray(mask).astype(bool),
                   k=int(probe_meta.get("k", 16)),
                   recall_k=int(probe_meta.get("recall_k", 0)),
                   seed=int(probe_meta.get("seed", 0)))

    def score(self, sink=None, device="cuda") -> dict:
        """Re-score the probe through :func:`~graphmine_tpu_torch.ops.lof.lof_scores`
        on ``device`` and rank the planted anomalies: the ``canary_score``
        record body (``recall_at_k``: share of planted anomalies among the
        ``recall_k`` highest scores; ``mean_rank_frac``: their mean rank
        over N - 1). The ``canary_probe`` fault point sits between scoring
        and ranking."""
        import torch

        from graphmine_tpu_torch.ops.lof import lof_scores
        from graphmine_tpu_torch.pipeline import resilience

        t0 = time.perf_counter()
        feats = torch.from_numpy(np.asarray(self.features, np.float32)).to(device)
        scores = lof_scores(feats, k=min(self.k, len(feats) - 2), sink=sink).cpu().numpy()
        state = {"scores": scores}
        resilience.fault_point("canary_probe", state=state)
        scores = np.asarray(state["scores"])

        mask = np.asarray(self.is_anomaly).astype(bool)
        n = len(scores)
        order = np.argsort(-scores, kind="stable")
        rank = np.empty(n, np.int64)
        rank[order] = np.arange(n)
        k_eff = min(self._recall_k(), n)
        anom_ranks = rank[mask]
        n_anom = int(mask.sum())
        recall = round(float((anom_ranks < k_eff).sum()) / n_anom, 6) if n_anom else 1.0
        return {
            "recall_at_k": recall,
            "recall_k": k_eff,
            "mean_rank_frac": (round(float(anom_ranks.mean()) / max(1, n - 1), 6)
                               if n_anom else 0.0),
            "num_anomalies": n_anom,
            "num_probe_vertices": n,
            "k": int(self.k),
            "seconds": round(time.perf_counter() - t0, 4),
        }


@dataclass
class QualityReport:
    """One publish's quality pass: the state and any drift or canary."""

    state: QualityState
    drift: dict | None = None
    canary: dict | None = None
    seconds: float = 0.0

    def payload(self) -> dict:
        """The "quality" section of ``/statusz`` and ``/alertz``."""
        out = {"state": self.state.payload(), "seconds": self.seconds}
        if self.drift is not None:
            out["drift"] = self.drift
        if self.canary is not None:
            out["canary"] = self.canary
        return out

    def values(self) -> dict:
        """The flat metric dict the alert rules evaluate over."""
        out = {"quality_anomaly_rate": self.state.anomaly_rate,
               "quality_num_communities": self.state.num_communities}
        if self.drift is not None:
            out.update({"quality_lof_psi": self.drift["lof_psi"],
                        "quality_size_psi": self.drift["size_psi"],
                        "quality_churn_frac": self.drift["churn_frac"]})
        if self.canary is not None:
            out["canary_recall"] = self.canary["recall_at_k"]
        return out


def export_gauges(registry, state: QualityState, drift: dict | None = None,
                  canary: dict | None = None) -> None:
    """Mirror the quality headline numbers into the registry's gauges,
    under the JAX package's series names."""
    g = registry.gauge
    g("graphmine_quality_anomaly_rate",
      "share of LOF scores above the anomaly threshold").set(state.anomaly_rate)
    g("graphmine_quality_num_communities",
      "present communities in the served snapshot").set(state.num_communities)
    if drift is not None:
        g("graphmine_quality_churn_frac",
          "partition-matched churned-vertex fraction vs parent").set(drift["churn_frac"])
        g("graphmine_quality_lof_psi",
          "PSI drift of the LOF score distribution vs parent").set(drift["lof_psi"])
        g("graphmine_quality_size_psi",
          "PSI drift of the community-size distribution vs parent").set(drift["size_psi"])
    if canary is not None:
        g("graphmine_quality_canary_recall",
          "planted-anomaly recall@k of the canary probe, last publish",
          ).set(canary["recall_at_k"])


def run_quality_pass(labels, lof, version: int, parent_labels=None, parent_lof=None,
                     parent_version: int | None = None,
                     parent_state: QualityState | None = None,
                     canary: CanaryProbe | None = None, threshold: float | None = None,
                     sink=None, device="cuda", registry=None) -> QualityReport:
    """The publish-time quality pass: the state of the published columns,
    the drift against a parent (``parent_labels``, with ``parent_state``
    or ``parent_lof``), the canary's score on ``device``, the
    ``quality_snapshot`` / ``quality_drift`` / ``canary_score`` records and
    the gauges of ``registry``. A failure while emitting the records or
    the gauges is swallowed: telemetry must not fail a publish."""
    t0 = time.perf_counter()
    state = QualityState.from_arrays(labels, lof, version=version, threshold=threshold)
    drift = None
    if parent_labels is not None:
        if parent_state is None:
            parent_state = QualityState.from_arrays(
                parent_labels, parent_lof,
                version=version - 1 if parent_version is None else parent_version,
                threshold=threshold,
            )
        drift = quality_drift(parent_state, state, parent_labels, labels)
    canary_out = canary.score(sink=sink, device=device) if canary is not None else None
    seconds = round(time.perf_counter() - t0, 4)
    report = QualityReport(state=state, drift=drift, canary=canary_out, seconds=seconds)
    try:
        if sink is not None:
            sink.emit("quality_snapshot", seconds=seconds, **state.payload())
            if drift is not None:
                sink.emit("quality_drift", **drift)
            if canary_out is not None:
                sink.emit("canary_score", version=state.version, **canary_out)
        if registry is not None:
            export_gauges(registry, report.state, report.drift, report.canary)
    except Exception:  # noqa: BLE001 — telemetry must not fail a publish
        pass
    return report
