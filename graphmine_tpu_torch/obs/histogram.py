"""Bucket histograms over a fixed ladder of upper bounds.

Counterpart of the part of ``Histogram`` in
``graphmine_tpu/obs/histogram.py`` that the quality plane's sketches
stand on: a validated ladder, counts per bucket (the last is the +Inf
overflow) and a running sum under one lock, read in one atomic
``snapshot``. Observing, merging, quantiles, the registry families and
the Prometheus rendering wait for the observability slice (ROADMAP.md).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass


def _validated_bounds(buckets) -> tuple:
    """Finite, strictly increasing, non-empty bucket bounds."""
    bounds = tuple(float(b) for b in buckets)
    if not bounds:
        raise ValueError("histogram needs at least one bucket bound")
    if any(math.isinf(b) or math.isnan(b) for b in bounds):
        raise ValueError("bucket bounds must be finite (+Inf is implicit)")
    if any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
        raise ValueError("bucket bounds must be strictly increasing")
    return bounds


@dataclass(frozen=True)
class HistogramSnapshot:
    """One atomic read: the finite upper bounds, one count per bucket
    (the last is the +Inf overflow, so ``len(counts) == len(bounds) + 1``),
    the running sum and the total count."""

    bounds: tuple
    counts: tuple
    sum: float
    count: int


class Histogram:
    """One bucket histogram (Prometheus semantics)."""

    def __init__(self, name: str, help: str = "", buckets=(1.0,), labels: dict | None = None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._bounds = _validated_bounds(buckets)
        self._counts = [0] * (len(self._bounds) + 1)  # +1: the +Inf overflow
        self._sum = 0.0
        self._lock = threading.Lock()

    @property
    def bounds(self) -> tuple:
        return self._bounds

    def snapshot(self) -> HistogramSnapshot:
        with self._lock:
            return HistogramSnapshot(bounds=self._bounds, counts=tuple(self._counts),
                                     sum=self._sum, count=sum(self._counts))
