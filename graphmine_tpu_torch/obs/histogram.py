"""Bucket histograms: the latency-distribution surface of the registry.

Counterpart of ``graphmine_tpu/obs/histogram.py``: a fixed ladder of
upper bounds, one counter per bucket (the last is the +Inf overflow) and
a running sum under one lock. ``observe`` is one locked increment; a
scrape renders from one atomic :meth:`Histogram.snapshot`; two histograms
counter-wise sum into a fleet view. :class:`HistogramFamily` holds the labeled children of one
name for :class:`~graphmine_tpu_torch.obs.registry.Registry`. The
quality plane's sketches (:mod:`graphmine_tpu_torch.obs.sketch`) stand
on :class:`Histogram`.
"""

from __future__ import annotations

import bisect
import math
import threading
from dataclasses import dataclass

# Default bucket ladder for request/stage latencies in SECONDS. Denser
# than Prometheus's default at the microsecond end: in-process serving
# lookups resolve in 100us-1ms, and a ladder whose lowest bound is 5ms
# would dump the entire working distribution into one bucket.
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def format_bound(b: float) -> str:
    """Prometheus ``le`` label text: ``0.005``, ``1``, ``+Inf`` — one
    deterministic rendering so successive scrapes diff cleanly."""
    if math.isinf(b):
        return "+Inf"
    return repr(float(b))  # shortest round-trip repr: 0.00025, not 0.0002500…01


def _validated_bounds(buckets) -> tuple:
    """One owner for bucket-ladder validation: finite, strictly
    increasing, non-empty (both Histogram and HistogramFamily construct
    through here, so an invalid ladder can never half-register)."""
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
    """One atomic read of a histogram: finite upper bounds, one count
    per bucket (the LAST entry is the +Inf overflow bucket, so
    ``len(counts) == len(bounds) + 1``), running sum and total count."""

    bounds: tuple
    counts: tuple
    sum: float
    count: int

    def cumulative(self) -> list:
        """Cumulative counts per ``le`` bound (+Inf last) — the
        exposition shape; always monotone non-decreasing."""
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class Histogram:
    """One labeled bucket histogram (Prometheus semantics).

    ``labels`` distinguish siblings of one metric family (the serving
    layer keys request latency by ``endpoint``); the family owns the
    shared name/help/bucket ladder, this class owns one label-set's
    counters. Use :meth:`~graphmine_tpu_torch.obs.registry.Registry.histogram`
    to get one — direct construction is for tests and offline tooling.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_LATENCY_BUCKETS, labels: dict | None = None):
        bounds = _validated_bounds(buckets)
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf overflow
        self._sum = 0.0
        self._lock = threading.Lock()

    @property
    def bounds(self) -> tuple:
        return self._bounds

    def observe(self, value: float) -> None:
        """Record one observation: one bisect + one locked increment."""
        v = float(value)
        i = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v

    def snapshot(self) -> HistogramSnapshot:
        """One atomic read — the only way concurrent renderers see this
        histogram, so a mid-observe scrape can never tear sum vs count
        vs buckets apart."""
        with self._lock:
            return HistogramSnapshot(
                bounds=self._bounds, counts=tuple(self._counts),
                sum=self._sum, count=sum(self._counts),
            )

    # -- exposition --------------------------------------------------------
    def render_lines(self, extra_labels: dict | None = None) -> list:
        """Prometheus exposition sample lines (no HELP/TYPE — the family
        owns those): cumulative ``_bucket`` per ``le`` (+Inf last), then
        ``_sum`` and ``_count``. Rendered from ONE snapshot, so the
        scrape is internally consistent by construction."""
        snap = self.snapshot()
        labels = dict(extra_labels or {})
        labels.update(self.labels)

        def lab(le: str | None = None) -> str:
            parts = [
                '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
                for k, v in sorted(labels.items())
            ]
            if le is not None:
                parts.append(f'le="{le}"')
            return "{%s}" % ",".join(parts) if parts else ""

        lines = []
        cum = snap.cumulative()
        for b, c in zip(self._bounds, cum):
            lines.append(f"{self.name}_bucket{lab(format_bound(b))} {c}")
        lines.append(f"{self.name}_bucket{lab('+Inf')} {snap.count}")
        lines.append(f"{self.name}_sum{lab()} {snap.sum!r}")
        lines.append(f"{self.name}_count{lab()} {snap.count}")
        return lines


class HistogramFamily:
    """All label-sets of one histogram name: one shared HELP/TYPE and
    bucket ladder, one :class:`Histogram` child per label combination
    (``request_seconds{endpoint="query"}`` vs ``...{endpoint="vertex"}``).
    Lives in the registry's metric dict under the family name, so the
    one-name-one-TYPE rule holds across kinds."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=DEFAULT_LATENCY_BUCKETS):
        self.name = name
        self.help = help
        # Validate HERE, not lazily in the first child: a family that
        # raised out of the registry's get-or-create must never have
        # been inserted, or the bad ladder would poison the name for
        # every later (valid) call.
        self._bounds = _validated_bounds(buckets)
        self._children: dict = {}
        self._lock = threading.Lock()

    @property
    def bounds(self) -> tuple:
        return self._bounds

    def labels(self, **labels) -> Histogram:
        """Get-or-create the child for one label combination."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = Histogram(
                    self.name, self.help, self._bounds, labels=dict(labels)
                )
            return child

    def children(self) -> list:
        """Children sorted by label set — the deterministic exposition
        (and statusz) order."""
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]

    @property
    def value(self) -> int:
        """Total observations across children — what ``Registry.values``
        (and the heartbeat's gauge fold) reports for a histogram."""
        return sum(c.snapshot().count for c in self.children())
