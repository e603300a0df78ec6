"""Counter/gauge registry + Prometheus textfile exporter.

Counterpart of ``graphmine_tpu/obs/registry.py``, with the same series
names and the same textfile format. The JSONL record stream
(:class:`~graphmine_tpu_torch.pipeline.metrics.MetricsSink`) is the event
surface; this is the level surface: monotonic counters and last-value
gauges a scrape reads without replaying the event log. The heartbeat folds
a :meth:`Registry.values` snapshot into each ``heartbeat`` record, and
:meth:`Registry.write_textfile` renders the Prometheus textfile-collector
format atomically (tmp + ``os.replace``). Thread-safe: one registry lock.
"""

from __future__ import annotations

import os
import re
import threading

from graphmine_tpu_torch.obs.histogram import (
    DEFAULT_LATENCY_BUCKETS,
    Histogram,
    HistogramFamily,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


class _Metric:
    __slots__ = ("name", "help", "kind", "_value", "_lock")

    def __init__(self, name: str, help: str, kind: str):
        self.name = name
        self.help = help
        self.kind = kind
        self._value = 0.0
        self._lock = threading.Lock()

    @property
    def value(self):
        with self._lock:
            v = self._value
        return int(v) if float(v).is_integer() else v


class Counter(_Metric):
    """Monotonic event count. ``inc`` only — a counter that can go down
    is a gauge wearing the wrong TYPE line."""

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help, "counter")

    def inc(self, n: float = 1) -> None:
        if n < 0:
            raise ValueError("counters only increase; use a Gauge")
        with self._lock:
            self._value += n


class Gauge(_Metric):
    """Last-observed value (current superstep, devices alive, RSS).
    ``labels`` distinguish siblings of one :class:`GaugeFamily`
    (per-shard gauges); an unlabeled gauge has an empty dict
    and renders exactly as before."""

    __slots__ = ("labels",)

    def __init__(self, name: str, help: str = "", labels: dict | None = None):
        super().__init__(name, help, "gauge")
        self.labels = dict(labels or {})

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self._value += n


class GaugeFamily:
    """All label-sets of one gauge name: one shared HELP/TYPE line, one
    :class:`Gauge` child per label combination — the shape the sharded
    write plane's per-shard WAL gauges need
    (``graphmine_serve_wal_pending_entries{shard="2"}``): one unlabeled
    gauge would silently fold a dead shard's backlog into healthy
    ranges. Mirrors :class:`~graphmine_tpu_torch.obs.histogram.HistogramFamily`
    so the one-name-one-TYPE registry rule holds across kinds."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._children: dict = {}
        self._lock = threading.Lock()

    def labels(self, **labels) -> Gauge:
        """Get-or-create the child for one label combination."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = Gauge(
                    self.name, self.help, labels=dict(labels)
                )
            return child

    def children(self) -> list:
        """Children sorted by label set — deterministic exposition order."""
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]

    @property
    def value(self):
        """Sum across children — what ``Registry.values`` (and the
        heartbeat's gauge fold) reports for a labeled family. For the
        WAL backlog gauges the sum IS the whole-plane total; per-shard
        values live in the exposition lines."""
        return sum(c.value for c in self.children())


class Registry:
    """Get-or-create metric registry. Re-requesting a name returns the
    same object; re-requesting it as a different kind raises (one name,
    one TYPE — Prometheus scrapers reject anything else)."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def _get(self, name: str, help: str, cls):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid metric name {name!r} (want [a-zA-Z_:][a-zA-Z0-9_:]*)"
            )
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, help, Counter)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        """Get-or-create a gauge. With ``labels``
        (``registry.gauge("wal_pending", shard="2")``) the name becomes
        a :class:`GaugeFamily` and the labeled child is returned; a name
        must stay labeled or unlabeled for its lifetime (mixing would
        emit duplicate series under one TYPE line)."""
        if not labels:
            return self._get(name, help, Gauge)
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid metric name {name!r} (want [a-zA-Z_:][a-zA-Z0-9_:]*)"
            )
        with self._lock:
            fam = self._metrics.get(name)
            if fam is None:
                fam = self._metrics[name] = GaugeFamily(name, help)
            elif not isinstance(fam, GaugeFamily):
                raise ValueError(
                    f"metric {name!r} already registered as an unlabeled "
                    f"{fam.kind}; one name is one shape"
                )
        return fam.labels(**labels)

    def histogram(
        self, name: str, help: str = "", buckets=None, **labels
    ) -> Histogram:
        """Get-or-create one labeled child of the ``name`` histogram
        family (``registry.histogram("req_seconds", endpoint="query")``).
        The first call fixes the family's bucket ladder (default
        :data:`~graphmine_tpu_torch.obs.histogram.DEFAULT_LATENCY_BUCKETS`); a
        later call naming a *different* ladder raises — merged/scraped
        buckets must be one ladder per name, same as one TYPE per name.
        """
        if not _NAME_RE.match(name):
            raise ValueError(
                f"invalid metric name {name!r} (want [a-zA-Z_:][a-zA-Z0-9_:]*)"
            )
        with self._lock:
            fam = self._metrics.get(name)
            if fam is None:
                fam = self._metrics[name] = HistogramFamily(
                    name, help,
                    DEFAULT_LATENCY_BUCKETS if buckets is None else buckets,
                )
            elif not isinstance(fam, HistogramFamily):
                raise ValueError(
                    f"metric {name!r} already registered as {fam.kind}"
                )
            elif buckets is not None and tuple(
                float(b) for b in buckets
            ) != fam.bounds:
                raise ValueError(
                    f"histogram {name!r} already registered with a "
                    "different bucket ladder"
                )
        return fam.labels(**labels)

    def histogram_family(self, name: str) -> HistogramFamily | None:
        """The registered family (all labeled children) or None: how the
        server's ``/statusz`` walks every endpoint's latency histogram."""
        with self._lock:
            fam = self._metrics.get(name)
        return fam if isinstance(fam, HistogramFamily) else None

    def values(self) -> dict:
        """Snapshot of every metric's current value, name-keyed."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: m.value for m in metrics}

    def render_textfile(self, labels: dict | None = None) -> str:
        """Prometheus text exposition, **deterministically ordered** —
        metrics sorted by name, histogram children by label set, label
        keys within a sample alphabetically — so two scrapes of the same
        state are byte-identical and successive scrapes diff cleanly.
        Every metric gets a ``# TYPE`` line (``# HELP`` when help text
        was registered). ``labels`` (e.g. ``{"run_id": ...}``) attach to
        every sample so a scrape distinguishes runs sharing one textfile
        directory. Histograms render per labeled child: cumulative
        ``_bucket`` samples (``le`` ascending, ``+Inf`` last), ``_sum``,
        ``_count`` — each child from one atomic snapshot, so a scrape
        concurrent with ``observe`` is never torn."""
        lab = ""
        if labels:
            parts = ",".join(
                '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
                for k, v in sorted(labels.items())
            )
            lab = "{%s}" % parts
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines = []
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, HistogramFamily):
                for child in m.children():
                    lines.extend(child.render_lines(extra_labels=labels))
            elif isinstance(m, GaugeFamily):
                for child in m.children():
                    merged = dict(labels or {})
                    merged.update(child.labels)
                    parts = ",".join(
                        '%s="%s"' % (
                            k,
                            str(v).replace("\\", "\\\\").replace('"', '\\"'),
                        )
                        for k, v in sorted(merged.items())
                    )
                    lines.append(
                        f"{m.name}{{{parts}}} {child.value}"
                        if parts else f"{m.name} {child.value}"
                    )
            else:
                lines.append(f"{m.name}{lab} {m.value}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_textfile(self, path: str, labels: dict | None = None) -> str:
        """Atomically publish :meth:`render_textfile` at ``path`` — the
        node_exporter textfile collector reads whole files, so a torn
        write mid-scrape must be impossible (tmp + ``os.replace``)."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.render_textfile(labels))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return path
