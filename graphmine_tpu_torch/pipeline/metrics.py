"""Structured metrics: one JSON record per pipeline event.

Counterpart of ``graphmine_tpu/pipeline/metrics.py::MetricsSink`` for what
the single-device slice emits: ``emit``, ``span``, ``timed``, ``records``
and ``of_phase``, with the record names ``counts``, ``communities``,
``outlier_summary``, ``impl_selected`` and each phase's ``seconds``.
Tracer identities, Prometheus export and the heartbeat wait for a later
slice.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from dataclasses import dataclass, field

log = logging.getLogger("graphmine_tpu_torch")


@dataclass
class MetricsSink:
    """Collects records in memory; ``stream_path`` also appends each one
    to that file as a JSON line when it is emitted."""

    records: list = field(default_factory=list)
    stream_path: str | None = None

    def emit(self, phase: str, **kv) -> dict:
        rec = {"phase": phase, "t": time.time(), **kv}
        line = json.dumps(rec, default=str)
        log.info("%s", line)
        self.records.append(rec)
        if self.stream_path is not None:
            with open(self.stream_path, "a") as f:
                f.write(line + "\n")
        return rec

    @contextlib.contextmanager
    def timed(self, phase: str, **kv):
        """Record ``phase`` with its wall ``seconds``; on failure the record
        says ``ok=false`` with the error, and the error propagates."""
        t0 = time.perf_counter()
        try:
            yield
        except BaseException as e:
            self.emit(phase, seconds=round(time.perf_counter() - t0, 4),
                      ok=False, error_detail=repr(e), **kv)
            raise
        self.emit(phase, seconds=round(time.perf_counter() - t0, 4), **kv)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """A ``span`` record with the block's wall seconds and status."""
        t0 = time.perf_counter()
        status = "ok"
        try:
            yield
        except BaseException:
            status = "error"
            raise
        finally:
            self.emit("span", name=name, seconds=round(time.perf_counter() - t0, 4),
                      status=status, **attrs)

    def of_phase(self, phase: str) -> list:
        return [r for r in self.records if r.get("phase") == phase]

    def phase_seconds(self) -> dict:
        """``{phase: seconds}`` of the timed phases (span records excluded)."""
        return {r["phase"]: r["seconds"] for r in self.records
                if "seconds" in r and r["phase"] not in ("span", "lpa_iter")}
