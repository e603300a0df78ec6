"""Structured metrics and the profiler hook.

Counterpart of ``graphmine_tpu/pipeline/metrics.py``: every pipeline
phase emits a structured JSON record, and LPA reports edges/sec/chip per
superstep. A sink constructed with a
:class:`~graphmine_tpu_torch.obs.spans.Tracer` stamps every record with
``run_id`` / ``trace_id`` / ``span_id`` / ``span_path``, so the retry /
degrade / tripwire / checkpoint records join into one causal timeline.
The sink also owns a counter/gauge
:class:`~graphmine_tpu_torch.obs.registry.Registry`, which the heartbeat
and the Prometheus textfile read. :func:`maybe_profile` wraps a phase in
``torch.profiler`` and writes a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field

from graphmine_tpu_torch.obs.registry import Registry
from graphmine_tpu_torch.obs.spans import profiler_annotation

log = logging.getLogger("graphmine_tpu_torch")


@dataclass
class MetricsSink:
    """Collects records in memory and emits them as JSON lines.

    ``stream_path``: every record is also appended to that file as it is
    emitted, so a run killed without running any ``finally`` still leaves
    its trail; the stream opens in append mode (a resumed run reusing the
    path adds a ``run_start``-delimited segment). A stream write failure
    disables streaming with one warning; :meth:`finalize` then appends
    what was never persisted. ``tracer``: stamps the current span's
    identity on every record. ``registry``: the run's counters and gauges.
    ``max_records``: an in-memory cap for long-lived serving processes
    (one ``access_log`` record per request would otherwise grow without
    bound); past it the oldest records are dropped from ``records``, and
    :meth:`finalize` counts the drops so it neither re-appends nor skips
    a survivor. Emission is thread-safe (the heartbeat and the driver
    share a sink).
    """

    records: list = field(default_factory=list)
    stream_path: str | None = None
    tracer: object | None = None
    registry: Registry = field(default_factory=Registry, repr=False)
    max_records: int | None = None
    _stream: object = field(default=None, repr=False)
    _stream_ok: bool = field(default=True, repr=False)
    _streamed: int = field(default=0, repr=False)
    _dropped: int = field(default=0, repr=False)
    _seconds: dict = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    def emit(self, phase: str, _span=None, **kv) -> dict:
        """Append one record (and stream it). ``_span`` pins the record to
        that span instead of the thread's current one (``span`` records
        carry their own identity)."""
        rec = {"phase": phase, "t": time.time()}
        tr = self.tracer
        if tr is not None:
            sp = _span if _span is not None else tr.current()
            rec["run_id"] = tr.run_id
            rec["trace_id"] = sp.trace_id
            rec["span_id"] = sp.span_id
            rec["span_path"] = sp.path
            if _span is not None and sp.parent_id is not None:
                rec["parent_span_id"] = sp.parent_id
        rec.update(kv)
        line = json.dumps(rec, default=str)
        log.info("%s", line)
        with self._lock:
            self.records.append(rec)
            if self.stream_path is not None and self._stream_ok:
                try:
                    if self._stream is None:
                        self._stream = open(self.stream_path, "a")
                    self._stream.write(line + "\n")
                    self._stream.flush()
                    self._streamed += 1
                except OSError as e:
                    self._stream_ok = False
                    log.warning("metrics stream to %s failed: %r; records will be "
                                "written at exit instead", self.stream_path, e)
            if self.max_records is not None and len(self.records) > self.max_records:
                drop = len(self.records) - self.max_records
                del self.records[:drop]
                self._dropped += drop
        return rec

    @contextlib.contextmanager
    def timed(self, phase: str, **kv):
        """Record ``phase`` with its wall ``seconds``; on failure the record
        says ``ok=false`` with the classified ``error`` and
        ``error_detail``, and the error propagates."""
        t0 = time.perf_counter()
        try:
            yield
        except BaseException as e:
            from graphmine_tpu_torch.pipeline.resilience import classify_error

            self.emit(phase, seconds=round(time.perf_counter() - t0, 4), ok=False,
                      error=classify_error(e), error_detail=repr(e), **kv)
            raise
        seconds = round(time.perf_counter() - t0, 4)
        self._seconds[phase] = seconds
        self.emit(phase, seconds=seconds, **kv)

    @contextlib.contextmanager
    def span(self, name: str, emit: bool = True, annotate: bool = True,
             remote=None, new_trace: bool = False, **attrs):
        """Open a tracer span for the block (a no-op yielding None without
        a tracer). ``emit``: write a ``span`` record when it closes
        (superstep spans pass False: ``lpa_iter`` carries their identity).
        ``annotate``: name a profiler range after the span path while a
        profiler records. ``remote`` / ``new_trace`` pass through to
        :meth:`~graphmine_tpu_torch.obs.spans.Tracer.span`."""
        if self.tracer is None:
            yield None
            return
        sp = None
        try:
            with self.tracer.span(name, remote=remote, new_trace=new_trace, **attrs) as sp:
                if annotate:
                    with profiler_annotation(sp.path):
                        yield sp
                else:
                    yield sp
        finally:
            if emit and sp is not None:
                if sp.parent_id == self.tracer.root.span_id:
                    self._seconds.setdefault(name, round(sp.seconds, 4))
                self.emit("span", _span=sp, name=sp.name, seconds=round(sp.seconds, 4),
                          status=sp.status, **sp.attrs)

    def of_phase(self, phase: str) -> list:
        """All records of one phase name (recovery events included)."""
        return [r for r in self.records if r.get("phase") == phase]

    def phase_seconds(self) -> dict:
        """``{phase: seconds}``: each timed phase's record, and for a phase
        with a top-level span but no timed record (the publish) the
        span's seconds."""
        return dict(self._seconds)

    def finalize(self, path: str) -> str:
        """End-of-run persistence: close the live stream when it wrote
        every record; otherwise append what it never persisted, after
        mending a torn last line. Never truncates: the file may hold
        earlier runs' segments."""
        if self._stream is not None:
            try:
                self._stream.close()
            except OSError:
                self._stream_ok = False
            self._stream = None
            if self._stream_ok and self.stream_path == path:
                return path
        # list index = global record index - dropped records
        start = max(0, self._streamed - self._dropped) if path == self.stream_path else 0
        needs_nl = False
        try:
            with open(path, "rb") as rf:
                rf.seek(-1, os.SEEK_END)
                needs_nl = rf.read(1) != b"\n"
        except (OSError, ValueError):
            pass  # missing or empty file: nothing to mend
        with open(path, "a") as f:
            if needs_nl:
                f.write("\n")
            for rec in self.records[start:]:
                f.write(json.dumps(rec, default=str) + "\n")
        return path

    def tripwire(self, kind: str, shard: int, iteration: int, **kv):
        """The ``tripwire`` record of a divergence tripwire: which guard,
        the offending shard, the superstep it fired at."""
        return self.emit("tripwire", kind=kind, shard=int(shard),
                         iteration=int(iteration), **kv)

    def lpa_iteration(self, it: int, changed: int, num_edges: int, seconds: float,
                      chips: int):
        """Per-superstep record with the headline edges/sec/chip metric."""
        eps = num_edges / seconds if seconds > 0 else float("inf")
        return self.emit("lpa_iter", iteration=it, labels_changed=changed,
                         seconds=round(seconds, 5), edges_per_sec=round(eps),
                         edges_per_sec_per_chip=round(eps / max(chips, 1)))


def shard_sink(obs_dir: str, role: str, run_id: str | None = None,
               max_records: int | None = None) -> MetricsSink:
    """One process's slice of the federated metrics plane: a streaming
    sink with a tracer whose JSONL lands at ``<obs_dir>/<role>-<pid>.jsonl``
    (the JAX package's ``shard_sink``; its ``tools/trace_stitch.py`` joins
    such a directory into per-trace timelines)."""
    from graphmine_tpu_torch.obs.spans import Tracer

    os.makedirs(obs_dir, exist_ok=True)
    safe_role = "".join(c if c.isalnum() or c in "-_" else "-" for c in role) or "proc"
    return MetricsSink(stream_path=os.path.join(obs_dir, f"{safe_role}-{os.getpid()}.jsonl"),
                       tracer=Tracer(run_id=run_id), max_records=max_records)


def _top_device_ops(prof, n: int = 10) -> list:
    """The ``n`` device activities (kernels and copies, not the host ops
    that launched them nor the span ranges) with the most self device
    time: ``[{"name", "self_device_ms", "calls"}]``, empty when no device
    ran."""
    from torch.autograd import DeviceType

    rows = []
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA or getattr(evt, "is_user_annotation", False):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            rows.append({"name": evt.key, "self_device_ms": us / 1e3, "calls": evt.count})
    rows.sort(key=lambda r: r["self_device_ms"], reverse=True)
    return rows[:n]


@contextlib.contextmanager
def maybe_profile(profile_dir: str | None, sink: MetricsSink | None = None):
    """``torch.profiler`` around a pipeline phase, CPU and (when CUDA is
    up) CUDA activities, its Chrome trace written into ``profile_dir``.

    A failing start runs the body unprofiled; a failing stop or export is
    contained, so it never masks the body's own error. Either outcome is a
    ``profile_capture`` record with the trace dir; a good one also names
    the trace file, the ten device activities with the most self device
    time, and the instrumentation's own cost: ``start_seconds`` to start
    the profiler, ``seconds`` to stop it, export and rank.
    """
    if not profile_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    t_start = time.perf_counter()
    try:
        os.makedirs(profile_dir, exist_ok=True)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as e:
        log.warning("profiler start (%s) failed: %r; running unprofiled", profile_dir, e)
        if sink is not None:
            sink.emit("profile_capture", dir=profile_dir, ok=False, error=repr(e))
        yield
        return
    start_seconds = time.perf_counter() - t_start
    try:
        yield
    finally:
        t0 = time.perf_counter()
        try:
            prof.__exit__(None, None, None)
            tracer = getattr(sink, "tracer", None)
            name = f"{tracer.run_id if tracer is not None else os.getpid()}.pt.trace.json"
            trace = os.path.join(profile_dir, name)
            prof.export_chrome_trace(trace)
            top = _top_device_ops(prof)
        except Exception as e:
            log.warning("profiler stop failed: %r (trace dir %s may be incomplete)",
                        e, profile_dir)
            if sink is not None:
                sink.emit("profile_capture", dir=profile_dir, ok=False, error=repr(e))
        else:
            if sink is not None:
                sink.emit("profile_capture", dir=profile_dir, ok=True, trace=trace,
                          activities=[a.name for a in activities], top_device_ops=top,
                          start_seconds=round(start_seconds, 4),
                          seconds=round(time.perf_counter() - t0, 4))
