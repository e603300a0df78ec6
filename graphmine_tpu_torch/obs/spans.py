"""Hierarchical span context: run_id -> phase -> rung -> superstep.

Counterpart of ``graphmine_tpu/obs/spans.py``. A :class:`Tracer` owns one
run's identity (``run_id`` + ``trace_id``) and a thread-local stack of open
:class:`Span`\\ s; the :class:`~graphmine_tpu_torch.pipeline.metrics.MetricsSink`
stamps every record with the current span's ids and slash-joined path, so
retry / degrade / tripwire / checkpoint records join into one causal
timeline. Durations are monotonic (``time.perf_counter``); ``start_t`` is
wall clock, for aligning spans with record ``t`` values.

A :class:`TraceContext` is the wire form of one span's identity:
``to_header()`` renders a ``traceparent``-style header and
:meth:`TraceContext.from_header` parses it, so a span opened with
``remote=ctx`` in another process joins the sender's trace.

:func:`profiler_annotation` names a ``torch.profiler.record_function``
range after the span path, but only while a profiler is recording, so a
run without one pays nothing.
"""

from __future__ import annotations

import contextlib
import re
import secrets
import threading
import time
from dataclasses import dataclass, field

import torch


def new_run_id() -> str:
    """Sortable-by-start, collision-safe run identity:
    ``YYYYMMDDTHHMMSS-<6 hex>`` (UTC)."""
    return time.strftime("%Y%m%dT%H%M%S", time.gmtime()) + "-" + secrets.token_hex(3)


def _new_id(nbytes: int = 4) -> str:
    return secrets.token_hex(nbytes)


# The header every fleet hop carries (router -> replica, router ->
# writer, probe). traceparent-STYLE: version-trace_id-span_id-flags,
# with this repo's id widths (16-hex trace, 8-hex span) instead of
# W3C's fixed 32/16 — zero-padding to W3C widths and stripping it back
# is a round-trip hazard a single-format fleet doesn't need.
TRACE_HEADER = "traceparent"

# Parsed ids are echoed into response headers and stamped into records:
# constrain them so a hostile header can't smuggle newlines/quotes
# (the serve/server.py request-id discipline).
_HEX_ID_RE = re.compile(r"[0-9a-f]{8,64}")


@dataclass(frozen=True)
class TraceContext:
    """One span's identity on the wire: what a process needs to open a
    child span of a span living in ANOTHER process."""

    trace_id: str
    span_id: str
    sampled: bool = True

    def to_header(self) -> str:
        """``00-<trace_id>-<span_id>-<01|00>``."""
        return (
            f"00-{self.trace_id}-{self.span_id}-"
            f"{'01' if self.sampled else '00'}"
        )

    @classmethod
    def from_header(cls, value) -> "TraceContext | None":
        """Parse a propagated header; ``None`` on anything malformed —
        an unparseable traceparent must degrade to a fresh local trace,
        never crash a request handler."""
        if not isinstance(value, str) or not value:
            return None
        parts = value.strip().lower().split("-")
        if len(parts) != 4:
            return None
        version, trace_id, span_id, flags = parts
        if not re.fullmatch(r"[0-9a-f]{2}", version):
            return None
        if not _HEX_ID_RE.fullmatch(trace_id):
            return None
        if not _HEX_ID_RE.fullmatch(span_id):
            return None
        if len(flags) != 2:
            return None
        return cls(trace_id, span_id, sampled=flags[-1] == "1")


@dataclass
class Span:
    """One timed node of the span tree. ``path`` is the slash-joined name
    chain from the root (``run/lpa/rung:ring@4/superstep``) — records
    carry it verbatim so offline triage needs no id-graph walk."""

    name: str
    trace_id: str
    span_id: str
    parent_id: str | None
    path: str
    start_t: float                      # wall clock, for report alignment
    start_mono: float                   # perf_counter, for durations
    end_mono: float | None = None
    attrs: dict = field(default_factory=dict)
    status: str = "ok"

    @property
    def seconds(self) -> float:
        """Monotonic duration; an open span reports its age so far."""
        end = self.end_mono if self.end_mono is not None else time.perf_counter()
        return end - self.start_mono

    def context(self) -> TraceContext:
        """This span's wire identity — what :meth:`to_header` of the
        result propagates to the next process."""
        return TraceContext(self.trace_id, self.span_id)


class Tracer:
    """One run's span tree. The root span ("run") opens at construction
    and closes via :meth:`close`; :meth:`span` nests under the current
    thread's innermost open span.

    Thread model: each thread has its own open-span stack; a thread with
    no open span (the heartbeat thread, a watchdog worker) falls back to
    the **root** span, so records emitted there still carry the run and
    trace ids. :meth:`latest` returns the most recently entered open span
    across all threads — what the heartbeat reports as the current phase
    without the emitting thread needing any span of its own.
    """

    def __init__(self, run_id: str | None = None):
        self.run_id = run_id or new_run_id()
        self.trace_id = _new_id(8)
        self._local = threading.local()
        self._lock = threading.Lock()
        now = time.time()
        self.root = Span(
            name="run", trace_id=self.trace_id, span_id=_new_id(),
            parent_id=None, path="run", start_t=now,
            start_mono=time.perf_counter(),
        )
        self._latest: Span = self.root

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Span:
        """This thread's innermost open span (the root when none)."""
        stack = self._stack()
        return stack[-1] if stack else self.root

    def latest(self) -> Span:
        """Most recently entered open span across all threads."""
        with self._lock:
            return self._latest

    @contextlib.contextmanager
    def span(
        self, name: str, remote: TraceContext | None = None,
        new_trace: bool = False, **attrs,
    ):
        """Open a child span of the current one for the ``with`` block.
        An escaping exception marks ``status="error"`` (and propagates);
        the span always closes with a monotonic end time.

        Cross-process identity:

        - ``remote=ctx`` parents the span under a span living in
          ANOTHER process — it adopts ``ctx.trace_id`` and sets
          ``parent_id`` to the remote span's id, so every record emitted
          inside lands in the propagating process's trace. The path
          restarts at ``name`` (the local path chain belongs to the
          local tree, not the remote one).
        - ``new_trace=True`` mints a fresh ``trace_id`` for the span's
          subtree — the fleet router's root-span-per-request, so each
          request is its OWN trace instead of one run-wide trace.

        Nested spans inherit their parent's ``trace_id`` (not the
        tracer's), so a whole subtree opened under a remote/new-trace
        span stays in that trace.
        """
        if remote is not None and new_trace:
            raise ValueError("span(): remote= and new_trace= are exclusive")
        parent = self.current()
        if remote is not None:
            trace_id, parent_id, path = remote.trace_id, remote.span_id, name
        elif new_trace:
            trace_id, parent_id, path = _new_id(8), None, name
        else:
            trace_id = parent.trace_id
            parent_id = parent.span_id
            path = f"{parent.path}/{name}"
        sp = Span(
            name=name, trace_id=trace_id, span_id=_new_id(),
            parent_id=parent_id, path=path,
            start_t=time.time(), start_mono=time.perf_counter(),
            attrs=dict(attrs),
        )
        stack = self._stack()
        stack.append(sp)
        with self._lock:
            self._latest = sp
        try:
            yield sp
        except BaseException:
            sp.status = "error"
            raise
        finally:
            sp.end_mono = time.perf_counter()
            if stack and stack[-1] is sp:
                stack.pop()
            else:  # defensive: never let a mismatched exit corrupt the stack
                try:
                    stack.remove(sp)
                except ValueError:
                    pass
            with self._lock:
                if self._latest is sp:
                    self._latest = self.current()

    def close(self) -> Span:
        """End the root span (idempotent); returns it for the run record."""
        if self.root.end_mono is None:
            self.root.end_mono = time.perf_counter()
        return self.root


def profiler_annotation(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` (the span
    path) while a profiler is recording, so profiler traces line up with
    the span tree; a null context otherwise."""
    if not torch._C._autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)
