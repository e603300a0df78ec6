"""Reading a ``torch.profiler`` window: device busy time, the window's
length, device time by operation, and the idle gaps by what the host was
doing.

The harness opens ``bench.window`` around the traced jobs (it ends after
the device has synchronised) and ``bench.job`` around each job. Device
operations are the trace's kernels, copies and fills; the host side is
every operator, runtime call and range the profiler recorded.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # a breakdown entry's name at most (templated kernels run long)
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"
JOB = "bench.job"


@dataclass
class Trace:
    """One traced window: ``window_s`` long, ``ops`` the device operations
    inside it as ``(name, start_us, dur_us)``, ``gaps`` the idle stretches
    as ``(label, dur_us)``."""

    window_s: float
    ops: list = field(default_factory=list)
    gaps: list = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran (their union)."""
        busy, end = 0.0, None
        for _, start, dur in sorted(self.ops, key=lambda o: o[1]):
            stop = start + dur
            if end is None or start >= end:
                busy += dur
                end = stop
            elif stop > end:
                busy += stop - end
                end = stop
        return busy * 1e-6

    def device_seconds(self, pattern: str | None = None) -> float:
        """Summed device seconds of the operations whose name matches
        ``pattern`` (all of them without one)."""
        rx = re.compile(pattern) if pattern else None
        return 1e-6 * sum(d for name, _, d in self.ops if rx is None or rx.search(name))

    def top_ops(self, n: int = 10) -> list:
        """``[[name, seconds], ...]``: the ``n`` operations with the most
        device time."""
        by = defaultdict(float)
        for name, _, d in self.ops:
            by[name[:NAME_CHARS]] += d * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> list:
        """``[[label, seconds], ...]``: idle seconds summed by what the host
        was doing when each gap began, the ``n`` largest."""
        by = defaultdict(float)
        for label, d in self.gaps:
            by[label] += d * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def read_profile(prof) -> Trace | None:
    """The :class:`Trace` of a finished ``torch.profiler.profile``, or
    ``None`` when the window range is missing. The Chrome trace is written
    to a temporary directory (under ``TMPDIR``) and removed."""
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return from_events(events)


def from_events(events: list) -> Trace | None:
    """The :class:`Trace` of Chrome-trace events."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    window = [e for e in spans if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if not window:
        return None
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    ops = []
    for e in spans:
        if e.get("cat") not in DEVICE_CATS:
            continue
        start = max(float(e["ts"]), w0)
        stop = min(float(e["ts"]) + float(e["dur"]), w1)
        if stop > start:
            ops.append((e.get("name", "?"), start, stop - start))
    tid = window[0].get("tid")
    host = sorted((float(e["ts"]), -float(e["dur"]), e.get("name", "?")) for e in spans
                  if e.get("cat") in HOST_CATS and e.get("tid") == tid)
    return Trace(window_s=(w1 - w0) * 1e-6, ops=ops, gaps=_gaps(ops, host, w0, w1))


def _gaps(ops: list, host: list, w0: float, w1: float) -> list:
    """Idle stretches of the device inside ``[w0, w1]`` as ``(label,
    dur_us)``, each labelled ``range/event``: the innermost ``bench.*``
    range and the innermost host event of the window's thread open at the
    stretch's start. ``host`` is ``(start, -dur, name)`` sorted; events
    of one thread nest, so the open ones form a stack."""
    idle, cursor = [], w0
    for _, start, dur in sorted(ops, key=lambda o: o[1]):
        if start > cursor:
            idle.append((cursor, start - cursor))
        cursor = max(cursor, start + dur)
    if w1 > cursor:
        idle.append((cursor, w1 - cursor))
    out, stack, i = [], [], 0
    for at, dur in idle:
        while i < len(host) and host[i][0] <= at:
            start, neg, name = host[i]
            while stack and stack[-1][0] < start:
                stack.pop()
            stack.append((start - neg, name))
            i += 1
        while stack and stack[-1][0] < at:
            stack.pop()
        rng = next((name for _, name in reversed(stack) if name.startswith("bench.")), "outside")
        inner = stack[-1][1] if stack else "idle host"
        out.append((f"{rng}/{inner}", dur))
    return out
