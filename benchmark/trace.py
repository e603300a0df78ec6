"""Reading a ``torch.profiler`` window: device busy time, the window's
length, device time by operation, and the idle gaps by what the host was
doing, each card apart.

The harness opens ``bench.window`` around the traced jobs (it ends after
every card of the cell has synchronised) and ``bench.job`` around each
job. Device operations are the trace's kernels, copies and fills, each
on the card its event names; the host side is every operator, runtime
call and range the profiler recorded. A cell on one card reads as it
always did; on more, busy time is the mean over the cards, and each
breakdown name begins with its card (``cuda:2 ...``).
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
    inside it as ``(name, start_us, dur_us, card)``, ``gaps`` each card's
    idle stretches as ``(label, dur_us)``, ``cards`` the card indices the
    window covers (the cell's, and any other a device operation ran on; a
    card that ran nothing was idle all through)."""

    window_s: float
    ops: list = field(default_factory=list)
    gaps: list = field(default_factory=list)
    cards: tuple = (0,)

    def busy_s_by_card(self) -> dict:
        """``{card: seconds}`` in which some device operation ran on that
        card (the union of its operations)."""
        by = {}
        for card in self.cards:
            busy, end = 0.0, None
            for _, start, dur, _c in sorted((o for o in self.ops if o[3] == card),
                                            key=lambda o: o[1]):
                stop = start + dur
                if end is None or start >= end:
                    busy += dur
                    end = stop
                elif stop > end:
                    busy += stop - end
                    end = stop
            by[card] = busy * 1e-6
        return by

    @property
    def busy_s(self) -> float:
        """The mean over the cards of each card's busy seconds."""
        by = self.busy_s_by_card()
        return sum(by.values()) / len(by)

    def device_seconds(self, pattern: str | None = None, card: int | None = None) -> float:
        """Summed device seconds of the operations whose name matches
        ``pattern`` (all of them without one) on ``card``, or without a
        card the mean of those sums over the cards."""
        rx = re.compile(pattern) if pattern else None

        def on(c):
            return 1e-6 * sum(d for name, _, d, k in self.ops
                              if k == c and (rx is None or rx.search(name)))

        if card is not None:
            return on(card)
        return sum(on(c) for c in self.cards) / len(self.cards)

    def _label(self, card: int, name: str) -> str:
        return f"cuda:{card} {name}" if len(self.cards) > 1 else name

    def top_ops(self, n: int = 10) -> list:
        """``[[name, seconds], ...]``: the ``n`` operations with the most
        device time, by card where there are several."""
        by = defaultdict(float)
        for name, _, d, card in self.ops:
            by[self._label(card, name[:NAME_CHARS])] += d * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def top_gaps(self, n: int = 10) -> list:
        """``[[label, seconds], ...]``: idle seconds summed by what the host
        was doing when each gap began (and by card where there are
        several), the ``n`` largest."""
        by = defaultdict(float)
        for label, d in self.gaps:
            by[label] += d * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def read_profile(prof, cards=None) -> Trace | None:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` over
    the card indices ``cards``, or ``None`` when the window range is
    missing. The Chrome trace is written to a temporary directory (under
    ``TMPDIR``) and removed."""
    tmp = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return from_events(events, cards)


def event_card(event: dict) -> int:
    """The card a device event ran on: its ``args.device``, else its
    ``pid`` (the profiler gives a device's events the device's index as
    their process)."""
    args = event.get("args") or {}
    return int(args["device"] if "device" in args else event["pid"])


def from_events(events: list, cards=None) -> Trace | None:
    """The :class:`Trace` of Chrome-trace events over the card indices
    ``cards`` (those the device events name, without them)."""
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
            ops.append((e.get("name", "?"), start, stop - start, event_card(e)))
    tid = window[0].get("tid")
    host = sorted((float(e["ts"]), -float(e["dur"]), e.get("name", "?")) for e in spans
                  if e.get("cat") in HOST_CATS and e.get("tid") == tid)
    tr = Trace(window_s=(w1 - w0) * 1e-6, ops=ops,
               cards=tuple(sorted(set(cards or ()) | {o[3] for o in ops})) or (0,))
    for card in tr.cards:
        tr.gaps += [(tr._label(card, label), dur) for label, dur in
                    _gaps([o for o in ops if o[3] == card], host, w0, w1)]
    return tr


def _gaps(ops: list, host: list, w0: float, w1: float) -> list:
    """Idle stretches of one card inside ``[w0, w1]`` as ``(label,
    dur_us)``, each labelled ``range/event``: the innermost ``bench.*``
    range and the innermost host event of the window's thread open at the
    stretch's start. ``host`` is ``(start, -dur, name)`` sorted; events
    of one thread nest, so the open ones form a stack."""
    idle, cursor = [], w0
    for _, start, dur, _card in sorted(ops, key=lambda o: o[1]):
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
