"""Resilient phase execution: error taxonomy, bounded retry, degradation.

Counterpart of ``graphmine_tpu/pipeline/resilience.py`` on one CUDA
device, with the same names, records and decisions:

- an **error taxonomy** (:func:`classify_error`): every exception out of a
  pipeline phase is *retryable* (transient weather: retry the same work),
  *degradable* (resource exhaustion: step down the degradation ladder),
  *degradable_device* (a device left: only an elastic rung helps, and one
  device has none) or *fatal* (bugs, bad input, preemption, and the
  sticky CUDA errors after which the context is poisoned);
- :func:`run_phase`: bounded retry with exponential backoff and seeded
  jitter for retryables, ladder descent for degradables, immediate
  re-raise for fatals, every decision a record through the metrics sink.
  Before a rung runs, the failed attempt's frames are cleared, so the
  tensors it allocated are released and the rung can reuse their memory
  (:func:`release_device_memory` then returns the cached blocks);
- :func:`run_with_watchdog`: a wall-clock bound on one step, with a
  checkpoint-then-abort hook; the worker thread runs on the caller's
  CUDA device and stream;
- :func:`fault_point`: the deterministic fault-injection seam that
  :mod:`graphmine_tpu_torch.testing.faults` drives.
"""

from __future__ import annotations

import contextlib
import gc
import os
import random
import threading
import time
import traceback
from dataclasses import dataclass

import torch

RETRYABLE = "retryable"
DEGRADABLE = "degradable"
# A device (or its link) died: no retry or leaner schedule helps; only an
# elastic rung does, and a one-device run has none.
DEGRADABLE_DEVICE = "degradable_device"
FATAL = "fatal"

# Transient runtime weather. Status tokens are anchored to the start of
# the message ("UNAVAILABLE: socket closed ..."), so a fatal error that
# merely quotes one is not retried; the phrases match anywhere.
_RETRYABLE_STATUS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "UNKNOWN")
_RETRYABLE_PHRASES = ("socket closed", "connection reset", "transport closed")

# Resource exhaustion: the identical program would run out again. The
# caching allocator's message ("CUDA out of memory. Tried to allocate
# ...") and a failed cudaMalloc ("CUDA error: out of memory") match the
# phrase; torch.cuda.OutOfMemoryError is matched by type first.
_DEGRADABLE_STATUS = ("RESOURCE_EXHAUSTED",)
_DEGRADABLE_PHRASES = ("Out of memory", "out of memory")

# Device or link loss, checked before the retryable markers.
_DEVICE_LOSS_STATUS = ("DATA_LOSS",)
_DEVICE_LOSS_PHRASES = (
    "device failure", "ICI link", "interconnect failure",
    "device is lost", "chip halted",
)

# Sticky CUDA errors: after one of these every later call on the context
# fails, so a retry or a leaner rung in this process cannot succeed.
# Checked before every message marker.
_STICKY_CUDA_PHRASES = (
    "an illegal memory access", "device-side assert triggered",
    "unspecified launch failure", "misaligned address",
)

_DIVERGENCE_MARKER = "GRAPHMINE_DIVERGENCE"


def _status_prefixed(msg: str, codes: tuple) -> bool:
    return any(msg == c or msg.startswith(c + ":") for c in codes)


class ResilienceError(RuntimeError):
    """Base for errors raised by the resilience layer itself."""

    graphmine_error_class = FATAL


class RetriesExhausted(ResilienceError):
    """A retryable error outlasted the retry budget. ``__cause__`` holds
    the final underlying error."""


class SuperstepTimeout(ResilienceError):
    """A watchdogged step exceeded its wall-clock bound. When a checkpoint
    hook was given, the last good state was checkpointed before this was
    raised; the message says which case applies."""


class DivergenceError(ResilienceError):
    """An in-loop divergence tripwire fired (labels outside the vertex id
    range). Retryable: the driver rolls the loop state back to the last
    checkpoint before the retry. ``kind`` / ``shard`` / ``iteration``
    carry the forensics."""

    graphmine_error_class = RETRYABLE

    def __init__(self, kind: str, shard: int, iteration: int):
        super().__init__(
            f"{_DIVERGENCE_MARKER}: {kind} detected in shard {shard} at "
            f"superstep {iteration}; the iterate is untrusted — resume "
            "from the last good checkpoint"
        )
        self.kind = kind
        self.shard = int(shard)
        self.iteration = int(iteration)


def classify_error(exc: BaseException) -> str:
    """Map an exception to RETRYABLE / DEGRADABLE / DEGRADABLE_DEVICE /
    FATAL.

    Precedence: an explicit ``graphmine_error_class`` attribute; then
    ``torch.cuda.OutOfMemoryError`` and ``MemoryError`` by type
    (degradable); then the sticky CUDA errors (fatal); then device-loss
    markers; then resource-exhaustion markers; then the divergence marker,
    connection errors and transient markers (retryable); else fatal.
    """
    explicit = getattr(exc, "graphmine_error_class", None)
    if explicit in (RETRYABLE, DEGRADABLE, DEGRADABLE_DEVICE, FATAL):
        return explicit
    if isinstance(exc, (torch.cuda.OutOfMemoryError, MemoryError)):
        return DEGRADABLE
    msg = str(exc)
    if any(m in msg for m in _STICKY_CUDA_PHRASES):
        return FATAL
    if _status_prefixed(msg, _DEVICE_LOSS_STATUS) or any(
        m in msg for m in _DEVICE_LOSS_PHRASES
    ):
        return DEGRADABLE_DEVICE
    if _status_prefixed(msg, _DEGRADABLE_STATUS) or any(
        m in msg for m in _DEGRADABLE_PHRASES
    ):
        return DEGRADABLE
    if _DIVERGENCE_MARKER in msg:
        return RETRYABLE
    if isinstance(exc, ConnectionError):
        return RETRYABLE
    if _status_prefixed(msg, _RETRYABLE_STATUS) or any(
        m in msg for m in _RETRYABLE_PHRASES
    ):
        return RETRYABLE
    return FATAL


@dataclass
class ResilienceConfig:
    """Knobs for :func:`run_phase` / :func:`run_with_watchdog`, the JAX
    package's names and defaults.

    ``max_retries`` bounds additional attempts per incident (0 = one
    attempt). Backoff for attempt ``n`` is ``min(backoff_base_s *
    2**(n-1), backoff_max_s)`` scaled by a seeded jitter in ``[1 - jitter,
    1 + jitter]``. ``superstep_timeout_s`` arms the LPA superstep watchdog
    (None = off); the driver leaves each operating point's first superstep
    unarmed. ``degradation`` is ``"auto"`` (walk the ladders) or ``"off"``
    (surface the error). ``tripwire_every_k`` checks the labels every K
    supersteps (0 = off).
    """

    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_max_s: float = 5.0
    jitter: float = 0.5
    superstep_timeout_s: float | None = None
    degradation: str = "auto"
    tripwire_every_k: int = 0

    def validate(self) -> "ResilienceConfig":
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff seconds must be >= 0")
        if not 0 <= self.jitter <= 1:
            raise ValueError("jitter must be in [0, 1]")
        if self.superstep_timeout_s is not None and self.superstep_timeout_s <= 0:
            raise ValueError("superstep_timeout_s must be positive")
        if self.degradation not in ("auto", "off"):
            raise ValueError(f"unknown degradation policy {self.degradation!r}")
        if self.tripwire_every_k < 0:
            raise ValueError("tripwire_every_k must be >= 0 (0 = off)")
        return self


def _count(metrics, name: str) -> None:
    """Bump a counter on the sink's registry when it has one (bare test
    sinks have none)."""
    reg = getattr(metrics, "registry", None)
    if reg is not None:
        reg.counter(name).inc()


def _rung_span(metrics, label: str):
    """A tracer span around one ladder rung (no record of its own: every
    record inside carries ``rung:<label>`` in its span path)."""
    span = getattr(metrics, "span", None)
    if span is None:
        return contextlib.nullcontext()
    return span(f"rung:{label}", emit=False)


def backoff_s(policy: ResilienceConfig, attempt: int, rng: random.Random) -> float:
    """Jittered exponential delay before retry ``attempt`` (1-based)."""
    base = min(policy.backoff_base_s * (2 ** (attempt - 1)), policy.backoff_max_s)
    return base * (1 + policy.jitter * (2 * rng.random() - 1))


def _drop_frames(exc: BaseException) -> None:
    """Clear the locals of every finished frame in ``exc``'s traceback and
    in the tracebacks it chains to, so the tensors a failed attempt
    allocated die with the attempt instead of riding the exception."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        traceback.clear_frames(exc.__traceback__)
        exc = exc.__cause__ or exc.__context__


def release_device_memory() -> None:
    """Return the caching allocator's free blocks to the device, after a
    collection frees what only reference cycles held: a ladder rung's
    first act once the failed rung's tensors are gone."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _retry_loop(name, thunk, policy, metrics, sleep, rng, progress=None):
    """Retry ``thunk`` on transient errors, ``max_retries`` times per
    incident: when ``progress()`` has advanced since the last failure the
    budget resets."""
    attempt = 0
    last_mark = progress() if progress is not None else None
    while True:
        try:
            return thunk()
        except Exception as e:
            if classify_error(e) != RETRYABLE:
                raise
            if progress is not None:
                mark = progress()
                if mark != last_mark:
                    attempt = 0
                    last_mark = mark
            attempt += 1
            if attempt > policy.max_retries:
                metrics.emit(
                    "retries_exhausted", stage=name,
                    attempts=attempt, error=repr(e),
                )
                raise RetriesExhausted(
                    f"phase {name!r} still failing transiently after "
                    f"{attempt} attempts with no progress: {e!r}"
                ) from e
            delay = backoff_s(policy, attempt, rng)
            _count(metrics, "graphmine_retries_total")
            metrics.emit(
                "retry", stage=name, attempt=attempt,
                backoff_s=round(delay, 4), error=repr(e),
            )
            _drop_frames(e)
            sleep(delay)


def run_phase(
    name: str,
    fn,
    policy: ResilienceConfig,
    metrics,
    ladder: tuple = (),
    sleep=time.sleep,
    progress=None,
    device_ladder: tuple = (),
    degrade_context=None,
):
    """Run ``fn()`` with the retry/degrade/fail taxonomy applied.

    ``ladder``: ordered ``(label, thunk)`` fallbacks for DEGRADABLE
    failures, each retried on transient errors itself; thunks sharing
    mutable state make a rung resume rather than restart.
    ``device_ladder``: the same for DEGRADABLE_DEVICE failures (empty on
    one device, so such an error raises). ``progress``: a zero-arg
    callable; when its value moved since the last failure the retry
    budget resets. ``degrade_context``: a zero-arg callable whose dict
    joins every ``degrade`` record (telemetry only: it never masks the
    failure, and reserved keys are dropped).

    Emits ``retry`` / ``retries_exhausted`` / ``degrade`` records. Raises
    the fatal error, the degradable error when its ladder is exhausted (or
    degradation is off), or :class:`RetriesExhausted`.
    """
    rng = random.Random(f"{name}:{os.getpid()}")
    mem = list(ladder)
    dev = list(device_ladder)
    thunk = fn
    depth = 0
    rung = "primary"

    def _degrade_extra() -> dict:
        if degrade_context is None:
            return {}
        try:
            extra = dict(degrade_context() or {})
        except Exception:  # noqa: BLE001 — context is telemetry only
            return {}
        for reserved in ("phase", "t", "stage", "to", "depth", "kind", "error"):
            extra.pop(reserved, None)
        return extra

    while True:
        try:
            with _rung_span(metrics, rung):
                return _retry_loop(name, thunk, policy, metrics, sleep, rng, progress)
        except Exception as e:
            cls = classify_error(e)
            if policy.degradation != "auto":
                raise
            if cls == DEGRADABLE and mem:
                rung, thunk = mem.pop(0)
                kind = {}
            elif cls == DEGRADABLE_DEVICE and dev:
                rung, thunk = dev.pop(0)
                kind = {"kind": "device"}
            else:
                raise
            depth += 1
            _count(metrics, "graphmine_degrades_total")
            metrics.emit(
                "degrade", stage=name, to=rung, depth=depth, **kind,
                error=repr(e), **_degrade_extra(),
            )
            # the failed attempt's tensors must not outlive it: the next
            # rung needs the memory they hold
            _drop_frames(e)


def _device_scope():
    """A context factory that puts a thread on the calling thread's CUDA
    device and current stream (a null context off CUDA): streams and the
    current device belong to each thread in PyTorch."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return contextlib.nullcontext, None
    stream = torch.cuda.current_stream()
    return (lambda: torch.cuda.stream(stream)), stream


def run_with_watchdog(name, fn, timeout_s, metrics, on_timeout=None):
    """Run ``fn()`` bounded by ``timeout_s`` wall-clock seconds.

    The work runs in a daemon worker thread on the caller's CUDA device
    and stream, which it synchronizes before it reports done. On timeout
    ``on_timeout()`` fires (the driver checkpoints the last good labels
    from a host copy, never through the stream the hung work holds) and
    :class:`SuperstepTimeout` is raised: checkpoint-then-abort, the
    abandoned worker stays parked. ``timeout_s`` of None/0 runs ``fn``
    inline.
    """
    if not timeout_s:
        return fn()
    result: list = []
    err: list = []
    scope, stream = _device_scope()

    def _target():
        try:
            with scope():
                out = fn()
                if stream is not None:
                    stream.synchronize()
            result.append(out)
        except BaseException as e:  # propagate even SystemExit-ish faults
            err.append(e)

    t = threading.Thread(target=_target, daemon=True, name=f"{name}-watchdog")
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        checkpointed = False
        save_err = None
        if on_timeout is not None:
            try:
                on_timeout()
                checkpointed = True
            except Exception as e:
                save_err = e
        _count(metrics, "graphmine_watchdog_timeouts_total")
        metrics.emit(
            "watchdog_timeout", stage=name, timeout_s=timeout_s,
            checkpointed=checkpointed,
        )
        if checkpointed:
            hint = ("last good state was checkpointed — resume after "
                    "resolving the hang")
        elif on_timeout is not None:
            hint = (f"the checkpoint hook FAILED ({save_err!r}); no "
                    "recovery point was saved")
        else:
            hint = ("NO checkpoint hook was configured; the run restarts "
                    "from scratch (set checkpoint_dir to make hangs "
                    "resumable)")
        raise SuperstepTimeout(
            f"phase {name!r} exceeded its {timeout_s}s watchdog; {hint}"
        ) from save_err
    if err:
        raise err[0]
    return result[0]


# ---- fault-injection seam -------------------------------------------------
# Production code calls fault_point(site, ...) at instrumented points; the
# hook is None unless graphmine_tpu_torch.testing.faults installs one.

_fault_hook = None


def set_fault_hook(hook) -> None:
    """Install (or clear, with None) the process-wide fault hook."""
    global _fault_hook
    _fault_hook = hook


def fault_point(site: str, **ctx) -> None:
    """Named instrumentation point: calls the installed hook, if any, with
    the site and its context; the hook may raise."""
    hook = _fault_hook
    if hook is not None:
        hook(site, **ctx)
