"""Deterministic fault injection: every recovery path exercised on the CPU.

Counterpart of the pipeline part of ``graphmine_tpu/testing/faults.py``.
A :class:`FaultInjector` installs into the
:func:`graphmine_tpu_torch.pipeline.resilience.fault_point` seam and raises
a planned error the Nth time a named site is hit::

    inj = FaultInjector()
    inj.add("lpa_superstep", transient_error, at=2)      # 2nd superstep
    inj.add("lpa_superstep", oom_error, at=4, repeat=2)  # 4th AND 5th hit
    with inj.installed():
        run_pipeline(cfg)
    assert inj.fired("lpa_superstep") == 1

Sites in the driver: ``load``, ``build_graph``, ``lpa_superstep`` (ctx:
``iteration``, ``variant``, ``state``), ``census``, ``outliers_recursive``,
``outliers_lof``, ``snapshot_publish``.

The factories return the errors the production classifier sees on the
card: :func:`oom_error` is a ``torch.cuda.OutOfMemoryError`` carrying the
caching allocator's message, :func:`device_oom` provokes a real one from
the allocator, so :func:`~graphmine_tpu_torch.pipeline.resilience.classify_error`
is the code under test. :func:`poison_labels` corrupts the driver's label
state without raising (the tripwires must catch it); :func:`hang` sleeps
(the watchdog must bound it); :func:`corrupt_file` and
:func:`truncate_file` damage checkpoints in place.
"""

from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass, field

import torch

from graphmine_tpu_torch.pipeline import resilience


class InjectedTransientError(Exception):
    """Looks like transient device/RPC weather; classified retryable."""


class SimulatedPreemption(Exception):
    """A preempted worker: the process dies mid-run. Fatal by contract:
    recovery is a new run resuming from the checkpoint."""

    graphmine_error_class = resilience.FATAL


def transient_error() -> Exception:
    return InjectedTransientError(
        "UNAVAILABLE: socket closed; failed to connect to remote runtime "
        "(injected fault)"
    )


def oom_error() -> Exception:
    """The caching allocator's out-of-memory error, as it reads on the
    card."""
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 8.79 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB of which 1.02 GiB is free. Of the allocated "
        "memory 76.50 GiB is allocated by PyTorch (injected fault)"
    )


def device_oom(device) -> Exception:
    """A real ``torch.cuda.OutOfMemoryError`` from the caching allocator
    of CUDA ``device`` (a 256 TiB request), caught and returned so the
    injector raises it; on any other device, :func:`oom_error`."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return oom_error()
    try:
        torch.empty(1 << 48, dtype=torch.uint8, device=dev)
    except torch.cuda.OutOfMemoryError as e:
        return e
    raise RuntimeError("a 256 TiB allocation succeeded")


def preemption() -> Exception:
    return SimulatedPreemption("worker preempted (injected fault)")


def poison_labels(shard: int, num_shards: int, value: int = -7):
    """A ctx-aware mutator: overwrites shard ``shard`` of a
    ``num_shards`` split of the driver's label tensor with ``value`` (an
    id outside the vertex range) on its device, and raises nothing.
    Install at ``lpa_superstep``, whose ctx carries the driver's state."""

    def _mutate(**ctx):
        state = ctx.get("state")
        if state is None or "labels" not in state:
            raise ValueError(
                "poison_labels needs a fault site whose ctx carries the "
                "driver's mutable state (lpa_superstep)"
            )
        labels = torch.as_tensor(state["labels"]).clone()
        chunk = -(-labels.shape[0] // num_shards)
        labels[shard * chunk: (shard + 1) * chunk] = value
        state["labels"] = labels
        return None

    _mutate.wants_ctx = True
    return _mutate


# Parked hang() sleepers, each on its own event, released when the
# injector is uninstalled.
_sleepers_lock = threading.Lock()
_sleepers: list = []


def _release_abandoned_sleepers() -> None:
    with _sleepers_lock:
        for ev in _sleepers:
            ev.set()
        _sleepers.clear()


def hang(seconds: float):
    """A 'factory' that sleeps instead of raising: a hung step for the
    watchdog. The sleep ends early when the injector is uninstalled."""

    def _sleep():
        ev = threading.Event()
        with _sleepers_lock:
            _sleepers.append(ev)
        ev.wait(seconds)
        with _sleepers_lock:
            if ev in _sleepers:
                _sleepers.remove(ev)
        return None

    _sleep.is_hang = True
    return _sleep


@dataclass
class _Rule:
    site: str
    factory: object          # () -> Exception, a hang() sleeper or a mutator
    at: int                  # 1-based hit index at which to fire
    repeat: int = 1          # fire on this many consecutive hits
    fired: int = 0


@dataclass
class FaultInjector:
    """Deterministic site/hit-count fault plan (see the module note)."""

    rules: list = field(default_factory=list)
    hits: dict = field(default_factory=dict)
    log: list = field(default_factory=list)  # (site, hit, ctx) of every hit

    def add(self, site: str, factory, at: int = 1, repeat: int = 1) -> "FaultInjector":
        if at < 1 or repeat < 1:
            raise ValueError("at and repeat are 1-based positive counts")
        self.rules.append(_Rule(site=site, factory=factory, at=at, repeat=repeat))
        return self

    def fired(self, site: str | None = None) -> int:
        return sum(r.fired for r in self.rules if site is None or r.site == site)

    def __call__(self, site: str, **ctx) -> None:
        n = self.hits[site] = self.hits.get(site, 0) + 1
        self.log.append((site, n, ctx))
        for r in self.rules:
            if r.site == site and r.at <= n < r.at + r.repeat:
                r.fired += 1
                out = r.factory(**ctx) if getattr(r.factory, "wants_ctx", False) else r.factory()
                if out is not None:  # hang() and mutators return None
                    raise out

    @contextlib.contextmanager
    def installed(self):
        """Install into the resilience seam for the block (one injector
        at a time per process)."""
        resilience.set_fault_hook(self)
        try:
            yield self
        finally:
            resilience.set_fault_hook(None)
            _release_abandoned_sleepers()


def corrupt_file(path: str, offset: int = -64, nbytes: int = 16) -> None:
    """Flip ``nbytes`` bytes in place at ``offset`` (negative = from EOF):
    by default inside the last zip member of a small ``.npz``."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path!r} is empty; nothing to corrupt")
    pos = offset % size
    nbytes = min(nbytes, size - pos)
    with open(path, "r+b") as f:
        f.seek(pos)
        chunk = f.read(nbytes)
        f.seek(pos)
        f.write(bytes(b ^ 0xFF for b in chunk))


def truncate_file(path: str, keep_fraction: float = 0.5) -> None:
    """Truncate a file to ``keep_fraction`` of its bytes (a torn write)."""
    if not 0 <= keep_fraction < 1:
        raise ValueError("keep_fraction must be in [0, 1)")
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(int(size * keep_fraction))
