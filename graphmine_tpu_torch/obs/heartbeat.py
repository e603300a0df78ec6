"""Periodic liveness records: a hung run must read differently from a
dead one.

Counterpart of ``graphmine_tpu/obs/heartbeat.py``. The :class:`Heartbeat`
daemon thread emits a ``heartbeat`` record every ``every_s`` seconds with
the current span path, the registry's gauge and counter snapshot, process
RSS and uptime: a stream whose heartbeats continue past its last phase
record is hung, one whose heartbeats stop is dead. With a ``prom_path``
each beat also republishes the Prometheus textfile.

The heartbeat thread never calls into CUDA: a call into a wedged context
would hang the thread that exists to report the hang. Device memory comes
from the sample the driver caches from its own thread
(:func:`note_device_memory`), read here with its age.
"""

from __future__ import annotations

import logging
import threading
import time

log = logging.getLogger("graphmine_tpu_torch")

_PAGESIZE = None

# Latest per-device memory sample, cached by the driver from its own
# thread: the heartbeat thread reads this cache and never the device.
_DEV_MEM_LOCK = threading.Lock()
_DEV_MEM: dict | None = None


def note_device_memory(per_device: list) -> None:
    """Cache the driver's latest per-device memory sample
    (``[{device, bytes_in_use, peak_bytes_in_use, bytes_limit}, ...]``,
    from ``torch.cuda.memory_allocated`` and its peak) for heartbeat
    records. Called at the driver's telemetry cadence, never from the
    heartbeat thread."""
    global _DEV_MEM
    with _DEV_MEM_LOCK:
        _DEV_MEM = {"t": time.time(), "per_device": list(per_device)}


def device_memory() -> dict | None:
    """The cached sample with its staleness (``age_s``), or None when the
    driver has cached none this process."""
    with _DEV_MEM_LOCK:
        if _DEV_MEM is None:
            return None
        return {
            "age_s": round(time.time() - _DEV_MEM["t"], 1),
            "per_device": list(_DEV_MEM["per_device"]),
        }


def rss_mb() -> float | None:
    """Resident set size in MiB via ``/proc/self/statm`` (Linux), None
    where unavailable — a missing gauge, not a crash, off-Linux."""
    global _PAGESIZE
    try:
        if _PAGESIZE is None:
            import resource  # noqa: F401  (cheap; also warms errno paths)
            import os

            _PAGESIZE = os.sysconf("SC_PAGESIZE")
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return round(pages * _PAGESIZE / (1024 * 1024), 1)
    except (OSError, ValueError, IndexError):
        return None


class Heartbeat:
    """Emit liveness records on a daemon thread until :meth:`stop`.

    ``sink``: a :class:`~graphmine_tpu_torch.pipeline.metrics.MetricsSink`
    (its ``tracer``/``registry``, when present, supply the phase path
    and the gauge snapshot).
    """

    def __init__(self, sink, every_s: float = 10.0, prom_path: str | None = None):
        if every_s <= 0:
            raise ValueError("every_s must be positive")
        self.sink = sink
        self.every_s = float(every_s)
        self.prom_path = prom_path
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = time.perf_counter()
        self.beats = 0

    def beat(self) -> dict:
        """Emit one heartbeat record now (the thread's body; callable
        directly from tests and from the driver at phase boundaries)."""
        kv = {"uptime_s": round(time.perf_counter() - self._t0, 2)}
        tracer = getattr(self.sink, "tracer", None)
        if tracer is not None:
            kv["busy"] = tracer.latest().path
        registry = getattr(self.sink, "registry", None)
        if registry is not None:
            kv["gauges"] = registry.values()
        rss = rss_mb()
        if rss is not None:
            kv["rss_mb"] = rss
        dm = device_memory()
        if dm is not None:
            # per-device bytes_in_use context for the hung verdict, from
            # the driver-maintained cache (see note_device_memory)
            kv["device_memory"] = dm
        self.beats += 1
        rec = self.sink.emit("heartbeat", **kv)
        if self.prom_path and registry is not None:
            try:
                labels = {"run_id": tracer.run_id} if tracer else None
                registry.write_textfile(self.prom_path, labels=labels)
            except OSError:
                pass  # a full disk must not kill the liveness signal
        return rec

    def _loop(self) -> None:
        warned = False
        while not self._stop.wait(self.every_s):
            # One failing beat (a transient
            # sink error) must not kill the liveness loop: dead-silent
            # heartbeats on a live process are exactly the misdiagnosis
            # ("DEAD") this thread exists to prevent.
            try:
                self.beat()
            except Exception as e:
                if not warned:
                    warned = True
                    log.warning("heartbeat beat failed (will keep "
                                "trying): %r", e)

    def start(self) -> "Heartbeat":
        if self._thread is not None:
            raise RuntimeError("heartbeat already started")
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="graphmine-heartbeat"
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent; joins the thread briefly so a final in-flight beat
        cannot interleave with stream finalization."""
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=max(2.0, self.every_s))
